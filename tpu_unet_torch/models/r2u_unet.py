"""R2U-Net: the U-Net with every DoubleConv replaced by a recurrent residual
block (Alom et al., arXiv:1802.06955; ``tpu_unet/models/r2u_unet.py``):

    x   = conv1x1(x_in)          # the channel-setting projection, with bias
    h   = RecUnit(RecUnit(x))    # two stacked recurrent units
    out = x + h

A recurrent unit applies one weight-shared (3x3 conv -> BN -> ReLU) t+1
times with input injection: h = unit(x), then t times h = unit(x + h).

The BN statistics follow the state's layout. ``{"bn": BNState}`` is the
shared form: one running mean/var threaded through the t+1 applications in
order, as one ``nn.BatchNorm2d`` called t+1 times. ``{"bn0": .., "bnT": ..}``
(``recur_bn="per_step"``, the default) gives application i its own running
statistics (Cooijmans et al., arXiv:1603.09025), with the weights, γ and β
shared either way.

Under a ``torch.profiler`` session (``tracing.py``) each block records a
``model.rrcnn`` span (projection, both units and the residual add) and each
unit adds its t+1 applications to the counter
``model.recurrent_applications``; off, both are a flag read.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_unet_torch import tracing
from tpu_unet_torch.models.unet import (
    ENCODER,
    Params,
    State,
    UNetConfig,
    _conv_init,
    _convt_init,
    _up_apply,
    decoder_plan,
    encoder_decoder,
    encoder_plan,
)
from tpu_unet_torch.ops import batch_norm, conv2d
from tpu_unet_torch.ops.batchnorm import init_bn_params, init_bn_state
from tpu_unet_torch.parallel.collectives import (
    copy_to_model,
    gather_from_model,
    model_axis_of,
    reduce_from_model,
    take_shard,
)


def recur_steps(config: UNetConfig) -> int | None:
    """t+1 per-application BN statistics for ``recur_bn="per_step"``; None
    for the shared layout."""
    if config.recur_bn not in ("per_step", "shared"):
        raise ValueError(f"recur_bn must be 'per_step' or 'shared', got {config.recur_bn!r}")
    return config.recur_t + 1 if config.recur_bn == "per_step" else None


def _rec_unit_init(rng, ch: int, *, device, steps: int | None = None):
    """One shared (3x3 conv -> BN -> ReLU) unit; ``steps`` BN states
    ``bn0..`` or, with None, one ``bn``."""
    params = {"conv": _conv_init(rng, 3, 3, ch, ch, bias=False, device=device),
              "bn": init_bn_params(ch, device)}
    if steps is None:
        return params, {"bn": init_bn_state(ch, device)}
    return params, {f"bn{i}": init_bn_state(ch, device) for i in range(steps)}


def _rec_unit_apply(params, state, x, *, t: int, train: bool, group=None, axis=None,
                    layer=None):
    """h = unit(x); then t times h = unit(x + h), the weights shared; BN
    statistics by the state's layout (module docstring). Under a model
    ``axis`` (``parallel/tensor.py``), ``layer`` "column" (rec1: x
    replicated, the conv on its Cout shard, h this rank's channels) gathers
    h before each re-application; "row" (rec2: x this rank's channels, the
    conv on its Cin shard) reduces each application's partial sums and adds
    h's slice of this rank's channels."""
    def unit(v, bn_state):
        h = conv2d(v, params["conv"]["w"], stride=1, padding=1, group=group)
        if layer == "row":
            h = reduce_from_model(h, axis)
        h, bn_state = batch_norm(h.to(v.dtype), params["bn"], bn_state, train=train,
                                 group=group)
        return torch.relu(h), bn_state

    tracing.count("model.recurrent_applications", t + 1)
    if layer == "column":
        x = copy_to_model(x, axis)

    def again(h):  # the input x + h of a re-application
        if layer == "column":
            return x + gather_from_model(h, axis)
        if layer == "row":
            return x + take_shard(h, axis)
        return x + h

    if "bn" in state:  # shared: one state stepped t+1 times
        h, bn = unit(x, state["bn"])
        for _ in range(t):
            h, bn = unit(again(h), bn)
        return h, {"bn": bn}
    h, bn0 = unit(x, state["bn0"])
    new_state = {"bn0": bn0}
    for i in range(1, t + 1):
        h, new_state[f"bn{i}"] = unit(again(h), state[f"bn{i}"])
    return h, new_state


def _rrcnn_init(rng, cin: int, cout: int, *, device, steps: int | None = None):
    params = {"proj": _conv_init(rng, 1, 1, cin, cout, bias=True, device=device)}
    state: State = {}
    params["rec1"], state["rec1"] = _rec_unit_init(rng, cout, device=device, steps=steps)
    params["rec2"], state["rec2"] = _rec_unit_init(rng, cout, device=device, steps=steps)
    return params, state


def _rrcnn_apply(params, state, x, *, t: int, train: bool, group=None):
    """The recurrent residual block: x = proj(x); x + rec2(rec1(x)). Under
    a spatial ``Band`` each recurrent application exchanges its halo rows;
    a block sharded over a model axis runs rec1 as its column layer and rec2
    as its row layer (``_rec_unit_apply``)."""
    axis = model_axis_of(params, group)
    with tracing.span("model.rrcnn"):
        x = conv2d(x, params["proj"]["w"], stride=1, padding=0, group=group)
        x = (x.float() + params["proj"]["b"].float()).to(x.dtype)
        h, s1 = _rec_unit_apply(params["rec1"], state["rec1"], x, t=t, train=train,
                                group=group, axis=axis,
                                layer=None if axis is None else "column")
        h, s2 = _rec_unit_apply(params["rec2"], state["rec2"], h, t=t, train=train,
                                group=group, axis=axis, layer=None if axis is None else "row")
        return x + h, {"rec1": s1, "rec2": s2}


def init_r2u_unet(config: UNetConfig, rng: np.random.Generator, device="cpu", *,
                  gate_init=None) -> tuple[Params, State]:
    """The U-Net's channel plan with an RRCNN block for every DoubleConv,
    ``config.recur_bn`` picking the BN layout; with ``gate_init(rng, g_ch,
    skip_ch, device=)``, one gate per skip (R2AttU-Net)."""
    steps = recur_steps(config)
    params: Params = {}
    state: State = {}
    for name, (cin, cout) in zip(ENCODER, encoder_plan(config)):
        params[name], state[name] = _rrcnn_init(rng, cin, cout, device=device, steps=steps)
    for i, (skip, cin, cout) in enumerate(decoder_plan(config), start=1):
        g_ch = cin if config.bilinear else cin // 2  # the ConvTranspose halves the channels
        p: Params = {} if config.bilinear else {"up": _convt_init(rng, cin, g_ch, device=device)}
        s: State = {}
        p["conv"], s["conv"] = _rrcnn_init(rng, skip + g_ch, cout, device=device, steps=steps)
        if gate_init is not None:
            p["att"], s["att"] = gate_init(rng, g_ch, skip, device=device)
        params[f"up{i}"], state[f"up{i}"] = p, s
    params["outc"] = _conv_init(rng, 1, 1, config.base_channels, config.n_classes, bias=True,
                                device=device)
    return params, state


def r2u_unet_apply(params: Params, state: State, x: torch.Tensor, *, config: UNetConfig,
                   train: bool = False, remat: bool = False, group=None
                   ) -> tuple[torch.Tensor, State]:
    """Forward on params already in the compute dtype (``unet_apply`` casts
    them): [N,H,W,C] -> (fp32 logits, new BN state); ``group``: BN over
    every rank (``unet_apply``)."""
    rr = functools.partial(_rrcnn_apply, t=config.recur_t, train=train)
    up = functools.partial(_up_apply, bilinear=config.bilinear, block=rr)
    return encoder_decoder(params, state, x, block=rr, up=up, remat=remat, group=group)
