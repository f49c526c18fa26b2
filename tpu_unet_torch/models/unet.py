"""The flagship U-Net: configuration, parameter layout and forward
(``tpu_unet/models/unet.py``), and the dispatch of ``init_unet`` and
``unet_apply`` to the other families by ``config.arch``.

Parameters are the JAX package's nested dicts, with tensors in its layouts
(HWIO conv weights), and BN running statistics are explicit ``BNState``
state, so a JAX checkpoint maps onto them key for key
(``tpu_unet_torch/checkpoint.py``). ``unet_apply`` is the train- and
eval-mode forward; serving runs the folded forward in ``models/infer.py``.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.utils.checkpoint

from tpu_unet_torch.ops import (
    batch_norm,
    conv2d,
    conv_transpose2d,
    max_pool2d,
    pad_to_match,
    upsample2x_align_corners,
)
from tpu_unet_torch.ops.batchnorm import init_bn_params, init_bn_state
from tpu_unet_torch.ops.conv_stats import double_conv_train_fused
from tpu_unet_torch.parallel.collectives import (
    copy_to_model,
    mark_shards,
    model_axis_of,
    reduce_from_model,
)
from tpu_unet_torch.parallel.halo import Band, coarser, levels

Params = dict[str, Any]
State = dict[str, Any]

ARCHS = ("unet", "unetpp", "attention", "r2u", "r2attu")


class Refused(ValueError):
    """A route that the JAX package refuses too (a family on the hand-written
    kernels, ``fold_bn`` of a family whose BN does not fold, a family's
    ``.pth``). Raised by the one function that owns each refusal; the CLIs
    exit with its message (``predict.exit_on_refusal``)."""


def check_kernels(config: UNetConfig, kernels: str | None) -> None:
    """Raise unless ``kernels`` is a train route of ``config.arch``: None
    (library convs), or ``"cuda"`` (the hand-written train kernels) for the
    U-Net alone, as the JAX package refuses ``kernels="pallas"`` for the
    families: the kernels are wired for the U-Net's DoubleConv, and a silent
    run on library convs would mislead a measurement."""
    if kernels not in (None, "cuda"):
        raise ValueError(f"kernels must be None or 'cuda', got {kernels!r}")
    if kernels and config.arch != "unet":
        raise Refused(f"kernels={kernels!r} is not implemented for arch={config.arch!r} "
                      "(the JAX package refuses kernels='pallas' for it too); use the "
                      "default library-conv route (kernels=None, --kernels torch)")


class UNetConfig(NamedTuple):
    """The JAX package's ``UNetConfig``, field for field, so a checkpoint's
    stored config (``extra["config"]``) loads here unchanged.

    ``arch`` picks the family: ``"unet"`` (this module), ``"unetpp"``
    (``models/unetpp.py``; ``deep_supervision`` averages its per-column
    heads), ``"attention"`` (``models/attention_unet.py``), ``"r2u"``
    (``models/r2u_unet.py``) and ``"r2attu"`` (``models/r2attu_unet.py``).
    ``recur_t`` is the recurrence depth of r2u/r2attu, and ``recur_bn``
    their BN statistics across the t+1 weight-shared applications:
    ``"per_step"`` (one running mean/var per application, γ/β shared; the
    default) or ``"shared"`` (one BN stepped t+1 times). ``s2d_level0`` is
    a TPU experiment, carried and refused."""

    n_channels: int = 3
    n_classes: int = 2
    bilinear: bool = False
    base_channels: int = 64
    arch: str = "unet"
    deep_supervision: bool = False
    recur_t: int = 2
    recur_bn: str = "per_step"
    s2d_level0: bool = False


def _uniform(rng: np.random.Generator, shape, bound: float, device) -> torch.Tensor:
    if torch.device(device).type == "meta":  # shapes only: no draws
        return torch.empty(shape, device="meta")
    w = rng.uniform(-bound, bound, size=shape).astype(np.float32)
    return torch.from_numpy(w).to(device)


def _conv_init(rng, kh, kw, cin, cout, *, bias: bool, device) -> Params:
    """torch's default Conv2d init bounds: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / (cin * kh * kw) ** 0.5
    p: Params = {"w": _uniform(rng, (kh, kw, cin, cout), bound, device)}
    if bias:
        p["b"] = _uniform(rng, (cout,), bound, device)
    return p


def _double_conv_init(rng, cin, cout, cmid=None, *, device):
    cmid = cout if cmid is None else cmid
    params = {
        "conv1": _conv_init(rng, 3, 3, cin, cmid, bias=False, device=device),
        "bn1": init_bn_params(cmid, device),
        "conv2": _conv_init(rng, 3, 3, cmid, cout, bias=False, device=device),
        "bn2": init_bn_params(cout, device),
    }
    state = {"bn1": init_bn_state(cmid, device), "bn2": init_bn_state(cout, device)}
    return params, state


def _convt_init(rng, cin: int, cout: int, *, device) -> Params:
    """ConvTranspose2d(cin, cout, k=2, s=2) as HWIO (2, 2, cin, cout) plus a
    bias: torch's fan_in for its (Cin, Cout, k, k) weight is Cout * k * k."""
    bound = 1.0 / (cout * 2 * 2) ** 0.5
    return {"w": _uniform(rng, (2, 2, cin, cout), bound, device),
            "b": _uniform(rng, (cout,), bound, device)}


def encoder_plan(config: UNetConfig) -> list[tuple[int, int]]:
    """(in, out) channels of inc, down1..down4: the reference's 64, 128,
    256, 512, 1024 // f at base 64, f = 2 if bilinear."""
    c, f = config.base_channels, 2 if config.bilinear else 1
    return [(config.n_channels, c), (c, 2 * c), (2 * c, 4 * c), (4 * c, 8 * c),
            (8 * c, 16 * c // f)]


def decoder_plan(config: UNetConfig) -> list[tuple[int, int, int]]:
    """(skip, in, out) channels of up1..up4: in 1024 // f, 512 // f, 256 // f,
    128 // f and out 512 // f, 256 // f, 128 // f, 64 at base 64."""
    c, f = config.base_channels, 2 if config.bilinear else 1
    return [(8 * c, 16 * c // f, 8 * c // f), (4 * c, 8 * c // f, 4 * c // f),
            (2 * c, 4 * c // f, 2 * c // f), (c, 2 * c // f, c)]


def init_unet(config: UNetConfig, rng: np.random.Generator,
              device: str | torch.device = "cpu") -> tuple[Params, State]:
    """(params, state) for ``config`` with torch's kaiming-uniform bounds,
    drawn from ``rng``, for every family (``config.arch``). The U-Net's
    channel plan is the reference's (``encoder_plan``, ``decoder_plan``).
    The values differ from JAX's ``init_unet`` (another generator); the
    shapes and keys are the same. On the ``meta`` device: the shapes alone,
    nothing drawn."""
    if config.arch != "unet":
        return _family(config.arch)[0](config, rng, device)
    params: Params = {}
    state: State = {}
    for name, (cin, cout) in zip(ENCODER, encoder_plan(config)):
        params[name], state[name] = _double_conv_init(rng, cin, cout, device=device)
    for i, (skip, cin, cout) in enumerate(decoder_plan(config), start=1):
        if config.bilinear:
            concat_c = skip + cin
            conv_p, conv_s = _double_conv_init(rng, concat_c, cout, concat_c // 2, device=device)
            params[f"up{i}"], state[f"up{i}"] = {"conv": conv_p}, {"conv": conv_s}
        else:
            up_p = _convt_init(rng, cin, cin // 2, device=device)
            conv_p, conv_s = _double_conv_init(rng, skip + cin // 2, cout, device=device)
            params[f"up{i}"], state[f"up{i}"] = {"up": up_p, "conv": conv_p}, {"conv": conv_s}
    params["outc"] = _conv_init(rng, 1, 1, config.base_channels, config.n_classes, bias=True,
                                device=device)
    return params, state


def tree_map(fn, tree, *rest):
    """Apply ``fn`` to every tensor of a nested dict / NamedTuple tree (with
    ``rest``: to the tensors at the same place in each tree)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(tree_map(fn, *vs) for vs in zip(tree, *rest)))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The tensors of a tree, in ``tree_map``'s order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, tuple):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_leaves_like(like, tree) -> list:
    """The tensors of ``tree`` in ``like``'s order (dict keys looked up by
    ``like``'s, as ``tree_map`` looks them up)."""
    out: list = []
    _collect_like(like, tree, out)
    return out


def _collect_like(like, tree, out: list) -> None:
    # module-level, not a closure: a recursive closure is a reference cycle,
    # which would hold the tensors it saw until the cyclic GC ran
    if isinstance(like, dict):
        for k, v in like.items():
            _collect_like(v, tree[k], out)
    elif isinstance(like, tuple):
        for v, t in zip(like, tree):
            _collect_like(v, t, out)
    else:
        out.append(tree)


def tree_unflatten(like, leaves):
    """A tree shaped as ``like`` holding ``leaves`` in ``tree_leaves``'
    order."""
    return _rebuild(like, iter(leaves))


def _rebuild(like, it):
    if isinstance(like, dict):
        return {k: _rebuild(v, it) for k, v in like.items()}
    if isinstance(like, tuple):
        return type(like)(*(_rebuild(v, it) for v in like))
    return next(it)


def param_count(params: Params) -> int:
    return sum(param_count(v) if isinstance(v, dict) else v.numel() for v in params.values())


def _double_conv_apply(params, state, x, *, train: bool, kernels=None, first: bool = False,
                       group=None):
    """(conv3x3 → BN → ReLU) × 2. ``kernels="cuda"`` in train mode runs it on
    the train kernels (``ops/conv_stats.py``); ``first`` marks the block whose
    input (the image) needs no gradient; ``group``: BN over every rank, and
    with a spatial ``Band`` the convs' halo rows too. A block sharded over a
    model axis (``parallel.collectives.ModelShard``) runs conv1 on its Cout
    shard and conv2 on its Cin shard between a copy to and a reduce from the
    model group (``parallel/tensor.py``)."""
    if kernels == "cuda" and train:
        if isinstance(group, Band):
            raise Refused("--kernels cuda data parallelism is 1-D (shard_map); "
                          "--spatial-parallel requires the XLA backend (--kernels torch)")
        if getattr(group, "model_size", 1) > 1:
            raise Refused("--kernels cuda data parallelism is 1-D (shard_map); "
                          "--tensor-parallel requires the XLA backend (--kernels torch)")
        return double_conv_train_fused(params, state, x, input_needs_grad=not first,
                                       group=group)
    axis = model_axis_of(params, group)
    if axis is not None:
        x = copy_to_model(x, axis)
    h = conv2d(x, params["conv1"]["w"], stride=1, padding=1, group=group)
    h, bn1 = batch_norm(h.to(x.dtype), params["bn1"], state["bn1"], train=train, group=group)
    h = conv2d(torch.relu(h), params["conv2"]["w"], stride=1, padding=1, group=group)
    if axis is not None:
        h = reduce_from_model(h, axis)
    h, bn2 = batch_norm(h.to(x.dtype), params["bn2"], state["bn2"], train=train, group=group)
    return torch.relu(h), {"bn1": bn1, "bn2": bn2}


def _upsample(params, x1, x2, *, bilinear: bool, group=None) -> torch.Tensor:
    """x1 upsampled 2x (align-corners bilinear, or the block's ConvTranspose
    plus its bias) and padded to the skip x2's size; ``group`` is the skip's
    level (a ``Band``: x1 is on the next one)."""
    if bilinear:
        x1 = upsample2x_align_corners(x1, group=coarser(group))
    else:
        up = conv_transpose2d(x1, params["up"]["w"], stride=2, group=coarser(group))
        x1 = (up.float() + params["up"]["b"].float()).to(x1.dtype)
    return pad_to_match(x1, x2, group=group)


def _up_apply(params, state, x1, x2, *, bilinear: bool, block, group=None):
    """Decoder block: upsample x1, pad it to the skip x2, concat [x2, x1],
    then ``block`` (the DoubleConv, or R2U-Net's RRCNN) under ``conv``."""
    x = torch.cat([x2, _upsample(params, x1, x2, bilinear=bilinear, group=group)], dim=-1)
    out, conv_state = block(params["conv"], state["conv"], x, group=group)
    return out, {"conv": conv_state}


def _remat(fn):
    """``fn`` recomputed in the backward pass instead of saving its
    activations."""
    def wrapped(*args, **kwargs):
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False, **kwargs)
    return wrapped


ENCODER = ("inc", "down1", "down2", "down3", "down4")


def encoder_decoder(params: Params, state: State, x: torch.Tensor, *, block, up,
                    remat: bool = False, inc_kwargs: dict | None = None, group=None
                    ) -> tuple[torch.Tensor, State]:
    """The U-Net topology over a family's blocks: ``block`` on the input
    (inc, with ``inc_kwargs``) and after each 2x2 max pool (down1..4), ``up``
    (up1..4) on the deeper output and its skip, the 1x1 ``outc`` head. Each
    block is ``fn(params, state, *inputs, group=) -> (out, new state)``, with
    ``group`` that of its level (``parallel.halo.levels``: a grid's ``Band``;
    otherwise ``group`` itself); ``remat`` recomputes each in the backward
    pass, the blocks JAX wraps in ``jax.checkpoint``, the collectives of a
    grid again in the same order on every rank."""
    if remat:
        block, up = _remat(block), _remat(up)
    lv = levels(group, x)
    new_state: State = {}
    h, new_state["inc"] = block(params["inc"], state["inc"], x, group=lv[0],
                                **(inc_kwargs or {}))
    skips = [h]
    for k, name in enumerate(ENCODER[1:], start=1):
        h, new_state[name] = block(params[name], state[name], max_pool2d(h, group=lv[k - 1]),
                                   group=lv[k])
        skips.append(h)
    for i, skip in zip(range(1, 5), skips[-2::-1]):
        name = f"up{i}"
        h, new_state[name] = up(params[name], state[name], h, skip, group=lv[4 - i])
    logits = conv2d(h, params["outc"]["w"], stride=1, padding=0, group=lv[0])
    return logits.float() + params["outc"]["b"].float(), new_state


def _family(arch: str):
    """(init, apply) of a family other than the U-Net, imported at the call:
    the families' modules import this one."""
    if arch == "unetpp":
        from tpu_unet_torch.models.unetpp import init_unetpp as init, unetpp_apply as apply
    elif arch == "attention":
        from tpu_unet_torch.models.attention_unet import (
            attention_unet_apply as apply,
            init_attention_unet as init,
        )
    elif arch == "r2u":
        from tpu_unet_torch.models.r2u_unet import init_r2u_unet as init, r2u_unet_apply as apply
    elif arch == "r2attu":
        from tpu_unet_torch.models.r2attu_unet import (
            init_r2attu_unet as init,
            r2attu_unet_apply as apply,
        )
    else:
        raise ValueError(f"unknown arch {arch!r}; one of {ARCHS}")
    return init, apply


def unet_apply(params: Params, state: State, x: torch.Tensor, *, config: UNetConfig,
               train: bool = False, compute_dtype: torch.dtype | None = None,
               remat: bool = False, group=None,
               kernels: str | None = None) -> tuple[torch.Tensor, State]:
    """Forward pass of any family (``config.arch``). x: [N,H,W,n_channels]
    -> (fp32 logits [N,H,W,n_classes], new BN state).

    ``compute_dtype=torch.bfloat16`` is the JAX package's AMP: the input and
    every parameter are cast to bf16 (explicitly, not through autocast), the
    convs accumulate in fp32, BN statistics are fp32, the logits fp32.
    ``kernels="cuda"`` in train mode runs every DoubleConv on the train
    kernels, as JAX's ``kernels="pallas"``; eval mode and ``kernels=None``
    run library convs and ``batch_norm``. The other families have no kernel
    route: ``kernels`` with them raises, as JAX's ``kernels="pallas"`` does.

    ``remat`` recomputes each block in the backward pass instead of keeping
    its activations (``torch.utils.checkpoint``, non-reentrant), the blocks
    JAX wraps in ``jax.checkpoint``: every DoubleConv (RRCNN) and decoder
    block. The forward is functional (BN running stats come back as new
    tensors), so a recomputation cannot update them twice; it does launch a
    block's forward kernels a second time.

    ``group`` (a ``ProcessGroup``, or None) is JAX's ``axis_name``: under
    data parallelism (``parallel/mesh.py``) every train-mode BatchNorm of
    every family, on both kernel routes, takes the statistics of the global
    batch, all-reduced over the group's ranks. A ``parallel.mesh.Grid``
    (spatial parallelism, library route only) runs every family on this
    rank's height band of each image: each level's layer takes the rows it
    reads from the other ranks (``parallel/halo.py``), and the BN sums go
    over the whole grid; the logits are the band's.

    A ``group`` with a model axis (a grid at T > 1, or its ``ModelAxis``)
    takes ``params`` and ``state`` as this rank's shards
    (``parallel.tensor.shard_model``): every block they shard runs its
    collectives over the model group, and the BN sums go over the replica
    group (``parallel/tensor.py``); the logits are whole on every model
    rank."""
    check_kernels(config, kernels)
    if config.s2d_level0:
        raise NotImplementedError("unet_apply: s2d_level0 is a TPU experiment, not ported")
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        params = tree_map(lambda p: p.to(compute_dtype), params)
    if getattr(group, "model_size", 1) > 1:
        # The specs come from a meta-device init_unet, so parallel/tensor.py
        # imports this module; the import waits for a model axis.
        from tpu_unet_torch.parallel.tensor import model_specs

        params = mark_shards(params, model_specs(config, group.model_size)[0])
    x = x.contiguous()
    if config.arch != "unet":
        return _family(config.arch)[1](params, state, x, config=config, train=train,
                                          remat=remat, group=group)

    dc = functools.partial(_double_conv_apply, train=train, kernels=kernels)
    up = functools.partial(_up_apply, bilinear=config.bilinear, block=dc)
    # inc is the only block whose input (the image) needs no gradient.
    return encoder_decoder(params, state, x, block=dc, up=up, remat=remat,
                           inc_kwargs={"first": True}, group=group)
