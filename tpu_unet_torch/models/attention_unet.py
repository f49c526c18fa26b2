"""Attention U-Net: the U-Net with each skip connection gated by additive
attention (Oktay et al., arXiv:1804.03999; ``tpu_unet/models/attention_unet.py``).

The decoder's upsampled feature g gates the encoder skip x before the
concatenation:

    att(g, x) = x * sigmoid(BN(psi(relu(BN(W_g g) + BN(W_x x)))))

with W_g, W_x and psi 1x1 convs without bias and F_int = x_ch // 2. The
encoder, the channel plan and both decoder modes are the U-Net's.
Parameters and BN state are the JAX package's trees, key for key.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_unet_torch.models.unet import (
    ENCODER,
    Params,
    State,
    UNetConfig,
    _conv_init,
    _convt_init,
    _double_conv_apply,
    _double_conv_init,
    _upsample,
    decoder_plan,
    encoder_decoder,
    encoder_plan,
)
from tpu_unet_torch.ops import batch_norm, conv2d
from tpu_unet_torch.ops.batchnorm import init_bn_params, init_bn_state


def _gate_init(rng, g_ch: int, x_ch: int, *, device) -> tuple[Params, State]:
    """Additive attention gate: W_g (g_ch -> f), W_x (x_ch -> f), psi (f -> 1)."""
    f_int = max(1, x_ch // 2)
    params = {
        "wg": _conv_init(rng, 1, 1, g_ch, f_int, bias=False, device=device),
        "bn_g": init_bn_params(f_int, device),
        "wx": _conv_init(rng, 1, 1, x_ch, f_int, bias=False, device=device),
        "bn_x": init_bn_params(f_int, device),
        "psi": _conv_init(rng, 1, 1, f_int, 1, bias=False, device=device),
        "bn_psi": init_bn_params(1, device),
    }
    state = {"bn_g": init_bn_state(f_int, device), "bn_x": init_bn_state(f_int, device),
             "bn_psi": init_bn_state(1, device)}
    return params, state


def _gate_apply(params, state, g, x, *, train: bool, group=None):
    """x gated by g (both at x's spatial size); ``group``: the BNs over every
    rank (a spatial ``Band``: its level's rows)."""
    bn = functools.partial(batch_norm, train=train, group=group)
    conv = functools.partial(conv2d, stride=1, padding=0, group=group)
    hg = conv(g, params["wg"]["w"])
    hg, bn_g = bn(hg.to(g.dtype), params["bn_g"], state["bn_g"])
    hx = conv(x, params["wx"]["w"])
    hx, bn_x = bn(hx.to(x.dtype), params["bn_x"], state["bn_x"])
    a = conv(torch.relu(hg + hx), params["psi"]["w"])
    a, bn_psi = bn(a.to(x.dtype), params["bn_psi"], state["bn_psi"])
    return x * torch.sigmoid(a), {"bn_g": bn_g, "bn_x": bn_x, "bn_psi": bn_psi}


def init_attention_unet(config: UNetConfig, rng: np.random.Generator,
                        device="cpu") -> tuple[Params, State]:
    """The U-Net's channel plan plus one attention gate per skip. In bilinear
    mode the gate's g has the decoder's in channels; with the ConvTranspose
    decoder, half of them."""
    params: Params = {}
    state: State = {}
    for name, (cin, cout) in zip(ENCODER, encoder_plan(config)):
        params[name], state[name] = _double_conv_init(rng, cin, cout, device=device)
    for i, (skip, cin, cout) in enumerate(decoder_plan(config), start=1):
        if config.bilinear:
            g_ch = cin  # the upsample keeps the channels
            conv_p, conv_s = _double_conv_init(rng, skip + cin, cout, (skip + cin) // 2,
                                               device=device)
            p = {"conv": conv_p}
        else:
            g_ch = cin // 2  # the ConvTranspose halves them
            p = {"up": _convt_init(rng, cin, g_ch, device=device)}
            p["conv"], conv_s = _double_conv_init(rng, skip + g_ch, cout, device=device)
        s = {"conv": conv_s}
        p["att"], s["att"] = _gate_init(rng, g_ch, skip, device=device)
        params[f"up{i}"], state[f"up{i}"] = p, s
    params["outc"] = _conv_init(rng, 1, 1, config.base_channels, config.n_classes, bias=True,
                                device=device)
    return params, state


def gated_up_apply(params, state, x1, x2, *, bilinear: bool, train: bool, block, group=None):
    """Decoder block: upsample x1, gate the skip x2 by it, concat [gated, x1],
    then ``block`` (the DoubleConv, or R2AttU-Net's RRCNN) under ``conv``."""
    x1 = _upsample(params, x1, x2, bilinear=bilinear, group=group)
    gated, att_state = _gate_apply(params["att"], state["att"], x1, x2, train=train,
                                   group=group)
    out, conv_state = block(params["conv"], state["conv"], torch.cat([gated, x1], dim=-1),
                            group=group)
    return out, {"att": att_state, "conv": conv_state}


def attention_unet_apply(params: Params, state: State, x: torch.Tensor, *, config: UNetConfig,
                         train: bool = False, remat: bool = False, group=None
                         ) -> tuple[torch.Tensor, State]:
    """Forward on params already in the compute dtype (``unet_apply`` casts
    them): [N,H,W,C] -> (fp32 logits, new BN state); ``group``: BN over
    every rank (``unet_apply``)."""
    dc = functools.partial(_double_conv_apply, train=train)
    up = functools.partial(gated_up_apply, bilinear=config.bilinear, train=train, block=dc)
    return encoder_decoder(params, state, x, block=dc, up=up, remat=remat, group=group)
