"""UNet++: nested dense skip connections (Zhou et al., arXiv:1912.05074;
``tpu_unet/models/unetpp.py``).

Node X[i][0] is the backbone (a DoubleConv after a 2x2 max pool for i > 0);
node X[i][j], j >= 1, is a DoubleConv over concat(X[i][0..j-1], up(X[i+1][j-1]))
with ``up`` the align-corners 2x bilinear upsample, padded to X[i][0]'s
size. The grid always upsamples: ``config.bilinear`` is not used. The
logits come from X[0][4] through ``outc``, or with ``deep_supervision`` as
the fp32 mean of the per-column heads ``head1..head4`` on X[0][1..4].
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_unet_torch.models.unet import (
    Params,
    State,
    UNetConfig,
    _conv_init,
    _double_conv_apply,
    _double_conv_init,
    _remat,
)
from tpu_unet_torch.ops import conv2d, max_pool2d, pad_to_match, upsample2x_align_corners

DEPTH = 5  # levels 0..4, as the U-Net's


def init_unetpp(config: UNetConfig, rng: np.random.Generator,
                device="cpu") -> tuple[Params, State]:
    c = config.base_channels
    chans = [c * 2 ** i for i in range(DEPTH)]
    params: Params = {}
    state: State = {}
    for i in range(DEPTH):  # the backbone, column 0
        cin = config.n_channels if i == 0 else chans[i - 1]
        params[f"x{i}0"], state[f"x{i}0"] = _double_conv_init(rng, cin, chans[i], device=device)
    for j in range(1, DEPTH):  # nested nodes: j same-level inputs + the upsampled one
        for i in range(DEPTH - j):
            params[f"x{i}{j}"], state[f"x{i}{j}"] = _double_conv_init(
                rng, j * chans[i] + chans[i + 1], chans[i], device=device)
    if config.deep_supervision:
        for j in range(1, DEPTH):
            params[f"head{j}"] = _conv_init(rng, 1, 1, chans[0], config.n_classes, bias=True,
                                            device=device)
    else:
        params["outc"] = _conv_init(rng, 1, 1, chans[0], config.n_classes, bias=True,
                                    device=device)
    return params, state


def unetpp_apply(params: Params, state: State, x: torch.Tensor, *, config: UNetConfig,
                 train: bool = False, remat: bool = False) -> tuple[torch.Tensor, State]:
    """Forward on params already in the compute dtype (``unet_apply`` casts
    them): [N,H,W,C] -> (fp32 logits, new BN state). ``remat`` recomputes
    each node's DoubleConv in the backward pass."""
    dc = functools.partial(_double_conv_apply, train=train)
    if remat:
        dc = _remat(dc)
    nodes: dict[tuple[int, int], torch.Tensor] = {}
    new_state: State = {}
    h = x
    for i in range(DEPTH):
        name = f"x{i}0"
        h, new_state[name] = dc(params[name], state[name], max_pool2d(h) if i else h)
        nodes[(i, 0)] = h
    for j in range(1, DEPTH):
        for i in range(DEPTH - j):
            up = pad_to_match(upsample2x_align_corners(nodes[(i + 1, j - 1)]), nodes[(i, 0)])
            name = f"x{i}{j}"
            nodes[(i, j)], new_state[name] = dc(
                params[name], state[name],
                torch.cat([nodes[(i, k)] for k in range(j)] + [up], dim=-1))
    if config.deep_supervision:
        # The paper's "accurate" mode: the mean of the per-column heads.
        heads = [conv2d(nodes[(0, j)], params[f"head{j}"]["w"], stride=1, padding=0).float()
                 + params[f"head{j}"]["b"].float() for j in range(1, DEPTH)]
        return sum(heads) / len(heads), new_state
    logits = conv2d(nodes[(0, DEPTH - 1)], params["outc"]["w"], stride=1, padding=0)
    return logits.float() + params["outc"]["b"].float(), new_state
