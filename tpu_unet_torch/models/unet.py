"""The flagship U-Net: configuration, parameter layout and forward
(``tpu_unet/models/unet.py``).

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

Params = dict[str, Any]
State = dict[str, Any]


class UNetConfig(NamedTuple):
    """The JAX package's ``UNetConfig``, field for field, so a checkpoint's
    stored config (``extra["config"]``) loads here unchanged. The port runs
    ``arch="unet"`` only so far; the other fields are carried, not used."""

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


def init_unet(config: UNetConfig, rng: np.random.Generator,
              device: str | torch.device = "cpu") -> tuple[Params, State]:
    """(params, state) for ``config`` with torch's kaiming-uniform bounds,
    drawn from ``rng``. The channel plan is the reference's: inc 64, down
    128/256/512/1024//f, up 512//f, 256//f, 128//f, 64 with f = 2 if bilinear.
    The values differ from JAX's ``init_unet`` (another generator); the
    shapes and keys are the same."""
    if config.arch != "unet":
        raise ValueError(f"tpu_unet_torch ports arch='unet' only, not {config.arch!r}")
    c = config.base_channels
    factor = 2 if config.bilinear else 1
    params: Params = {}
    state: State = {}
    params["inc"], state["inc"] = _double_conv_init(rng, config.n_channels, c, device=device)
    down = [(c, 2 * c), (2 * c, 4 * c), (4 * c, 8 * c), (8 * c, 16 * c // factor)]
    for i, (cin, cout) in enumerate(down, start=1):
        params[f"down{i}"], state[f"down{i}"] = _double_conv_init(rng, cin, cout, device=device)
    up = [(16 * c // factor, 8 * c // factor), (8 * c // factor, 4 * c // factor),
          (4 * c // factor, 2 * c // factor), (2 * c // factor, c)]
    for i, (cin, cout) in enumerate(up, start=1):
        skip = [8 * c, 4 * c, 2 * c, c][i - 1]
        if config.bilinear:
            concat_c = skip + cin
            conv_p, conv_s = _double_conv_init(rng, concat_c, cout, concat_c // 2, device=device)
            params[f"up{i}"], state[f"up{i}"] = {"conv": conv_p}, {"conv": conv_s}
        else:
            # ConvTranspose2d(cin, cin // 2, k=2, s=2): torch's fan_in for its
            # (Cin, Cout, k, k) weight is Cout * k * k.
            half = cin // 2
            bound = 1.0 / (half * 2 * 2) ** 0.5
            up_p = {"w": _uniform(rng, (2, 2, cin, half), bound, device),
                    "b": _uniform(rng, (half,), bound, device)}
            conv_p, conv_s = _double_conv_init(rng, skip + half, cout, device=device)
            params[f"up{i}"], state[f"up{i}"] = {"up": up_p, "conv": conv_p}, {"conv": conv_s}
    params["outc"] = _conv_init(rng, 1, 1, c, config.n_classes, bias=True, device=device)
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


def param_count(params: Params) -> int:
    return sum(param_count(v) if isinstance(v, dict) else v.numel() for v in params.values())


def _double_conv_apply(params, state, x, *, train: bool, kernels=None, first: bool = False):
    """(conv3x3 → BN → ReLU) × 2. ``kernels="cuda"`` in train mode runs it on
    the train kernels (``ops/conv_stats.py``); ``first`` marks the block whose
    input (the image) needs no gradient."""
    if kernels == "cuda" and train:
        return double_conv_train_fused(params, state, x, input_needs_grad=not first)
    h = conv2d(x, params["conv1"]["w"], stride=1, padding=1)
    h, bn1 = batch_norm(h.to(x.dtype), params["bn1"], state["bn1"], train=train)
    h = conv2d(torch.relu(h), params["conv2"]["w"], stride=1, padding=1)
    h, bn2 = batch_norm(h.to(x.dtype), params["bn2"], state["bn2"], train=train)
    return torch.relu(h), {"bn1": bn1, "bn2": bn2}


def _up_apply(params, state, x1, x2, *, bilinear: bool, train: bool, kernels=None):
    """Decoder block: upsample x1, pad it to the skip x2, concat [x2, x1],
    DoubleConv."""
    if bilinear:
        x1 = upsample2x_align_corners(x1)
    else:
        up = conv_transpose2d(x1, params["up"]["w"], stride=2)
        x1 = (up.float() + params["up"]["b"].float()).to(x1.dtype)
    x = torch.cat([x2, pad_to_match(x1, x2)], dim=-1)
    out, conv_state = _double_conv_apply(params["conv"], state["conv"], x, train=train,
                                         kernels=kernels)
    return out, {"conv": conv_state}


def _remat(fn):
    """``fn`` recomputed in the backward pass instead of saving its
    activations."""
    def wrapped(*args, **kwargs):
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False, **kwargs)
    return wrapped


def unet_apply(params: Params, state: State, x: torch.Tensor, *, config: UNetConfig,
               train: bool = False, compute_dtype: torch.dtype | None = None,
               remat: bool = False, axis_name: str | None = None,
               kernels: str | None = None) -> tuple[torch.Tensor, State]:
    """Forward pass. x: [N,H,W,n_channels] -> (fp32 logits
    [N,H,W,n_classes], new BN state).

    ``compute_dtype=torch.bfloat16`` is the JAX package's AMP: the input and
    every parameter are cast to bf16 (explicitly, not through autocast), the
    convs accumulate in fp32, BN statistics are fp32, the logits fp32.
    ``kernels="cuda"`` in train mode runs every DoubleConv on the train
    kernels, as JAX's ``kernels="pallas"``; eval mode and ``kernels=None``
    run library convs and ``batch_norm``.

    ``remat`` recomputes each block in the backward pass instead of keeping
    its activations (``torch.utils.checkpoint``, non-reentrant), the blocks
    JAX wraps in ``jax.checkpoint``: every DoubleConv and decoder block. The
    forward is functional (BN running stats come back as new tensors), so a
    recomputation cannot update them twice; it does launch a block's
    forward kernels a second time."""
    if config.arch != "unet":
        raise ValueError(f"tpu_unet_torch ports arch='unet' only, not {config.arch!r}")
    if kernels not in (None, "cuda"):
        raise ValueError(f"kernels must be None or 'cuda', got {kernels!r}")
    if axis_name is not None:
        raise NotImplementedError("unet_apply: axis_name (data parallelism) is not ported yet")
    if config.s2d_level0:
        raise NotImplementedError("unet_apply: s2d_level0 is a TPU experiment, not ported")
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        params = tree_map(lambda p: p.to(compute_dtype), params)
    x = x.contiguous()

    dc = functools.partial(_double_conv_apply, train=train, kernels=kernels)
    up = functools.partial(_up_apply, bilinear=config.bilinear, train=train, kernels=kernels)
    if remat:
        dc, up = _remat(dc), _remat(up)

    new_state: State = {}
    x1, new_state["inc"] = dc(params["inc"], state["inc"], x, first=True)
    skips = [x1]
    h = x1
    for i in range(1, 5):
        name = f"down{i}"
        h, new_state[name] = dc(params[name], state[name], max_pool2d(h))
        skips.append(h)
    for i, skip in zip(range(1, 5), skips[-2::-1]):
        name = f"up{i}"
        h, new_state[name] = up(params[name], state[name], h, skip)
    logits = conv2d(h, params["outc"]["w"], stride=1, padding=0)
    return logits.float() + params["outc"]["b"].float(), new_state
