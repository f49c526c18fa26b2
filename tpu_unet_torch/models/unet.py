"""The flagship U-Net's configuration and parameter layout
(``tpu_unet/models/unet.py``).

Parameters are the JAX package's nested dicts, with tensors in its layouts
(HWIO conv weights), and BN running statistics are explicit ``BNState``
state, so a JAX checkpoint maps onto them key for key
(``tpu_unet_torch/checkpoint.py``). The train-mode forward waits for the
training slice of the port; serving runs the folded forward in
``models/infer.py``.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from tpu_unet_torch.ops.batchnorm import init_bn_params, init_bn_state

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


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor of a nested dict / BNState tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    return fn(tree)


def param_count(params: Params) -> int:
    return sum(param_count(v) if isinstance(v, dict) else v.numel() for v in params.values())
