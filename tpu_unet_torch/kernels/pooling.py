"""2x2 / stride-2 max pool on NHWC, floor mode: the port of
``tpu_unet/kernels/pooling.py::max_pool2x2`` as a hand-written CUDA kernel
(``tpu_unet_torch/csrc/pooling.cu``; its header says what bounds it on the
H100 and how the design answers).

``max_pool2x2`` launches the kernel for a CUDA tensor and runs its plain
PyTorch version, ``max_pool2x2_plain``, for a CPU tensor. It never falls
back: a failed build or launch raises. ``max_pool2x2.launches`` counts the
kernel launches. :func:`pool_plan` is the kernel's launch plan; the kernel
takes it as it is and checks it.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import torch

from tpu_unet_torch.kernels import _build

_count_lock = threading.Lock()

# Mirror of csrc/pooling.cu (a CPU test checks that they agree): the most
# threads of a block.
POOL_THREADS = 128


def max_pool2x2_plain(x: torch.Tensor) -> torch.Tensor:
    """[N,H,W,C] -> [N,H//2,W//2,C]: the kernel's math in plain PyTorch."""
    h2, w2 = x.shape[1] // 2, x.shape[2] // 2
    x = x[:, : 2 * h2, : 2 * w2]
    rows = torch.maximum(x[:, 0::2], x[:, 1::2])
    return torch.maximum(rows[:, :, 0::2], rows[:, :, 1::2]).contiguous()


class PoolPlan(NamedTuple):
    """A block of tx x py threads owns one output row and py of its pixels;
    thread (tx, ty) moves channel vectors of ``vec`` channels tx, tx +
    tx_count, ... of one pixel. Grid: N * H//2 rows times ceil(W//2 / py)
    blocks."""

    vec: int
    tx: int
    py: int


def pool_plan(c: int, elem_bytes: int, aligned: bool) -> PoolPlan:
    """The launch plan of ``max_pool2x2`` on C channels of ``elem_bytes``:
    16-byte vectors when the channel row is a multiple of 16 bytes and both
    pointers are ``aligned``, else one element; tx over a pixel's vectors
    (at most POOL_THREADS), py = POOL_THREADS // tx pixels."""
    vec = 16 // elem_bytes if aligned and (c * elem_bytes) % 16 == 0 else 1
    tx = max(1, min(c // vec, POOL_THREADS))
    return PoolPlan(vec, tx, POOL_THREADS // tx)


def max_pool2x2(x: torch.Tensor) -> torch.Tensor:
    """[N,H,W,C] -> [N,H//2,W//2,C], floor mode; fp32 or bf16."""
    if x.device.type == "cpu":
        return max_pool2x2_plain(x)
    if x.ndim != 4:
        raise ValueError(f"max_pool2x2: expected [N,H,W,C], got {tuple(x.shape)}")
    dtype = _build.validate("max_pool2x2", x)
    n, h, w, c = x.shape
    if 2 * w * c >= 2 ** 31:
        raise ValueError(f"max_pool2x2: a row pair of {2 * w * c} elements exceeds 32-bit offsets")
    out = torch.empty((n, h // 2, w // 2, c), dtype=x.dtype, device=x.device)
    plan = pool_plan(c, x.element_size(), x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    lib = _build.library()
    with _build.on_device(x):
        err = lib.tuk_max_pool2x2(x.data_ptr(), out.data_ptr(), n, h, w, c, dtype, plan.vec,
                                  plan.tx, plan.py, _build.stream(x))
    _build.check(err, "max_pool2x2")
    with _count_lock:
        max_pool2x2.launches += 1
    return out


max_pool2x2.launches = 0
