"""2x2 / stride-2 max pool on NHWC, floor mode: the port of
``tpu_unet/kernels/pooling.py::max_pool2x2`` as a hand-written CUDA kernel
(``tpu_unet_torch/csrc/pooling.cu``; its header says what bounds it on the
H100 and how the design answers).

``max_pool2x2`` launches the kernel for a CUDA tensor and runs its plain
PyTorch version, ``max_pool2x2_plain``, for a CPU tensor. It never falls
back: a failed build or launch raises. ``max_pool2x2.launches`` counts the
kernel launches.
"""

from __future__ import annotations

import threading

import torch

from tpu_unet_torch.kernels import _build

_count_lock = threading.Lock()


def max_pool2x2_plain(x: torch.Tensor) -> torch.Tensor:
    """[N,H,W,C] -> [N,H//2,W//2,C]: the kernel's math in plain PyTorch."""
    h2, w2 = x.shape[1] // 2, x.shape[2] // 2
    x = x[:, : 2 * h2, : 2 * w2]
    rows = torch.maximum(x[:, 0::2], x[:, 1::2])
    return torch.maximum(rows[:, :, 0::2], rows[:, :, 1::2]).contiguous()


def max_pool2x2(x: torch.Tensor) -> torch.Tensor:
    """[N,H,W,C] -> [N,H//2,W//2,C], floor mode; fp32 or bf16."""
    if x.device.type == "cpu":
        return max_pool2x2_plain(x)
    if x.ndim != 4:
        raise ValueError(f"max_pool2x2: expected [N,H,W,C], got {tuple(x.shape)}")
    dtype = _build.validate("max_pool2x2", x)
    n, h, w, c = x.shape
    out = torch.empty((n, h // 2, w // 2, c), dtype=x.dtype, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.tuk_max_pool2x2(x.data_ptr(), out.data_ptr(), n, h, w, c, dtype,
                                  _build.stream(x))
    _build.check(err, "max_pool2x2")
    with _count_lock:
        max_pool2x2.launches += 1
    return out


max_pool2x2.launches = 0
