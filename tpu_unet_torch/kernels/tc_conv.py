"""The bf16 tensor-core route of ``fused_conv3x3_scale_relu`` and
``conv3x3_fwd``: one implicit-GEMM kernel, ``tpu_unet_torch/csrc/tc_conv.cu``
(mma.sync on the tensor cores, TMA loads), with a loader policy (raw
input, or the BN prologue relu(x*a + c)) and an epilogue policy (folded-BN
scale/bias + ReLU, or the bare conv with its (sum z, sum z^2) partials).

:func:`tc_plan` is the one tile plan: the launchers size the stats partials
from it and pass its tile to the kernel, which indexes the partials by it.
The CPU tests check that it covers every output pixel once.

The wrappers of ``fused_conv`` and ``train_conv`` call the launchers here for
bf16 CUDA tensors; the launchers never run on the CPU.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import NamedTuple

import torch

from tpu_unet_torch.kernels import _build

# Mirrors of csrc/tc_conv.cu (a CPU test checks that they agree): input
# channels per staged chunk, and the block configurations by id: (BM output
# pixels, BN output channels, most staged pixels of the tile plus its halo).
KC = 32
CONFIGS = {
    0: (128, 128, 288),  # Cout > 64
    1: (256, 64, 400),   # Cout <= 64
}


class TcPlan(NamedTuple):
    """A block computes a th x tw rectangle of output pixels of one image
    (th * tw <= bm) for bn output channels, staging kc input channels at a
    time, with the kernel's configuration ``cfg``. Grid: (tiles,
    co_blocks, n)."""

    cfg: int
    bm: int
    bn: int
    kc: int
    th: int
    tw: int
    tiles_h: int
    tiles_w: int
    co_blocks: int
    n: int

    @property
    def tiles(self) -> int:
        return self.tiles_h * self.tiles_w

    @property
    def grid(self) -> tuple[int, int, int]:
        return self.tiles, self.co_blocks, self.n

    @property
    def partial_rows(self) -> int:
        """Rows of the fp32 [rows, 2, Cout] stats scratch: one per (image, tile)."""
        return self.n * self.tiles

    def tile_origin(self, t: int) -> tuple[int, int]:
        """(h0, w0) of tile t, as the kernel computes it from blockIdx.x."""
        return (t // self.tiles_w) * self.th, (t % self.tiles_w) * self.tw


@functools.lru_cache(maxsize=256)
def tc_plan(n: int, h: int, w: int, cout: int) -> TcPlan:
    """The tile for an [n, h, w, *] -> cout conv. Cout <= 64 takes 256 pixels
    x 64 channels a block, wider outputs 128 x 128. For each width, the
    tallest rectangle whose staged tile fits the staging buffer (any shape
    has one: a 1-pixel-wide column fits); among those, the least cost per
    image: tiles x (bm MMA rows, masked ones included, + staged pixels x
    16 / bn). A staged pixel (64 bytes a chunk from L2) costs about 16 / bn of
    an MMA row's 9 x 32 x bn multiply-adds, so the halo decides only between
    tilings of about equal MMA work (16 x 16 rather than 4 x 64 at 572²).
    Cached: the search is a Python loop over up to 256 widths, which would
    otherwise cost more host time per call than the kernel takes."""
    cfg = 1 if cout <= 64 else 0
    bm, bn, max_staged = CONFIGS[cfg]
    best = None
    for tw in range(1, min(w, bm) + 1):
        th = min(bm // tw, h, max_staged // (tw + 2) - 2)
        if th < 1:
            continue
        staged = (th + 2) * (tw + 2)
        tiles = math.ceil(h / th) * math.ceil(w / tw)
        key = (tiles * (bm + staged * 16 / bn), -tw)
        if best is None or key < best[0]:
            best = (key, th, tw)
    _, th, tw = best
    return TcPlan(cfg, bm, bn, KC, th, tw, math.ceil(h / th), math.ceil(w / tw),
                  math.ceil(cout / bn), n)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its data is 16-byte aligned (the kernel's copies are
    16 bytes), else an aligned copy."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _pad_last(t: torch.Tensor, size: int) -> torch.Tensor:
    """Zero-pad the last dimension of ``t`` to ``size``."""
    if t.shape[-1] == size:
        return t
    return torch.nn.functional.pad(t, (0, size - t.shape[-1]))


def _padded(x, w, cout8, vecs=()):
    """x, w and per-input-channel vectors zero-padded to Cin % 8 == 0 (zero
    channels add zero, as in the Pallas kernel's Cin = 3 case), w to Cout % 8."""
    cin8 = -(-x.shape[3] // 8) * 8
    if cin8 == x.shape[3] and cout8 == w.shape[3]:  # the model's convs: nothing to pad
        return (_aligned(x), _aligned(w), *(None if v is None else _aligned(v) for v in vecs))
    w = _pad_last(w.transpose(2, 3), cin8).transpose(2, 3)  # pad Cin
    w = _pad_last(w, cout8).contiguous()
    return (_aligned(_pad_last(x, cin8).contiguous()), _aligned(w),
            *(None if v is None else _aligned(_pad_last(v, cin8).contiguous()) for v in vecs))


def _on_device(t: torch.Tensor):
    """A context that makes ``t``'s device current, or none when it is."""
    if t.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)


def _check_bf16(name, *tensors):
    _build.validate(name, *tensors)
    if tensors[0].dtype != torch.bfloat16:
        raise ValueError(f"{name}: the tensor-core route takes bfloat16, got {tensors[0].dtype}")


def fused_conv3x3(x, w, scale, bias, apply_relu: bool) -> torch.Tensor:
    """[relu](conv3x3_same(x, w) * scale + bias) in bf16 on the tensor cores.
    x: [N,H,W,Cin] bf16, w: [3,3,Cin,Cout] bf16, scale/bias fp32 [Cout]."""
    name = "fused_conv3x3_scale_relu"
    _check_bf16(name, x, w)
    n, h, wd, _ = x.shape
    cout = w.shape[3]
    cout8 = -(-cout // 8) * 8
    xp, wp = _padded(x, w, cout8)
    s = _aligned(_pad_last(scale, cout8).contiguous())
    b = _aligned(_pad_last(bias, cout8).contiguous())
    plan = tc_plan(n, h, wd, cout8)
    out = torch.empty((n, h, wd, cout8), dtype=x.dtype, device=x.device)
    lib = _build.library()
    with _on_device(x):
        err = lib.tuk_tc_fused_conv3x3(xp.data_ptr(), wp.data_ptr(), s.data_ptr(), b.data_ptr(),
                                       out.data_ptr(), n, h, wd, xp.shape[3], cout8,
                                       int(apply_relu), plan.cfg, plan.th, plan.tw,
                                       _build.stream(x))
    _build.check(err, name)
    return out if cout8 == cout else out[..., :cout].contiguous()


def conv3x3_fwd(x, w, a, c, stats: bool):
    """z = conv3x3_same(relu(x*a + c) or x, w) in bf16 on the tensor cores;
    with ``stats`` also the fp32 [2, Cout] (sum z, sum z^2) of the rounded z.
    a, c: fp32 [Cin] or None."""
    name = "conv3x3_fwd"
    _check_bf16(name, x, w)
    n, h, wd, _ = x.shape
    cout = w.shape[3]
    cout8 = -(-cout // 8) * 8
    xp, wp, ap, cp = _padded(x, w, cout8, (a, c))
    plan = tc_plan(n, h, wd, cout8)
    z = torch.empty((n, h, wd, cout8), dtype=x.dtype, device=x.device)
    partials = st = None
    if stats:
        partials = torch.empty((plan.partial_rows, 2, cout8), dtype=torch.float32,
                               device=x.device)
        st = torch.empty((2, cout8), dtype=torch.float32, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = _build.library()
    with _on_device(x):
        err = lib.tuk_tc_conv3x3_fwd(xp.data_ptr(), ptr(ap), ptr(cp), wp.data_ptr(),
                                     z.data_ptr(), ptr(partials), ptr(st), n, h, wd, xp.shape[3],
                                     cout8, plan.cfg, plan.th, plan.tw, _build.stream(x))
    _build.check(err, name)
    if cout8 != cout:
        z = z[..., :cout].contiguous()
        st = None if st is None else st[:, :cout].contiguous()
    return (z, st) if stats else z
