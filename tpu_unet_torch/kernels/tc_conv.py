"""The bf16 tensor-core route of ``fused_conv3x3_scale_relu``,
``fused_conv3x3_concat_scale_relu``, ``conv3x3_fwd``, ``conv3x3_dx``,
``conv3x3_dw`` and ``im2col_conv3x3``, in ``tpu_unet_torch/csrc/tc_conv.cu``,
and of ``fused_double_conv``, in ``csrc/tc_double_conv.cu`` (mma.sync on the
tensor cores, TMA loads); and the fp32 route of each in 3xTF32 (each fp32
operand split into TF32 hi and lo parts, lo*hi + hi*lo + hi*hi summed in
fp32: fp32 accuracy, which one TF32 pass would lose), with
``tc_plan``/``dw_plan``/``dc_plan`` given ``f32``:

- one implicit-GEMM kernel over output pixels whose K chunks come from one
  input or, for the concat conv, from the skip's tensor map and then the
  upsampled tensor's (weight rows Ca + 32 j for the second's chunk j, Ca +
  16 j in fp32: the concat is never built), with a loader policy (raw
  input; the BN prologue relu(x*a + c); or, for dx, the BN-backward
  cotangent dz = alpha*g + beta*z + gamma built from g's and z's staged
  boxes, z in one slot whose next box is issued once a chunk's dz is
  built) and an epilogue policy
  (folded-BN scale/bias + ReLU, bf16 or, for im2col, either dtype out
  from either dtype in; the bare
  conv with its (sum z, sum z^2) partials; dx's bf16 or fp32 output). It
  replaces ``tpu_unet/kernels/fused_conv.py:75`` and ``:192``,
  ``train_conv.py:128`` and ``:289`` (dx) and ``im2col_conv.py:84``;
- one kernel for dw (``tpu_unet/kernels/train_conv.py:441``), a GEMM over
  pixels (M = Cin, N = Cout per tap): a block owns 64 x 64 channels and all
  9 taps, 12 warps of 32 x 32 channels x the 3 taps of one kernel row (96
  fp32 accumulators a thread), and walks its split's pixel tiles, each
  rewritten (prologue, dz) once for the 9 taps;
- ``fused_double_conv`` (``csrc/tc_double_conv.cu``, replacing
  ``tpu_unet/kernels/fused_double_conv.py:94``), one kernel templated on the
  operand type: conv1 over the tile plus a 1-pixel halo into a mid tile
  (bf16, or fp32 unrounded) kept in shared memory (zero outside the image),
  conv2 from it on the same mainloop, and optionally the 2x2 max pool of the
  output tile in the epilogue (``tpu_unet/kernels/pooling.py:33`` for the
  encoder's first three pools).

All are bounded by their 2*9*Cin*Cout multiply-adds a pixel (operations)
at the deep levels and by bytes and operations about equally at level 0;
they run at 245-365 TFLOP/s on an H100 (PERF.md). Measured and dropped
(``csrc/tc_conv.cu``'s header has the details): dw blocks of one kernel
row, which rewrote each tile three times; a two-slot z ring for dx; a
wgmma variant of the forward.

:func:`tc_plan` is the one tile plan of the first kernel: the launchers size
the stats partials from it and pass its tile to the kernel, which indexes
the partials by it. :func:`dw_plan` is dw's: its tile and its splits of the
pixels, which size the fp32 partials that ``reduce_rows`` adds in a fixed
order. :func:`dc_plan` is the double conv's tile, whose mid tile and rings
must fit one block's shared memory. The CPU tests check that each covers
every pixel once.

The wrappers of ``fused_conv``, ``fused_double_conv``, ``train_conv`` and
``im2col_conv`` call the launchers here for bf16 and fp32 CUDA tensors; the
launchers never run on the CPU.
"""

from __future__ import annotations

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
# The dw kernel's block: input x output channels (and all 9 taps), the most
# pixels of a tile (its K rows) and of the tile plus its halo; one block an
# SM.
DW_CI = DW_CO = 64
DW_MAX_PX = 256
DW_MAX_STAGED = 400
# The fp32 (3xTF32) routes: the forward stages KC_F32 fp32 channels a chunk
# (the same 64 bytes a pixel) in F32_CONFIGS' blocks (the bf16 shapes, by the
# same ids); dw's block keeps DWF_CI x DWF_CO channels over tiles of at most
# DWF_MAX_PX pixels (DWF_MAX_STAGED with the halo).
KC_F32 = 16
F32_CONFIGS = {
    0: (128, 128, 288),
    1: (256, 64, 400),
}
# k-steps in the weight ring: STAGES, and for fp32 dx by configuration id
# (F32DxCfg*: its aux slot for z fits two 128 x 128 blocks an SM only with
# 3; the 256 x 64 block keeps 4).
STAGES = 4
F32_DX_STAGES = {0: 3, 1: 4}
DWF_CI = DWF_CO = 64
DWF_MAX_PX = 128
DWF_MAX_STAGED = 200


# Mirrors of csrc/tc_double_conv.cu (a CPU test checks that they agree): a
# block's warps, the most m16 fragments a warp holds, the weight ring's
# k-steps and the bytes of a slot, bf16 and fp32 (a slot holds both TF32
# planes of 128 columns x 16 K rows), the shared memory a block may use on
# the H100.
DC_WARPS = 8
DC_MI_MAX = 4
DC_STAGES = 6
DC_W_SLOT = 2 * KC * 128
DC_MI_MAX_F32 = 3
DC_STAGES_F32 = 3
DC_W_SLOT_F32 = 2 * 2 * 64 * KC_F32 * 4
DC_MAX_SMEM = 232448


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
def tc_plan(n: int, h: int, w: int, cout: int, f32: bool = False) -> TcPlan:
    """The tile for an [n, h, w, *] -> cout conv. Cout <= 64 takes 256 pixels
    x 64 channels a block, wider outputs 128 x 128. For each width, the
    tallest rectangle whose staged tile fits the staging buffer (any shape
    has one: a 1-pixel-wide column fits); among those, the least cost per
    image: tiles x (bm MMA rows, masked ones included, + staged pixels x
    16 / bn). A staged pixel (64 bytes a chunk from L2) costs about 16 / bn of
    an MMA row's 9 x 32 x bn multiply-adds, so the halo decides only between
    tilings of about equal MMA work (16 x 16 rather than 4 x 64 at 572²).
    ``f32``: the fp32 kernel's configurations (``F32_CONFIGS``, ``KC_F32``).
    Cached: the search is a Python loop over up to 256 widths, which would
    otherwise cost more host time per call than the kernel takes."""
    cfg = 1 if cout <= 64 else 0
    bm, bn, max_staged = (F32_CONFIGS if f32 else CONFIGS)[cfg]
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
    return TcPlan(cfg, bm, bn, KC_F32 if f32 else KC, th, tw, math.ceil(h / th),
                  math.ceil(w / tw), math.ceil(cout / bn), n)


class DwPlan(NamedTuple):
    """dw: the pixels are cut into th x tw tiles (image-major, row-major in an
    image); split s adds tiles s * tiles_per_split ... into a partial of its
    own. Grid: (ci_blocks * co_blocks, splits)."""

    th: int
    tw: int
    tiles_h: int
    tiles_w: int
    n: int
    ci_blocks: int
    co_blocks: int
    splits: int
    tiles_per_split: int

    @property
    def total_tiles(self) -> int:
        return self.n * self.tiles_h * self.tiles_w

    def split_tiles(self, s: int) -> range:
        """The tile indices split s walks, in order."""
        start = s * self.tiles_per_split
        return range(start, min(self.total_tiles, start + self.tiles_per_split))

    def tile_origin(self, t: int) -> tuple[int, int, int]:
        """(image, h0, w0) of tile t, as the kernel computes it."""
        n, r = divmod(t, self.tiles_h * self.tiles_w)
        return n, (r // self.tiles_w) * self.th, (r % self.tiles_w) * self.tw


@functools.lru_cache(maxsize=256)
def dw_plan(n: int, h: int, w: int, cin: int, cout: int, num_sms: int,
            f32: bool = False) -> DwPlan:
    """The tile and the splits of an [n, h, w, cin] x [n, h, w, cout] dw.
    Tile: for each width, the tallest rectangle of at most DW_MAX_PX pixels
    whose staged halo fits; among those the least cost per image: tiles x (3
    x K rows padded to 16, for the MMAs and the g and z boxes, + staged
    pixels, for the x box). Splits: the count, up to two waves of blocks
    (one an SM), whose last wave is fullest (the fewest blocks' time per
    split's share of the work), the fewest among equals: each split beyond
    the first adds a [9, cin, cout] fp32 partial for reduce_rows. ``f32``:
    the fp32 kernel's tile limits (``DWF_*``) and k8 steps. Cached, as
    tc_plan."""
    if f32:
        max_px, max_staged, kstep, bci, bco = DWF_MAX_PX, DWF_MAX_STAGED, 8, DWF_CI, DWF_CO
    else:
        max_px, max_staged, kstep, bci, bco = DW_MAX_PX, DW_MAX_STAGED, 16, DW_CI, DW_CO
    best = None
    for tw in range(1, min(w, max_px) + 1):
        th = min(max_px // tw, h, max_staged // (tw + 2) - 2)
        if th < 1:
            continue
        kpad = -(-th * tw // kstep) * kstep
        tiles = math.ceil(h / th) * math.ceil(w / tw)
        key = (tiles * (3 * kpad + (th + 2) * (tw + 2)), -tw)
        if best is None or key < best[0]:
            best = (key, th, tw)
    _, th, tw = best
    tiles_h, tiles_w = math.ceil(h / th), math.ceil(w / tw)
    ci_blocks, co_blocks = math.ceil(cin / bci), math.ceil(cout / bco)
    total = n * tiles_h * tiles_w
    blocks = ci_blocks * co_blocks
    most = max(1, min(total, math.ceil(2 * num_sms / blocks)))
    splits = min(range(1, most + 1), key=lambda s: (math.ceil(blocks * s / num_sms) / s, s))
    per = max(1, math.ceil(total / splits))
    return DwPlan(th, tw, tiles_h, tiles_w, n, ci_blocks, co_blocks,
                  max(1, math.ceil(total / per)), per)


def _up_align(v: int) -> int:
    return -(-v // 1024) * 1024


def dc_smem(th: int, tw: int, cmid: int, cout: int, f32: bool = False) -> int:
    """Dynamic shared memory of one double-conv block, as the kernel's
    ``layout()``: the 1024-byte alignment slack, Cmid / KC mid slots (KC =
    32 bf16 or 16 fp32 channels: 64 bytes a pixel in both) of the (th+2) x
    (tw+2) region, the two input slots of the (th+4) x (tw+4) box or the
    output tile (bf16 or fp32), whichever is larger, the weight ring and the
    mbarriers."""
    kc, es = (KC_F32, 4) if f32 else (KC, 2)
    stages, w_slot = (DC_STAGES_F32, DC_W_SLOT_F32) if f32 else (DC_STAGES, DC_W_SLOT)
    mid_slot = _up_align((th + 2) * (tw + 2) * 64)
    in_slot = _up_align((th + 4) * (tw + 4) * 64)
    out_tile = _up_align(th * tw * ((128 if cout > 64 else 64) + 8) * es)
    return (1024 + cmid // kc * mid_slot + max(2 * in_slot, out_tile) + stages * w_slot
            + (2 + stages) * 8)


def _dc_frags(m: int, warps: int) -> int:
    """The most m16 fragments a warp holds for m rows over ``warps`` warps."""
    return -(-(-(-m // 16)) // warps)


class DcPlan(NamedTuple):
    """The double conv's tile: a block computes a th x tw output tile (both
    even) of one image, all Cout channels. Grid: (tiles, 1, n)."""

    th: int
    tw: int
    tiles_h: int
    tiles_w: int
    n: int
    smem: int

    @property
    def tiles(self) -> int:
        return self.tiles_h * self.tiles_w

    def tile_origin(self, t: int) -> tuple[int, int]:
        """(h0, w0) of tile t, as the kernel computes it from blockIdx.x."""
        return (t // self.tiles_w) * self.th, (t % self.tiles_w) * self.tw


@functools.lru_cache(maxsize=256)
def dc_plan(n: int, h: int, w: int, cin: int, cmid: int, cout: int, num_sms: int,
            f32: bool = False) -> DcPlan:
    """The tile of an [n, h, w, cin] -> cmid -> cout double conv (cin a
    multiple of 8, cmid of 32 (bf16) or 16 (fp32), cout of 8). Candidates:
    even th x tw whose staged box fits TMA (<= 256 a side), whose rows fit
    the warps' fragments (conv1's (th+2)(tw+2) mid pixels and conv2's th*tw
    over 8 warps, or over 4 for each 64-column half of a 128-column pass; at
    most DC_MI_MAX, or DC_MI_MAX_F32 in fp32) and whose block fits the
    shared memory (``dc_smem``). Cost: the waves of blocks on ``num_sms``
    SMs (one block an SM) x a block's k-steps, each weighted by the
    fragments every warp computes in its phase (the busiest warp's, the
    kernel's MI1 and MI2; half of them in a chunk of x whose channels fit
    one k16 half, or one k8 step in fp32) plus one for the step's loads and
    barrier. An fp32 fragment's k-step issues three TF32 MMAs for each bf16
    one, and a k-step's loads (both planes of B, per group of 4 n8 blocks)
    and barrier weigh 4: with these weights the plan's tile was among the
    fastest of its wave count, within 1.4% of the fastest fitting tile up to
    16 x 64, at the three served shapes on the H100 (tools/dc_tile_sweep.py,
    PERF.md). The mid halo's recompute and the tile's edge waste both show
    in it. Cached, as tc_plan."""
    kc, mi_max = (KC_F32, DC_MI_MAX_F32) if f32 else (KC, DC_MI_MAX)
    mma, loads = (3, 4) if f32 else (1, 1)
    n1, c2 = -(-cmid // 128), cmid // kc
    passes2 = -(-cout // 128)
    # x's chunks as k16 halves (k8 steps) that hold channels: the kernel
    # skips the rest
    halves1 = [1.0 if cin - k0 > kc // 2 else 0.5 for k0 in range(0, cin, kc)]
    best = None
    for th in range(2, min(252, h + h % 2) + 1, 2):
        for tw in range(2, min(252, w + w % 2) + 1, 2):
            f1 = _dc_frags((th + 2) * (tw + 2), DC_WARPS // 2 if cmid > 64 else DC_WARPS)
            f2 = _dc_frags(th * tw, DC_WARPS // 2 if cout > 64 else DC_WARPS)
            if f1 > mi_max or f2 > mi_max:
                continue
            smem = dc_smem(th, tw, cmid, cout, f32)
            if smem > DC_MAX_SMEM:
                continue
            tiles = math.ceil(h / th) * math.ceil(w / tw)
            steps = (n1 * 9 * sum(mma * f1 * kks + loads for kks in halves1)
                     + passes2 * c2 * 9 * (mma * f2 + loads))
            key = (math.ceil(n * tiles / num_sms) * steps, tiles, -tw)
            if best is None or key < best[0]:
                best = (key, th, tw, smem)
    _, th, tw, smem = best
    return DcPlan(th, tw, math.ceil(h / th), math.ceil(w / tw), n, smem)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its data is 16-byte aligned (the kernel's copies are
    16 bytes), else an aligned copy."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _pad_last(t: torch.Tensor, size: int) -> torch.Tensor:
    """Zero-pad the last dimension of ``t`` to ``size``."""
    if t.shape[-1] == size:
        return t
    return torch.nn.functional.pad(t, (0, size - t.shape[-1]))


def _ceil8(v: int) -> int:
    return -(-v // 8) * 8


def _padded_sources(xs, w, cout8):
    """The sources ``xs`` (read as their channel concat, in order) each
    zero-padded to a multiple of 8 channels, with w's input rows padded to
    match (zero channels add zero, as in the Pallas kernel's Cin = 3 case),
    and w's Cout to ``cout8``. All aligned."""
    widths = [x.shape[3] for x in xs]
    if all(c % 8 == 0 for c in widths) and cout8 == w.shape[3]:  # the model's convs
        return [_aligned(x) for x in xs], _aligned(w)
    parts = torch.split(w, widths, dim=2)
    w = torch.cat([_pad_last(part.transpose(2, 3), _ceil8(c)).transpose(2, 3)
                   for part, c in zip(parts, widths)], dim=2)
    w = _pad_last(w, cout8).contiguous()
    return [_aligned(_pad_last(x, _ceil8(x.shape[3])).contiguous()) for x in xs], _aligned(w)


def _padded(x, w, cout8, vecs=()):
    """x, w and per-input-channel tensors (zero-padded along their last
    dimension) to Cin % 8 == 0, w to Cout % 8 (``_padded_sources``)."""
    (xp,), wp = _padded_sources([x], w, cout8)
    return (xp, wp, *(None if v is None else _aligned(_pad_last(v, xp.shape[3]).contiguous())
                      for v in vecs))


def _check_dtype(name, *tensors, fp32: bool = False):
    """The launcher's checks: one CUDA device and dtype; bfloat16, or with
    ``fp32`` also float32 (the routes with a 3xTF32 kernel)."""
    _build.validate(name, *tensors)
    if tensors[0].dtype == torch.bfloat16 or (fp32 and tensors[0].dtype == torch.float32):
        return
    takes = "bfloat16 or float32" if fp32 else "bfloat16"
    raise ValueError(f"{name}: the tensor-core route takes {takes}, got {tensors[0].dtype}")


class _Affine(NamedTuple):
    """The operands of a folded-BN conv, padded and aligned, its plan and its
    output (Cout padded to 8)."""

    xs: list
    w: torch.Tensor
    scale: torch.Tensor
    bias: torch.Tensor
    plan: TcPlan
    out: torch.Tensor


def _affine(name, xs, w, scale, bias, out_dtype, fp32: bool = False) -> _Affine:
    """``fp32``: the route also takes float32 (its plan then the fp32 one)."""
    _check_dtype(name, *xs, w, fp32=fp32)
    n, h, wd, _ = xs[0].shape
    cout8 = _ceil8(w.shape[3])
    xs, wp = _padded_sources(xs, w, cout8)
    return _Affine(xs, wp, _aligned(_pad_last(scale, cout8).contiguous()),
                   _aligned(_pad_last(bias, cout8).contiguous()),
                   tc_plan(n, h, wd, cout8, w.dtype == torch.float32),
                   torch.empty((n, h, wd, cout8), dtype=out_dtype, device=w.device))


def _unpadded(out, cout):
    return out if out.shape[3] == cout else out[..., :cout].contiguous()


def fused_conv3x3(x, w, scale, bias, apply_relu: bool) -> torch.Tensor:
    """[relu](conv3x3_same(x, w) * scale + bias) on the tensor cores, in bf16
    or in fp32 (3xTF32, the weights split per call: the concat conv's kernel
    with one source). x: [N,H,W,Cin], w: [3,3,Cin,Cout], both of one dtype;
    scale/bias fp32 [Cout]."""
    name = "fused_conv3x3_scale_relu"
    op = _affine(name, [x], w, scale, bias, x.dtype, fp32=True)
    n, h, wd, cin = op.xs[0].shape
    cout8 = op.out.shape[3]
    lib = _build.library()
    with _build.on_device(x):
        if x.dtype == torch.float32:
            wsplit = torch.empty((2, 9, cout8, cin), dtype=torch.float32, device=x.device)
            err = lib.tuk_tc_fused_conv3x3_f32(
                op.xs[0].data_ptr(), op.w.data_ptr(), wsplit.data_ptr(), op.scale.data_ptr(),
                op.bias.data_ptr(), op.out.data_ptr(), n, h, wd, cin, cout8, int(apply_relu),
                op.plan.cfg, op.plan.th, op.plan.tw, _build.stream(x))
        else:
            err = lib.tuk_tc_fused_conv3x3(
                op.xs[0].data_ptr(), op.w.data_ptr(), op.scale.data_ptr(), op.bias.data_ptr(),
                op.out.data_ptr(), n, h, wd, cin, cout8, int(apply_relu), op.plan.cfg,
                op.plan.th, op.plan.tw, _build.stream(x))
    _build.check(err, name)
    return _unpadded(op.out, w.shape[3])


def fused_conv3x3_concat(a, b, w, scale, bias, apply_relu: bool) -> torch.Tensor:
    """[relu](conv3x3_same(concat([a, b], -1), w) * scale + bias) on the
    tensor cores, in bf16 or in fp32 (3xTF32, the weights split per call),
    the concat never built: the kernel's K chunks are a's, then b's (weight
    rows Ca + 32 j, or Ca + 16 j in fp32). a: [N,H,W,Ca], b: [N,H,W,Cb], w:
    [3,3,Ca+Cb,Cout], all of one dtype; scale/bias fp32 [Cout]."""
    name = "fused_conv3x3_concat_scale_relu"
    op = _affine(name, [a, b], w, scale, bias, a.dtype, fp32=True)
    (ap, bp), (n, h, wd, _) = op.xs, a.shape
    cout8 = op.out.shape[3]
    lib = _build.library()
    with _build.on_device(a):
        if a.dtype == torch.float32:
            wsplit = torch.empty((2, 9, cout8, op.w.shape[2]), dtype=torch.float32,
                                 device=a.device)
            err = lib.tuk_tc_concat_conv3x3_f32(
                ap.data_ptr(), bp.data_ptr(), op.w.data_ptr(), wsplit.data_ptr(),
                op.scale.data_ptr(), op.bias.data_ptr(), op.out.data_ptr(), n, h, wd,
                ap.shape[3], bp.shape[3], cout8, int(apply_relu), op.plan.cfg, op.plan.th,
                op.plan.tw, _build.stream(a))
        else:
            err = lib.tuk_tc_concat_conv3x3(
                ap.data_ptr(), bp.data_ptr(), op.w.data_ptr(), op.scale.data_ptr(),
                op.bias.data_ptr(), op.out.data_ptr(), n, h, wd, ap.shape[3], bp.shape[3],
                cout8, int(apply_relu), op.plan.cfg, op.plan.th, op.plan.tw, _build.stream(a))
    _build.check(err, name)
    return _unpadded(op.out, w.shape[3])


def im2col_conv3x3(x, w, scale, bias, apply_relu: bool, out_dtype) -> torch.Tensor:
    """``im2col_conv3x3``'s function on the tensor cores: the K = 9·Cin
    contraction over w flattened to [9·Cin, Cout] (the HWIO layout), as the
    implicit GEMM of ``fused_conv3x3`` (K chunk-major, taps inside a chunk),
    in bf16 or in fp32 (3xTF32, the weights split per call). x: [N,H,W,Cin],
    w: [3,3,Cin,Cout], both of one dtype -> ``out_dtype`` (bf16, or fp32
    stored from the accumulators), from either input dtype."""
    name = "im2col_conv3x3"
    op = _affine(name, [x], w, scale, bias, out_dtype, fp32=True)
    n, h, wd, cin = op.xs[0].shape
    cout8 = op.out.shape[3]
    out_f32 = int(out_dtype == torch.float32)
    lib = _build.library()
    with _build.on_device(x):
        if x.dtype == torch.float32:
            wsplit = torch.empty((2, 9, cout8, cin), dtype=torch.float32, device=x.device)
            err = lib.tuk_tc_im2col_conv3x3_f32(
                op.xs[0].data_ptr(), op.w.data_ptr(), wsplit.data_ptr(), op.scale.data_ptr(),
                op.bias.data_ptr(), op.out.data_ptr(), n, h, wd, cin, cout8, int(apply_relu),
                out_f32, op.plan.cfg, op.plan.th, op.plan.tw, _build.stream(x))
        else:
            err = lib.tuk_tc_im2col_conv3x3(
                op.xs[0].data_ptr(), op.w.data_ptr(), op.scale.data_ptr(), op.bias.data_ptr(),
                op.out.data_ptr(), n, h, wd, cin, cout8, int(apply_relu), out_f32, op.plan.cfg,
                op.plan.th, op.plan.tw, _build.stream(x))
    _build.check(err, name)
    return _unpadded(op.out, w.shape[3])


def conv3x3_fwd(x, w, a, c, stats: bool):
    """z = conv3x3_same(relu(x*a + c) or x, w) on the tensor cores, in bf16 or
    in fp32 (3xTF32: the weights split per call into TF32 hi and lo planes,
    the activations in registers); with ``stats`` also the fp32 [2, Cout]
    (sum z, sum z^2) of the rounded z. a, c: fp32 [Cin] or None."""
    name = "conv3x3_fwd"
    _check_dtype(name, x, w, fp32=True)
    f32 = x.dtype == torch.float32
    n, h, wd, _ = x.shape
    cout = w.shape[3]
    cout8 = _ceil8(cout)
    xp, wp, ap, cp = _padded(x, w, cout8, (a, c))
    plan = tc_plan(n, h, wd, cout8, f32)
    z = torch.empty((n, h, wd, cout8), dtype=x.dtype, device=x.device)
    partials = st = None
    if stats:
        partials = torch.empty((plan.partial_rows, 2, cout8), dtype=torch.float32,
                               device=x.device)
        st = torch.empty((2, cout8), dtype=torch.float32, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = _build.library()
    with _build.on_device(x):
        if f32:
            wsplit = torch.empty((2, 9, cout8, xp.shape[3]), dtype=torch.float32, device=x.device)
            err = lib.tuk_tc_conv3x3_fwd_f32(
                xp.data_ptr(), ptr(ap), ptr(cp), wp.data_ptr(), wsplit.data_ptr(), z.data_ptr(),
                ptr(partials), ptr(st), n, h, wd, xp.shape[3], cout8, plan.cfg, plan.th, plan.tw,
                _build.stream(x))
        else:
            err = lib.tuk_tc_conv3x3_fwd(xp.data_ptr(), ptr(ap), ptr(cp), wp.data_ptr(),
                                         z.data_ptr(), ptr(partials), ptr(st), n, h, wd,
                                         xp.shape[3], cout8, plan.cfg, plan.th, plan.tw,
                                         _build.stream(x))
    _build.check(err, name)
    if cout8 != cout:
        z = z[..., :cout].contiguous()
        st = None if st is None else st[:, :cout].contiguous()
    return (z, st) if stats else z


def conv3x3_dx(g, z, coef, w, out_dtype) -> torch.Tensor:
    """dx = conv3x3_same(dz, flip(w)^T) on the tensor cores, dz = coef[0]*g +
    coef[1]*z + coef[2] built in shared memory. g, z: [N,H,W,C]; coef: fp32
    [3, C]; w: the forward weights [3,3,Cin,C] -> [N,H,W,Cin] in
    ``out_dtype``. bf16 (out bf16 or fp32): the weights flipped and
    transposed into a [3,3,C,Cin] copy. fp32 (out fp32, 3xTF32): the split
    reads w as it is, with its taps reversed (``tc_plan`` with f32)."""
    name = "conv3x3_dx"
    _check_dtype(name, g, z, w, fp32=True)
    f32 = g.dtype == torch.float32
    if f32 and out_dtype != torch.float32:
        raise ValueError(f"{name}: fp32 g gives an fp32 dx, not {out_dtype}")
    n, h, wd, ch = g.shape
    cin = w.shape[2]
    cin8, ch8 = _ceil8(cin), _ceil8(ch)
    plan = tc_plan(n, h, wd, cin8, f32)
    out = torch.empty((n, h, wd, cin8), dtype=out_dtype, device=g.device)
    lib = _build.library()
    # dx is the forward over dz with C input channels: zero channels of g, z
    # and coef give dz = 0 there. The padded operands are held here until the
    # launch returns.
    if f32:
        gp, zp, cf = (_aligned(_pad_last(t, ch8).contiguous()) for t in (g, z, coef))
        wp = _aligned(_pad_io(w, cin8, ch8).contiguous())
        wsplit = torch.empty((2, 9, cin8, ch8), dtype=torch.float32, device=g.device)
        with _build.on_device(g):
            err = lib.tuk_tc_conv3x3_dx_f32(gp.data_ptr(), zp.data_ptr(), cf.data_ptr(),
                                            wp.data_ptr(), wsplit.data_ptr(), out.data_ptr(), n,
                                            h, wd, ch8, cin8, plan.cfg, plan.th, plan.tw,
                                            _build.stream(g))
    else:
        wt = w.flip(0, 1).transpose(2, 3).contiguous()  # [3,3,C,Cin], small
        gp, wtp, zp, cf = _padded(g, wt, cin8, (z, coef))
        with _build.on_device(g):
            err = lib.tuk_tc_conv3x3_dx(gp.data_ptr(), zp.data_ptr(), cf.data_ptr(),
                                        wtp.data_ptr(), out.data_ptr(), n, h, wd, gp.shape[3],
                                        cin8, int(out_dtype == torch.float32), plan.cfg, plan.th,
                                        plan.tw, _build.stream(g))
    _build.check(err, name)
    return out if cin8 == cin else out[..., :cin].contiguous()


def conv3x3_dw(x, g, z, coef, a, c) -> torch.Tensor:
    """dw [3,3,Cin,Cout] fp32 on the tensor cores: the sum over N,H,W of
    prologue(x) patches times dz = coef[0]*g + coef[1]*z + coef[2], both built
    in shared memory. x: bf16 or fp32 (3xTF32, ``tc_dw_f32_kernel``)
    [N,H,W,Cin]; g, z: [N,H,W,Cout] of x's dtype; coef: fp32 [3, Cout]; a, c:
    fp32 [Cin] or None."""
    name = "conv3x3_dw"
    _check_dtype(name, x, g, z, fp32=True)
    f32 = x.dtype == torch.float32
    n, h, wd, cin = x.shape
    cout = g.shape[3]
    cin8, cout8 = _ceil8(cin), _ceil8(cout)
    if n * h * wd == 0:
        return torch.zeros((3, 3, cin, cout), dtype=torch.float32, device=x.device)
    if cin8 != cin:  # zero channels add zero, as in the Pallas kernel's Cin = 3
        x = _pad_last(x, cin8).contiguous()
        a, c = (None if v is None else _pad_last(v, cin8).contiguous() for v in (a, c))
    if cout8 != cout:
        g, z = _pad_last(g, cout8).contiguous(), _pad_last(z, cout8).contiguous()
        coef = _pad_last(coef, cout8).contiguous()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = dw_plan(n, h, wd, cin8, cout8, sms, f32)
    dw = torch.empty((3, 3, cin8, cout8), dtype=torch.float32, device=x.device)
    partials = None
    if plan.splits > 1:
        partials = torch.empty((plan.splits, 9, cin8, cout8), dtype=torch.float32,
                               device=x.device)
    # The aligned operands are held here until the launch returns: a copy
    # freed earlier could hand its block to the next one.
    ops = [None if t is None else _aligned(t) for t in (x, a, c, g, z, coef)]
    lib = _build.library()
    with _build.on_device(x):
        launch = lib.tuk_tc_conv3x3_dw_f32 if f32 else lib.tuk_tc_conv3x3_dw
        err = launch(*(None if t is None else t.data_ptr() for t in ops),
                     None if partials is None else partials.data_ptr(), dw.data_ptr(), n, h, wd,
                     cin8, cout8, plan.th, plan.tw, plan.tiles_per_split, plan.splits,
                     _build.stream(x))
    _build.check(err, name)
    return dw if (cin8, cout8) == (cin, cout) else dw[:, :, :cin, :cout].contiguous()


def _pad_io(w: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """HWIO weights zero-padded to ``rows`` input and ``cols`` output channels."""
    if w.shape[2:] == (rows, cols):
        return w
    return torch.nn.functional.pad(w, (0, cols - w.shape[3], 0, rows - w.shape[2]))


def double_conv(x, w1, s1, b1, w2, s2, b2, pool: bool):
    """relu(conv3x3_same(relu(conv3x3_same(x, w1)·s1 + b1), w2)·s2 + b2) on
    the tensor cores, in bf16 (mid rounded to bf16) or in fp32 (3xTF32, mid
    fp32, w1 and w2 split per call), mid kept in shared memory; with
    ``pool`` also its 2x2 / stride-2 max pool (floor mode) from the same
    epilogue. Returns (y, pooled or None). x: [N,H,W,Cin], w1:
    [3,3,Cin,Cmid], w2: [3,3,Cmid,Cout], all of one dtype; s*/b*: fp32. Cin
    is zero-padded to 8, Cmid to 32 in bf16 and 16 in fp32 (zero w1 columns,
    scale and bias give mid channels of relu(0) = 0, against zero w2 rows),
    Cout to 8."""
    name = "fused_double_conv"
    _check_dtype(name, x, w1, w2, fp32=True)
    f32 = x.dtype == torch.float32
    n, h, wd, cin = x.shape
    cmid, cout = w1.shape[3], w2.shape[3]
    kc = KC_F32 if f32 else KC
    cin8, cmidk, cout8 = _ceil8(cin), -(-cmid // kc) * kc, _ceil8(cout)
    xp = _aligned(_pad_last(x, cin8).contiguous())
    w1p, w2p = (_aligned(_pad_io(w, r, c).contiguous())
                for w, r, c in ((w1, cin8, cmidk), (w2, cmidk, cout8)))
    s1p, b1p = (_aligned(_pad_last(v, cmidk).contiguous()) for v in (s1, b1))
    s2p, b2p = (_aligned(_pad_last(v, cout8).contiguous()) for v in (s2, b2))
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = dc_plan(n, h, wd, cin8, cmidk, cout8, sms, f32)
    out = torch.empty((n, h, wd, cout8), dtype=x.dtype, device=x.device)
    pooled = (torch.empty((n, h // 2, wd // 2, cout8), dtype=x.dtype, device=x.device)
              if pool else None)
    ptr = None if pooled is None else pooled.data_ptr()
    lib = _build.library()
    with _build.on_device(x):
        if f32:
            w1s = torch.empty((2, 9, cmidk, cin8), dtype=torch.float32, device=x.device)
            w2s = torch.empty((2, 9, cout8, cmidk), dtype=torch.float32, device=x.device)
            err = lib.tuk_tc_double_conv_f32(
                xp.data_ptr(), w1p.data_ptr(), w1s.data_ptr(), s1p.data_ptr(), b1p.data_ptr(),
                w2p.data_ptr(), w2s.data_ptr(), s2p.data_ptr(), b2p.data_ptr(), out.data_ptr(),
                ptr, n, h, wd, cin8, cmidk, cout8, plan.th, plan.tw, _build.stream(x))
        else:
            err = lib.tuk_tc_double_conv(
                xp.data_ptr(), w1p.data_ptr(), s1p.data_ptr(), b1p.data_ptr(), w2p.data_ptr(),
                s2p.data_ptr(), b2p.data_ptr(), out.data_ptr(), ptr, n, h, wd, cin8, cmidk,
                cout8, plan.th, plan.tw, _build.stream(x))
    _build.check(err, name)
    return _unpadded(out, cout), None if pooled is None else _unpadded(pooled, cout)
