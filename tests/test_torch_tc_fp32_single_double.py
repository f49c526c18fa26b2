"""The fp32 tensor-core routes of ``fused_conv3x3_scale_relu`` and
``fused_double_conv`` in 3xTF32 (``tpu_unet_torch/kernels/tc_conv.py``
``fused_conv3x3``/``double_conv``/``dc_plan``; kernels in
``tpu_unet_torch/csrc/tc_conv.cu`` and ``csrc/tc_double_conv.cu``) on the
CPU, where the kernels cannot run:

- the fp32 double-conv plan: tiles the kernel takes (even, boxes TMA takes,
  at most DC_MI_MAX_F32 fragments a warp, the block within the 232,448
  bytes of shared memory) covering every pixel once, at the served shapes,
  Cmid 256 included, and the shared-memory sum of its worked example;
- the Python mirrors of the new constants match the source, and the new C
  entry points match their ctypes signatures (the CUDA-core ones are gone);
- numpy emulations of what the kernels compute, each in its own order: the
  single conv over the fp32 ``tc_plan``'s tiles, and the double conv per
  fp32 ``dc_plan`` tile (conv1 over the tile plus a 1-pixel halo from x's
  box with a 2-pixel zero halo, chunks of 16 channels with the 9 taps
  inside, per k8 step lo*hi + hi*lo + hi*hi into a fresh sum added to the
  accumulator, inc's zero second k8 step skipped; the fp32 mid zeroed
  outside the image; conv2 over the mid tile the same way; the 2x2 maxima
  of the output tile), against the plain versions and the JAX Pallas
  kernels in interpret mode, at Cin 3 and 8, odd H and W, Cmid past one
  pass and b1 > 0; two negative controls (mid not zeroed, one TF32 pass);
- meta tensors on recording launchers: fp32 single and double convs reach
  the tensor-core launchers and count ``.tc`` and ``.pool``, a failed
  launch counts nothing, a flagship fp32 forward makes 8 single, 4 concat
  and 3 double convs on the tensor cores, 3 pools in the double convs'
  epilogue and one ``max_pool2x2``; the launchers hand the C functions the
  fp32 plans and split buffers.

Tolerance, as ``chip_smoke.py`` holds the kernels: 1e-4 + 1e-4 * |ref| (the
same products to about 2^-21 each, summed in another order, over at most
9 * 256 terms a conv); pools exact (a max selects an input).
"""

import contextlib
import math
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from tests.test_torch_tc_conv import _Card
from tpu_unet.kernels.fused_conv import fused_conv3x3_scale_relu as j_conv
from tpu_unet.kernels.fused_double_conv import fused_double_conv as j_double_conv
from tpu_unet.kernels.pooling import max_pool2x2 as j_pool
from tpu_unet_torch import kernels as K
from tpu_unet_torch.kernels import _build, tc_conv
from tpu_unet_torch.kernels.fused_conv import fused_conv3x3_scale_relu_plain
from tpu_unet_torch.kernels.fused_double_conv import fused_double_conv_plain
from tpu_unet_torch.kernels.pooling import max_pool2x2_plain
from tpu_unet_torch.kernels.tc_conv import (
    DC_MAX_SMEM,
    DC_MI_MAX_F32,
    DC_STAGES_F32,
    DC_W_SLOT_F32,
    DC_WARPS,
    KC_F32,
    DcPlan,
    dc_plan,
    dc_smem,
    tc_plan,
)

F32 = torch.float32
ATOL = RTOL = 1e-4
SMS = 132  # the H100's SMs: the plan weighs waves on them
SERVED = [(1, 640, 959, 8, 64, 64), (1, 320, 479, 64, 128, 128), (1, 160, 239, 128, 256, 256)]


def _ceil(v, m):
    return -(-v // m) * m


# ---- the plan -------------------------------------------------------------

# (n, h, w, cin (padded to 8), cmid (a multiple of 16), cout): the served
# forward's three double convs at batch 1 and 8, the 572x572 shapes, and
# ragged small ones (Cmid 48 and 144: a partial 64-column half).
PLAN_SHAPES = SERVED + [
    (8, 640, 959, 8, 64, 64), (8, 320, 479, 64, 128, 128), (8, 160, 239, 128, 256, 256),
    (16, 572, 572, 8, 64, 64), (16, 286, 286, 64, 128, 128), (16, 143, 143, 128, 256, 256),
    (1, 13, 21, 8, 48, 8), (2, 7, 5, 8, 144, 72), (1, 1, 1, 8, 16, 8), (1, 3, 300, 16, 96, 200),
]


@pytest.mark.parametrize("n,h,w,cin,cmid,cout", PLAN_SHAPES)
def test_fp32_dc_plan_takes_tiles_the_kernel_takes_and_covers_every_pixel_once(n, h, w, cin,
                                                                             cmid, cout):
    p = dc_plan(n, h, w, cin, cmid, cout, SMS, True)
    assert p.th % 2 == 0 and p.tw % 2 == 0 and p.th >= 2 and p.tw >= 2
    assert p.th + 4 <= 256 and p.tw + 4 <= 256  # the staged box, each side
    assert p.smem == dc_smem(p.th, p.tw, cmid, cout, True) <= DC_MAX_SMEM
    for m, c in (((p.th + 2) * (p.tw + 2), cmid), (p.th * p.tw, cout)):  # conv1, conv2
        warps = DC_WARPS // 2 if c > 64 else DC_WARPS  # a 128-column pass's half
        assert math.ceil(math.ceil(m / 16) / warps) <= DC_MI_MAX_F32
    cover = np.zeros((h, w), np.int64)
    for t in range(p.tiles):
        h0, w0 = p.tile_origin(t)
        assert 0 <= h0 < h and 0 <= w0 < w
        cover[h0:h0 + p.th, w0:w0 + p.tw] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("n,h,w,cin,cmid,cout", SERVED, ids=["inc", "down1", "down2"])
def test_fp32_dc_plan_fits_shared_memory_at_the_served_shapes(n, h, w, cin, cmid, cout):
    """fp32 mid alone is Cmid / 16 slots of the (th+2)(tw+2) region, 64
    bytes a pixel; the fp32 output tile of a 128-column pass is th*tw*136*4
    bytes; the ring holds 3 k-steps of 16 KB."""
    p = dc_plan(n, h, w, cin, cmid, cout, SMS, True)
    assert p.smem <= DC_MAX_SMEM == 232448
    mid = cmid // KC_F32 * (p.th + 2) * (p.tw + 2) * 64
    out_tile = p.th * p.tw * ((128 if cout > 64 else 64) + 8) * 4
    assert p.smem >= mid + out_tile + DC_STAGES_F32 * DC_W_SLOT_F32


def test_fp32_dc_smem_matches_its_worked_example():
    """6 x 14 at Cmid 256: 16 mid slots of 8 KB, the output tile 46,080
    bytes, 3 weight k-steps of 16 KB, 1,024 of alignment and 5 barriers:
    227,368 bytes. A fourth k-step and its barrier (243,760) would not fit."""
    assert dc_smem(6, 14, 256, 256, True) == 227368
    assert dc_smem(6, 14, 256, 256, True) + DC_W_SLOT_F32 + 8 == 243760 > DC_MAX_SMEM


# ---- the source -------------------------------------------------------------


def _dc_const(src, name):
    return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1).split("//")[0].strip()


def test_python_mirrors_of_the_fp32_double_conv_constants_match_the_source():
    src = (_build.CSRC_DIR / "tc_double_conv.cu").read_text()
    common = (_build.CSRC_DIR / "tc_common.cuh").read_text()
    kc = re.search(r"struct Tf32x3Op \{[^}]*static constexpr int KC = (\d+);", common)
    assert int(kc.group(1)) == KC_F32 == 16
    assert int(_dc_const(src, "MI_MAX_F32")) == DC_MI_MAX_F32
    assert int(_dc_const(src, "STAGES_F32")) == DC_STAGES_F32
    assert _dc_const(src, "F32_PLANE") == "64 * KC_F32 * 4"
    assert _dc_const(src, "W_SLOT_F32") == "2 * 2 * F32_PLANE"
    assert DC_W_SLOT_F32 == 2 * 2 * 64 * KC_F32 * 4 == 16384
    assert "template <class Op, int MI1, int MI2>" in src  # one kernel for both dtypes
    assert "dc::launch<Tf32x3Op>" in src and "dc::launch<Bf16Op>" in src


def test_fp32_single_and_double_conv_c_interfaces_match_the_ctypes_signatures():
    for file, name in (("tc_conv.cu", "tuk_tc_fused_conv3x3_f32"),
                       ("tc_double_conv.cu", "tuk_tc_double_conv_f32")):
        src = (_build.CSRC_DIR / file).read_text()
        head = f'extern "C" int {name}('
        assert head in src, name
        params = src.split(head, 1)[1].split(")", 1)[0]
        assert params.count(",") + 1 == len(_build._SIGNATURES[name][0]), name
        assert all(t is _build._P for t in _build._SIGNATURES[name][0][:3]), name


def test_the_cuda_core_single_and_double_convs_are_gone():
    names = {p.name for p in _build.sources()}
    assert not names & {"fused_conv.cu", "fused_double_conv.cu"}
    text = "".join(p.read_text() for p in _build.sources())
    for name in ("tuk_conv3x3(", "tuk_double_conv(", "tuk_double_conv_smem", "accum_chunk"):
        assert name not in text, name
    assert not {"tuk_conv3x3", "tuk_double_conv", "tuk_double_conv_smem"} & set(_build._SIGNATURES)


# ---- emulations -------------------------------------------------------------


def _tf32(v: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: fp32 rounded to 10 mantissa bits, half away from
    zero (half of the 13 dropped bits' unit added to the sign-magnitude
    pattern)."""
    u = np.ascontiguousarray(v, np.float32).view(np.int32)
    return ((u + 0x1000) & np.int32(-0x2000)).view(np.float32)


def _mm3(a: np.ndarray, b: np.ndarray, passes: int = 3) -> np.ndarray:
    """a @ b as a k8 step sums it: lo*hi + hi*lo + hi*hi into a fresh fp32
    sum (``passes=1``: hi*hi alone, one TF32 pass)."""
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _conv_tile(src, w, m_rows, m_cols, k_valid, passes=3):
    """One tile's implicit GEMM: src is the staged region (rows + 2, cols +
    2, K) whose 9 shifted windows are the taps, w [9, K, N]; chunk-major
    over 16 channels, 9 taps inside, two k8 steps a tap (the second skipped
    where the chunk holds k_valid - k0 <= 8 channels: inc's zeros)."""
    kin = src.shape[2]
    acc = np.zeros((m_rows * m_cols, w.shape[2]), np.float32)
    for k0 in range(0, kin, KC_F32):
        for tap in range(9):
            ky, kx = divmod(tap, 3)
            win = src[ky:ky + m_rows, kx:kx + m_cols, k0:k0 + KC_F32].reshape(-1, KC_F32)
            for k8 in (0, 8):
                if k8 and k_valid - k0 <= 8:
                    continue
                acc = acc + _mm3(win[:, k8:k8 + 8], w[tap, k0 + k8:k0 + k8 + 8], passes)
    return acc


def _affine_relu(acc, s, b):
    """relu(acc * s + b): fp32 multiply, then add, separately rounded."""
    return np.maximum((acc * s).astype(np.float32) + b, np.float32(0))


def _emulate_single(x, w, s, b):
    """What tuk_tc_fused_conv3x3_f32 computes: the fp32 tc_plan's tiles, each
    staged with a 1-pixel zero halo, K = 9 x Cin chunk-major, then relu(acc
    * s + b)."""
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    p = tc_plan(n, h, wd, _ceil(cout, 8), True)
    kin = _ceil(_ceil(cin, 8), KC_F32)
    xh = np.pad(x, ((0, 0), (1, 1 + p.tiles_h * p.th - h), (1, 1 + p.tiles_w * p.tw - wd),
                    (0, kin - cin)))
    wf = np.pad(w, ((0, 0), (0, 0), (0, kin - cin), (0, 0))).reshape(9, kin, cout)
    out = np.zeros((n, p.tiles_h * p.th, p.tiles_w * p.tw, cout), np.float32)
    for bi in range(n):
        for t in range(p.tiles):
            h0, w0 = p.tile_origin(t)
            src = xh[bi, h0:h0 + p.th + 2, w0:w0 + p.tw + 2]
            acc = _conv_tile(src, wf, p.th, p.tw, _ceil(cin, 8))
            out[bi, h0:h0 + p.th, w0:w0 + p.tw] = _affine_relu(acc, s, b).reshape(p.th, p.tw, -1)
    return out[:, :h, :wd]


def _emulate_double(x, w1, s1, b1, w2, s2, b2, plan=None, zero_outside=True, passes=3):
    """What tuk_tc_double_conv_f32 computes, per dc_plan tile: conv1 over the
    (th+2) x (tw+2) mid region from x's box at (h0-2, w0-2), mid = relu(acc *
    s1 + b1) in fp32, 0 outside the image (``zero_outside=False``: what the
    kernel must not do), conv2 over the mid tile, the output tile and its
    2x2 maxima. Returns (y, pooled)."""
    n, h, wd, cin = x.shape
    cmid, cout = w1.shape[3], w2.shape[3]
    cin8, cmid16, cout8 = _ceil(cin, 8), _ceil(cmid, KC_F32), _ceil(cout, 8)
    p = plan or dc_plan(n, h, wd, cin8, cmid16, cout8, SMS, True)
    th, tw = p.th, p.tw
    k1 = _ceil(cin8, KC_F32)
    xs = np.pad(x, ((0, 0), (2, 2 + p.tiles_h * th - h), (2, 2 + p.tiles_w * tw - wd),
                    (0, k1 - cin)))
    w1f = np.pad(w1, ((0, 0), (0, 0), (0, k1 - cin), (0, cmid16 - cmid))).reshape(9, k1, cmid16)
    w2f = np.pad(w2, ((0, 0), (0, 0), (0, cmid16 - cmid), (0, cout8 - cout))).reshape(
        9, cmid16, cout8)
    s1f, b1f = (np.pad(v, (0, cmid16 - cmid)) for v in (s1, b1))
    s2f, b2f = (np.pad(v, (0, cout8 - cout)) for v in (s2, b2))
    y = np.zeros((n, p.tiles_h * th, p.tiles_w * tw, cout8), np.float32)
    rows = np.arange(th + 2)[:, None]
    cols = np.arange(tw + 2)[None, :]
    for bi in range(n):
        for t in range(p.tiles):
            h0, w0 = p.tile_origin(t)
            src = xs[bi, h0:h0 + th + 4, w0:w0 + tw + 4]
            mid = _affine_relu(_conv_tile(src, w1f, th + 2, tw + 2, cin8, passes), s1f, b1f)
            mid = mid.reshape(th + 2, tw + 2, cmid16)
            if zero_outside:
                gh, gw = h0 - 1 + rows, w0 - 1 + cols
                mid = np.where(((gh >= 0) & (gh < h) & (gw >= 0) & (gw < wd))[..., None], mid,
                               np.float32(0))
            acc = _conv_tile(mid, w2f, th, tw, cmid16, passes)
            y[bi, h0:h0 + th, w0:w0 + tw] = _affine_relu(acc, s2f, b2f).reshape(th, tw, cout8)
    y = y[:, :h, :wd, :cout]
    # the pool of each tile's own output: tiles are even, so its 2x2
    # windows are the image's
    h2, w2_ = h // 2 * 2, wd // 2 * 2
    q = y[:, :h2, :w2_].reshape(n, h // 2, 2, wd // 2, 2, cout)
    pooled = np.maximum(np.maximum(q[:, :, 0, :, 0], q[:, :, 1, :, 0]),
                        np.maximum(q[:, :, 0, :, 1], q[:, :, 1, :, 1]))
    return y, pooled


def _args(rng, n, h, w, cin, cmid, cout, bias1=0.5):
    """fp32 x, w1, s1, b1, w2, s2, b2 as numpy; b1 >= ``bias1`` > 0, so
    relu(conv1) is not zero where conv1 is evaluated outside the image."""
    f = np.float32
    return (rng.standard_normal((n, h, w, cin)).astype(f),
            (rng.standard_normal((3, 3, cin, cmid)) * (9 * cin) ** -0.5).astype(f),
            (1.0 + 0.2 * rng.standard_normal(cmid)).astype(f),
            (bias1 + 0.3 * rng.random(cmid)).astype(f),
            (rng.standard_normal((3, 3, cmid, cout)) * (9 * cmid) ** -0.5).astype(f),
            (1.0 + 0.2 * rng.standard_normal(cout)).astype(f),
            (0.2 * rng.standard_normal(cout)).astype(f))


def _close(got, ref):
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), atol=ATOL, rtol=RTOL)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# (n, h, w, cin, cmid, cout): inc (Cin 3: one 16-channel chunk, second k8
# step skipped), Cin 8, odd H and W no tile divides, Cmid 48 (a partial
# 64-column half), Cmid 144 and Cout 136 (two passes in both phases).
EMU_CASES = [(1, 13, 21, 3, 32, 16), (2, 11, 9, 8, 48, 8), (1, 9, 15, 8, 144, 136),
             (1, 17, 7, 3, 64, 64)]


@pytest.mark.parametrize("n,h,w,cin,cmid,cout", EMU_CASES)
def test_emulated_fp32_double_conv_matches_the_plain_version(rng, n, h, w, cin, cmid, cout):
    args = _args(rng, n, h, w, cin, cmid, cout)
    y, pooled = _emulate_double(*args)
    ry, rp = fused_double_conv_plain(*map(_t, args), pool=True)
    assert y.shape == (n, h, w, cout) and pooled.shape == tuple(rp.shape)
    _close(y, ry.numpy())
    np.testing.assert_array_equal(pooled, max_pool2x2_plain(_t(y)).numpy())


@pytest.mark.parametrize("th,tw", [(2, 2), (2, 6), (4, 4)])
def test_emulated_fp32_double_conv_matches_on_small_tiles(rng, th, tw):
    """Many tiles, so that tile seams and every image border meet the mid
    halo."""
    h, w = 11, 13
    plan = DcPlan(th, tw, math.ceil(h / th), math.ceil(w / tw), 1,
                  dc_smem(th, tw, 32, 8, True))
    args = _args(rng, 1, h, w, 8, 32, 8)
    y, pooled = _emulate_double(*args, plan=plan)
    _close(y, fused_double_conv_plain(*map(_t, args)).numpy())
    np.testing.assert_array_equal(pooled, max_pool2x2_plain(_t(y)).numpy())


def test_fp32_mid_outside_the_image_must_be_zero(rng):
    """Without zeroing mid outside the image, with b1 > 0, the emulation is
    far from the plain version at the borders and agrees inside."""
    args = _args(rng, 1, 13, 21, 8, 32, 16)
    y, _ = _emulate_double(*args, zero_outside=False)
    ref = fused_double_conv_plain(*map(_t, args)).numpy()
    assert (np.abs(y - ref) > ATOL + RTOL * np.abs(ref)).any()
    _close(y[:, 1:-1, 1:-1], ref[:, 1:-1, 1:-1])


def test_one_tf32_pass_breaks_the_fp32_tolerance(rng):
    """hi*hi alone (one TF32 pass, about 2^-11 a product) leaves the fp32
    tolerance of the double conv at Cmid 256: why the kernel takes three."""
    args = _args(rng, 1, 6, 10, 64, 256, 64)
    ref = fused_double_conv_plain(*map(_t, args)).numpy()
    y1, _ = _emulate_double(*args, passes=1)
    y3, _ = _emulate_double(*args)
    assert (np.abs(y1 - ref) > ATOL + RTOL * np.abs(ref)).any()
    _close(y3, ref)


def _jnp(a):
    return jnp.asarray(a)


@pytest.mark.parametrize("n,h,w,cin,cmid,cout", [(1, 13, 21, 3, 32, 16), (1, 10, 17, 8, 48, 64)])
def test_emulated_fp32_double_conv_and_pool_match_pallas(rng, n, h, w, cin, cmid, cout):
    """fp32 against the Pallas kernels in interpret mode: the double conv,
    and its pool (odd W) against JAX's max_pool2x2 on JAX's output."""
    args = _args(rng, n, h, w, cin, cmid, cout)
    y, pooled = _emulate_double(*args)
    with pltpu.force_tpu_interpret_mode():
        jy = j_double_conv(*map(_jnp, args))
        jp = j_pool(jy)
    _close(y, np.asarray(jy))
    _close(pooled, np.asarray(jp))


@pytest.mark.parametrize("n,h,w,cin,cout", [(1, 13, 20, 3, 64), (2, 9, 11, 24, 72),
                                            (1, 6, 7, 136, 16)])
def test_emulated_fp32_single_conv_matches_the_plain_version_and_pallas(rng, n, h, w, cin,
                                                                       cout):
    x, wt, s, b, *_ = _args(rng, n, h, w, cin, cout, 8)
    b = (0.2 * rng.standard_normal(cout)).astype(np.float32)
    s = (1.0 + 0.2 * rng.standard_normal(cout)).astype(np.float32)
    y = _emulate_single(x, wt, s, b)
    _close(y, fused_conv3x3_scale_relu_plain(_t(x), _t(wt), _t(s), _t(b)).numpy())
    with pltpu.force_tpu_interpret_mode():
        jy = j_conv(_jnp(x), _jnp(wt), _jnp(s), _jnp(b))
    _close(y, np.asarray(jy))


# ---- routing and counts -------------------------------------------------------


@pytest.fixture
def card(monkeypatch):
    K.reset_launch_counts()
    yield _Card(monkeypatch)
    K.reset_launch_counts()


def _meta_dc(cin=3, cmid=64, cout=64):
    x = torch.empty(1, 9, 13, cin, device="meta")
    w1 = torch.empty(3, 3, cin, cmid, device="meta")
    w2 = torch.empty(3, 3, cmid, cout, device="meta")
    return x, w1, torch.ones(cmid), torch.zeros(cmid), w2, torch.ones(cout), torch.zeros(cout)


def test_fp32_single_and_double_convs_count_tensor_core_launches(card):
    """On meta tensors standing in for CUDA ones: the fp32 single conv and
    the unpooled fp32 double conv reach their tensor-core launchers and
    count ``.tc``, the double conv no ``.pool``; none reaches the CUDA-core
    library (the pooled fp32 double conv's counts:
    test_torch_tc_double_conv.py)."""
    x = torch.empty(1, 5, 6, 8, device="meta")
    w = torch.empty(3, 3, 8, 16, device="meta")
    y = K.fused_conv3x3_scale_relu(x, w, torch.ones(16), torch.zeros(16))
    assert y.shape == (1, 5, 6, 16) and y.dtype == F32
    y = K.fused_double_conv(*_meta_dc())
    assert y.shape == (1, 9, 13, 64) and y.dtype == F32
    counts = {k: v for k, v in K.launch_counts().items() if v}
    assert card.tc == ["fused_conv3x3_scale_relu", "fused_double_conv"] and card.lib == []
    assert counts == {"fused_conv3x3_scale_relu": 1, "fused_conv3x3_scale_relu.tc": 1,
                      "fused_double_conv": 1, "fused_double_conv.tc": 1}


def test_a_failed_fp32_single_or_double_conv_launch_counts_nothing(card):
    card.fail = True
    x = torch.empty(1, 5, 6, 8, device="meta")
    w = torch.empty(3, 3, 8, 16, device="meta")
    with pytest.raises(RuntimeError, match="launch failed"):
        K.fused_conv3x3_scale_relu(x, w, torch.ones(16), torch.zeros(16))
    for pool in (False, True):
        with pytest.raises(RuntimeError, match="launch failed"):
            K.fused_double_conv(*_meta_dc(), pool=pool)
    assert card.lib == []  # no retreat to a CUDA-core kernel or the pool kernel
    assert all(v == 0 for v in K.launch_counts().values())


def test_a_flagship_fp32_forward_runs_every_conv_on_the_tensor_cores(card):
    """The fp32 folded forward's launches, as chip_smoke.py's phase 4 holds
    them: 8 single, 4 concat and 3 double convs, all ``.tc``, the double
    convs writing 3 of the 4 pools, one max_pool2x2 (after down3)."""
    from tpu_unet_torch.models import UNetConfig, fold_bn, init_unet, unet_infer_apply
    from tpu_unet_torch.models.unet import tree_map

    cfg = UNetConfig(3, 1, base_channels=64)  # the flagship: down3 and down4 are not fused
    params, state = init_unet(cfg, np.random.default_rng(0))
    folded = tree_map(lambda t: t.to("meta"), fold_bn(params, state, cfg))
    out = unet_infer_apply(folded, torch.empty(1, 48, 37, 3, device="meta"), config=cfg,
                           backend="cuda")
    assert out.shape == (1, 48, 37, 1) and out.dtype == F32
    counts = {k: v for k, v in K.launch_counts().items() if v}
    assert counts == {"fused_double_conv": 3, "fused_double_conv.tc": 3,
                      "fused_double_conv.pool": 3, "max_pool2x2": 1,
                      "fused_conv3x3_scale_relu": 8, "fused_conv3x3_scale_relu.tc": 8,
                      "fused_conv3x3_concat_scale_relu": 4,
                      "fused_conv3x3_concat_scale_relu.tc": 4}
    assert card.lib == ["tuk_max_pool2x2"]


class _Recorder:
    """The C library: records each call's arguments, launches nothing."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.fixture
def lib(monkeypatch):
    rec = _Recorder()

    class Props:
        multi_processor_count = SMS

    monkeypatch.setattr(_build, "validate", lambda kernel, *tensors: _build.DTYPE_F32)
    monkeypatch.setattr(_build, "library", lambda: rec)
    monkeypatch.setattr(_build, "stream", lambda t: 0)
    monkeypatch.setattr(_build, "on_device", lambda t: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d: Props)
    return rec


def test_fp32_single_conv_launcher_passes_the_fp32_plan_and_a_split_buffer(lib):
    """tuk_tc_fused_conv3x3_f32 gets every argument of its signature: x, w,
    a split buffer, scale, bias and the output (all distinct), Cin and Cout
    padded to 8, the ReLU flag and the fp32 plan."""
    x = torch.zeros(2, 13, 20, 3)
    y = tc_conv.fused_conv3x3(x, torch.zeros(3, 3, 3, 20), torch.ones(20), torch.zeros(20),
                              False)
    (name, args), = lib.calls
    assert name == "tuk_tc_fused_conv3x3_f32"
    assert len(args) == len(_build._SIGNATURES[name][0])
    assert len(set(args[:6])) == 6 and None not in args[:6]
    p = tc_plan(2, 13, 20, 24, True)
    assert args[6:] == (2, 13, 20, 8, 24, 0, p.cfg, p.th, p.tw, 0)
    assert y.shape == (2, 13, 20, 20) and y.dtype == F32


@pytest.mark.parametrize("pool", [False, True], ids=["y", "pool"])
def test_fp32_double_conv_launcher_passes_the_fp32_plan_and_split_buffers(lib, pool):
    """tuk_tc_double_conv_f32 gets x, w1, its split buffer, s1, b1, w2, its
    split buffer, s2, b2 and the output (all distinct), the pooled output or
    None, Cin padded to 8, Cmid to 16 (not 32, as bf16), Cout to 8, and the
    fp32 dc_plan's tile."""
    x = torch.zeros(1, 9, 13, 3)
    w1, w2 = torch.zeros(3, 3, 3, 40), torch.zeros(3, 3, 40, 20)
    y, pooled = tc_conv.double_conv(x, w1, torch.ones(40), torch.zeros(40), w2, torch.ones(20),
                                    torch.zeros(20), pool)
    (name, args), = lib.calls
    assert name == "tuk_tc_double_conv_f32"
    assert len(args) == len(_build._SIGNATURES[name][0])
    assert len(set(args[:10])) == 10 and None not in args[:10]
    assert (args[10] is None) == (not pool)
    p = dc_plan(1, 9, 13, 8, 48, 24, SMS, True)
    assert args[11:] == (1, 9, 13, 8, 48, 24, p.th, p.tw, 0)
    assert y.shape == (1, 9, 13, 20) and (pooled is None) == (not pool)
    if pool:
        assert pooled.shape == (1, 4, 6, 20) and pooled.dtype == F32
