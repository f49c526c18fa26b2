"""The bf16 tensor-core route of ``fused_double_conv`` with the encoder pool
folded into its epilogue (``tpu_unet_torch/kernels/tc_conv.py``
``double_conv``/``dc_plan``, kernel ``tpu_unet_torch/csrc/tc_double_conv.cu``)
on the CPU, where the kernel cannot run:

- the tile plan: even tiles, staged boxes TMA takes, fragments the warps
  hold and shared memory a block may use at the served shapes, every output
  pixel covered once;
- a plain PyTorch emulation of what the kernel computes (per tile: conv1
  over the tile plus a 1-pixel halo from x's box with a 2-pixel zero halo,
  chunk-major with the 9 taps inside, mid rounded to bf16 and zeroed outside
  the image, then conv2 over the mid tile the same way, the 2x2 maxima of
  the rounded output tile) against the plain versions and the JAX Pallas
  kernels in interpret mode, at Cin 3 and 8, odd H and W that no tile
  divides, b1 > 0 (relu(b1) > 0 where conv1 is evaluated outside the
  image);
- the C interface, the constants the Python side mirrors, refusals, and the
  ``.tc`` and pooled counts with recording launchers on meta tensors.

Tolerances, |emulation - plain| <= atol + rtol * |plain|: bf16 2e-2 + 2e-2
(both sum exact products in fp32 and round mid and the output once each, so
an output may differ by about one bf16 ulp, more where a one-ulp flip of mid
propagates), fp32 1e-4 + 1e-4 (summation order only); the same TOL as
chip_smoke.py holds the kernel to. Pools exact: a max selects an input.
"""

import math
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from tpu_unet.kernels.fused_double_conv import fused_double_conv as j_double_conv
from tpu_unet.kernels.pooling import max_pool2x2 as j_pool
from tpu_unet_torch import kernels as K
from tpu_unet_torch.kernels import _build, tc_conv
from tpu_unet_torch.kernels.fused_double_conv import fused_double_conv_plain
from tpu_unet_torch.kernels.pooling import max_pool2x2_plain
from tests.test_torch_tc_conv import _Card
from tpu_unet_torch.kernels.tc_conv import (
    DC_MAX_SMEM,
    DC_MI_MAX,
    DC_STAGES,
    DC_W_SLOT,
    DC_WARPS,
    KC,
    DcPlan,
    dc_plan,
    dc_smem,
)

BF = torch.bfloat16
TOL = {torch.float32: (1e-4, 1e-4), BF: (2e-2, 2e-2)}
H100_SMS = 132

# (n, h, w, cin (padded to 8), cmid, cout): the served forward's three
# double convs, at batch 1 and 8, the 572x572 shapes and ragged small ones.
PLAN_SHAPES = [
    (1, 640, 959, 8, 64, 64), (1, 320, 479, 64, 128, 128), (1, 160, 239, 128, 256, 256),
    (8, 640, 959, 8, 64, 64), (8, 320, 479, 64, 128, 128), (8, 160, 239, 128, 256, 256),
    (16, 572, 572, 8, 64, 64), (16, 286, 286, 64, 128, 128), (16, 143, 143, 128, 256, 256),
    (1, 13, 21, 8, 32, 8), (2, 7, 5, 8, 64, 72), (1, 1, 1, 8, 32, 8), (1, 3, 300, 16, 96, 200),
]


def _ceil(v, m):
    return -(-v // m) * m


@pytest.mark.parametrize("n,h,w,cin,cmid,cout", PLAN_SHAPES)
def test_dc_plan_takes_tiles_the_kernel_takes_and_covers_every_pixel_once(n, h, w, cin, cmid,
                                                                        cout):
    p = dc_plan(n, h, w, cin, cmid, cout, H100_SMS)
    assert p.th % 2 == 0 and p.tw % 2 == 0 and p.th >= 2 and p.tw >= 2
    assert p.th + 4 <= 256 and p.tw + 4 <= 256  # the staged box, each side
    assert p.smem == dc_smem(p.th, p.tw, cmid, cout) <= DC_MAX_SMEM
    for m, c in (((p.th + 2) * (p.tw + 2), cmid), (p.th * p.tw, cout)):  # conv1, conv2
        warps = DC_WARPS // 2 if c > 64 else DC_WARPS  # a 128-column pass's half
        assert math.ceil(math.ceil(m / 16) / warps) <= DC_MI_MAX
    cover = np.zeros((h, w), np.int64)
    for t in range(p.tiles):
        h0, w0 = p.tile_origin(t)
        assert 0 <= h0 < h and 0 <= w0 < w  # no tile lies wholly outside
        cover[h0:h0 + p.th, w0:w0 + p.tw] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("cmid", [64, 128, 256])
@pytest.mark.parametrize("shape", [(1, 640, 959, 8), (1, 320, 479, 64), (1, 160, 239, 128)],
                         ids=["inc", "down1", "down2"])
def test_dc_plan_fits_shared_memory_at_the_served_shapes(shape, cmid):
    p = dc_plan(*shape, cmid, cmid, H100_SMS)
    assert p.smem <= DC_MAX_SMEM
    # mid alone: Cmid / 32 slots of the (th+2)(tw+2) region, 64 bytes a pixel
    assert p.smem > cmid // KC * (p.th + 2) * (p.tw + 2) * 64


def test_16x16_tiles_do_not_fit_at_cmid_256():
    """The mid tile of a 16 x 16 tile at Cmid = 256 takes 168 KB: with the
    rings it passes the 227 KB a block may use, so the plan takes another."""
    assert dc_smem(16, 16, 256, 256) > DC_MAX_SMEM
    assert (dc_plan(1, 160, 239, 128, 256, 256, H100_SMS).th,
            dc_plan(1, 160, 239, 128, 256, 256, H100_SMS).tw) != (16, 16)


def _emulate(x, w1, s1, b1, w2, s2, b2, plan: DcPlan | None = None, zero_outside: bool = True):
    """What tc_double_conv.cu computes, in plain PyTorch at fp32 on the given
    (possibly bf16) values, rounding where the kernel rounds (mid and the
    output, to x's dtype). Returns (y, pooled). ``zero_outside=False`` keeps
    relu(conv1) on mid pixels outside the image (what the kernel must not
    do)."""
    dt = x.dtype
    n, h, wd, cin = x.shape
    cmid, cout = w1.shape[3], w2.shape[3]
    cin8, cmid32, cout8 = _ceil(cin, 8), _ceil(cmid, 32), _ceil(cout, 8)
    p = plan or dc_plan(n, h, wd, cin8, cmid32, cout8, H100_SMS)
    th, tw = p.th, p.tw
    k1 = _ceil(cin8, KC)  # x's chunks: the map's fill past cin8 reads zeros
    # x with a 2-pixel zero halo (the fill outside the image), out to the
    # tiles' extent.
    xs = F.pad(x.float(), (0, k1 - cin, 2, 2 + p.tiles_w * tw - wd, 2, 2 + p.tiles_h * th - h))
    w1f = F.pad(w1.float(), (0, cmid32 - cmid, 0, k1 - cin)).reshape(9, k1, cmid32)
    w2f = F.pad(w2.float(), (0, cout8 - cout, 0, cmid32 - cmid)).reshape(9, cmid32, cout8)
    s1f, b1f = (F.pad(v.float(), (0, cmid32 - cmid)) for v in (s1, b1))
    s2f, b2f = (F.pad(v.float(), (0, cout8 - cout)) for v in (s2, b2))
    y = torch.zeros(n, p.tiles_h * th, p.tiles_w * tw, cout8, dtype=dt)
    pooled = torch.zeros(n, p.tiles_h * th // 2, p.tiles_w * tw // 2, cout8, dtype=dt)
    rows = torch.arange(th + 2)[:, None]
    cols = torch.arange(tw + 2)[None, :]
    for b in range(n):
        for t in range(p.tiles):
            h0, w0 = p.tile_origin(t)
            # Phase 1: mid pixel (r, c) lies at (h0 - 1 + r, w0 - 1 + c); tap
            # (ky, kx) reads x's box (origin h0 - 2, w0 - 2) at (r + ky, c + kx).
            acc = torch.zeros((th + 2) * (tw + 2), cmid32)
            for k0 in range(0, k1, KC):
                for tap in range(9):
                    ky, kx = divmod(tap, 3)
                    win = xs[b, h0 + ky:h0 + ky + th + 2, w0 + kx:w0 + kx + tw + 2, k0:k0 + KC]
                    acc += win.reshape(-1, KC) @ w1f[tap, k0:k0 + KC]
            mid = torch.relu(acc * s1f + b1f).to(dt).float().reshape(th + 2, tw + 2, cmid32)
            if zero_outside:
                gh, gw = h0 - 1 + rows, w0 - 1 + cols
                inside = (gh >= 0) & (gh < h) & (gw >= 0) & (gw < wd)
                mid = mid * inside[..., None]
            # Phase 2: the mid slots as 9 shifted windows, chunk-major.
            acc = torch.zeros(th * tw, cout8)
            for k0 in range(0, cmid32, KC):
                for tap in range(9):
                    ky, kx = divmod(tap, 3)
                    win = mid[ky:ky + th, kx:kx + tw, k0:k0 + KC]
                    acc += win.reshape(-1, KC) @ w2f[tap, k0:k0 + KC]
            tile = torch.relu(acc * s2f + b2f).to(dt).reshape(th, tw, cout8)
            y[b, h0:h0 + th, w0:w0 + tw] = tile
            # the 2x2 maxima of the output tile it holds
            pooled[b, h0 // 2:(h0 + th) // 2, w0 // 2:(w0 + tw) // 2] = \
                max_pool2x2_plain(tile[None])[0]
    return (y[:, :h, :wd, :cout].contiguous(),
            pooled[:, :h // 2, :wd // 2, :cout].contiguous())


def _args(rng, n, h, w, cin, cmid, cout, dtype, bias1=0.5):
    """x, w1, s1, b1, w2, s2, b2; b1 >= ``bias1`` > 0, so relu(conv1) is
    not zero where conv1 is evaluated outside the image."""
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    x = t(rng.standard_normal((n, h, w, cin))).to(dtype)
    w1 = t(rng.standard_normal((3, 3, cin, cmid)) * (9 * cin) ** -0.5).to(dtype)
    w2 = t(rng.standard_normal((3, 3, cmid, cout)) * (9 * cmid) ** -0.5).to(dtype)
    s1, s2 = t(1.0 + 0.2 * rng.standard_normal(cmid)), t(1.0 + 0.2 * rng.standard_normal(cout))
    b1, b2 = t(bias1 + 0.3 * rng.random(cmid)), t(0.2 * rng.standard_normal(cout))
    return x, w1, s1, b1, w2, s2, b2


def _close(got, ref, dtype):
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)


# (n, h, w, cin, cmid, cout): Cin 3 (inc, padded to 8) and 8, odd H and W
# that no tile divides, Cmid past one 64-channel pass, Cout past one
# 128-channel pass and not a multiple of 64.
EMU_CASES = [(1, 13, 21, 3, 32, 16), (2, 11, 9, 8, 64, 8), (1, 9, 15, 8, 96, 136),
             (1, 17, 7, 3, 64, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["fp32", "bf16"])
@pytest.mark.parametrize("n,h,w,cin,cmid,cout", EMU_CASES)
def test_emulated_double_conv_matches_the_plain_version(rng, n, h, w, cin, cmid, cout, dtype):
    args = _args(rng, n, h, w, cin, cmid, cout, dtype)
    y, pooled = _emulate(*args)
    ry, rp = fused_double_conv_plain(*args, pool=True)
    assert y.dtype == dtype and y.shape == (n, h, w, cout) and pooled.shape == rp.shape
    _close(y, ry, dtype)
    torch.testing.assert_close(pooled, max_pool2x2_plain(y), atol=0, rtol=0)


@pytest.mark.parametrize("th,tw", [(2, 2), (2, 6), (4, 4)])
def test_emulated_double_conv_matches_on_small_tiles(rng, th, tw):
    """Many tiles, so that tile seams and every image border meet the mid
    halo: a plan of small tiles, as dc_plan could pick for other shapes."""
    h, w = 11, 13
    plan = DcPlan(th, tw, math.ceil(h / th), math.ceil(w / tw), 1, dc_smem(th, tw, 32, 8))
    args = _args(rng, 1, h, w, 8, 32, 8, BF)
    y, pooled = _emulate(*args, plan=plan)
    _close(y, fused_double_conv_plain(*args), BF)
    torch.testing.assert_close(pooled, max_pool2x2_plain(y), atol=0, rtol=0)


def test_mid_outside_the_image_must_be_zero(rng):
    """The same emulation without zeroing mid outside the image, with b1 > 0,
    is far from the plain version at the borders: the test above sees it."""
    args = _args(rng, 1, 13, 21, 8, 32, 16, BF)
    y, _ = _emulate(*args, zero_outside=False)
    ref = fused_double_conv_plain(*args)
    err = (y.float() - ref.float()).abs()
    assert (err > 2e-2 + 2e-2 * ref.float().abs()).any()
    # the interior, whose conv2 window never reaches past the image, agrees
    _close(y[:, 1:-1, 1:-1], ref[:, 1:-1, 1:-1], BF)


def _jnp(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16 if t.dtype == BF else jnp.float32)


def _np(a):
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)))


@pytest.mark.parametrize("n,h,w,cin,cmid,cout", [(1, 13, 21, 3, 32, 16), (1, 10, 17, 8, 64, 64)])
def test_emulated_double_conv_and_pool_match_pallas(rng, n, h, w, cin, cmid, cout):
    """bf16 against the Pallas kernels in interpret mode: the double conv,
    and its pool (odd W) against JAX's max_pool2x2 on JAX's output."""
    args = _args(rng, n, h, w, cin, cmid, cout, BF)
    y, pooled = _emulate(*args)
    jargs = [_jnp(a) if a.ndim == 4 else jnp.asarray(a.numpy()) for a in args]
    with pltpu.force_tpu_interpret_mode():
        jy = j_double_conv(*jargs)
        jp = j_pool(jy)
    _close(y, _np(jy), BF)
    _close(pooled, _np(jp), BF)
    # pooling the same values: exact in both packages
    torch.testing.assert_close(max_pool2x2_plain(_np(jy).to(BF)).float(), _np(jp), atol=0,
                               rtol=0)


def test_cpu_wrapper_returns_the_plain_pool(rng):
    """On CPU tensors ``pool=True`` returns the plain versions: (y,
    max_pool2x2_plain(y)), in both dtypes, odd W."""
    for dtype in (torch.float32, BF):
        args = _args(rng, 2, 9, 13, 3, 8, 8, dtype)
        y, pooled = K.fused_double_conv(*args, pool=True)
        torch.testing.assert_close(y, K.fused_double_conv(*args), atol=0, rtol=0)
        assert pooled.shape == (2, 4, 6, 8)
        torch.testing.assert_close(pooled, max_pool2x2_plain(y), atol=0, rtol=0)


def test_tc_double_conv_c_interface_matches_the_ctypes_signatures():
    """The bf16 entry point (the fp32 one, and the removal of the CUDA-core
    double conv, are checked in test_torch_tc_fp32_single_double.py)."""
    src = (_build.CSRC_DIR / "tc_double_conv.cu").read_text()
    head = 'extern "C" int tuk_tc_double_conv('
    assert head in src
    params = src.split(head, 1)[1].split(")", 1)[0]
    assert params.count(",") + 1 == len(_build._SIGNATURES["tuk_tc_double_conv"][0])


def test_python_mirrors_of_the_double_conv_constants_match_the_source():
    src = (_build.CSRC_DIR / "tc_double_conv.cu").read_text()

    def const(name):
        return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1).split("//")[0].strip()

    assert int(const("WARPS")) == DC_WARPS
    assert int(const("MI_MAX")) == DC_MI_MAX
    assert int(const("STAGES")) == DC_STAGES
    assert const("W_SLOT") == "2 * KC * 128" and DC_W_SLOT == 2 * KC * 128
    assert int(const("MAX_SMEM")) == DC_MAX_SMEM == 227 * 1024
    assert '#include "tc_common.cuh"' in src


def test_tc_double_conv_refuses_cpu_and_fp32_tensors(monkeypatch):
    """CPU tensors are refused; past the device check the launcher takes
    bf16 and fp32 (3xTF32) and refuses any other type before any build."""
    x = torch.zeros(1, 4, 4, 8, dtype=BF)
    w1, w2 = torch.zeros(3, 3, 8, 32, dtype=BF), torch.zeros(3, 3, 32, 8, dtype=BF)
    v32, v8 = torch.ones(32), torch.ones(8)
    with pytest.raises(ValueError, match="CUDA device"):
        tc_conv.double_conv(x, w1, v32, v32, w2, v8, v8, True)
    monkeypatch.setattr(_build, "validate", lambda kernel, *tensors: _build.DTYPE_F32)
    monkeypatch.setattr(_build, "library", lambda: pytest.fail("built a library"))
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        tc_conv.double_conv(x.half(), w1.half(), v32, v32, w2.half(), v8, v8, False)


@pytest.fixture
def card(monkeypatch):
    K.reset_launch_counts()
    yield _Card(monkeypatch)
    K.reset_launch_counts()


def _meta_dc(dtype, cin=3, cmid=64, cout=64):
    x = torch.empty(1, 9, 13, cin, device="meta", dtype=dtype)
    w1 = torch.empty(3, 3, cin, cmid, device="meta", dtype=dtype)
    w2 = torch.empty(3, 3, cmid, cout, device="meta", dtype=dtype)
    return x, w1, torch.ones(cmid), torch.zeros(cmid), w2, torch.ones(cout), torch.zeros(cout)


def test_bf16_double_conv_counts_follow_the_tensor_core_launcher(card):
    args = _meta_dc(BF)
    y = K.fused_double_conv(*args)
    y2, pooled = K.fused_double_conv(*args, pool=True)
    assert y.shape == y2.shape == (1, 9, 13, 64) and pooled.shape == (1, 4, 6, 64)
    counts = K.launch_counts()
    assert card.tc == ["fused_double_conv"] * 2 and card.lib == []
    assert counts["fused_double_conv"] == counts["fused_double_conv.tc"] == 2
    assert counts["fused_double_conv.pool"] == 1 and counts["max_pool2x2"] == 0


def test_fp32_double_conv_pools_in_its_epilogue(card):
    """The fp32 double conv's pool is written by the double-conv kernel
    itself (its epilogue, 3xTF32 on the tensor cores): one ``.tc`` and
    ``.pool`` launch, no max_pool2x2 launch, no CUDA-core call."""
    y, pooled = K.fused_double_conv(*_meta_dc(torch.float32), pool=True)
    assert pooled.shape == (1, 4, 6, 64) and pooled.dtype == torch.float32
    assert card.tc == ["fused_double_conv"] and card.lib == []
    counts = K.launch_counts()
    assert counts["fused_double_conv"] == counts["fused_double_conv.tc"] == 1
    assert counts["fused_double_conv.pool"] == 1 and counts["max_pool2x2"] == 0


def test_a_failed_double_conv_launch_counts_nothing(card):
    card.fail = True
    for pool in (False, True):
        with pytest.raises(RuntimeError, match="launch failed"):
            K.fused_double_conv(*_meta_dc(BF), pool=pool)
    assert card.lib == []  # no retreat to the CUDA-core kernel or the pool kernel
    assert all(v == 0 for v in K.launch_counts().values())


def test_a_bf16_forward_counts_three_pooled_double_convs_and_one_pool(card):
    """The served forward's launches, as chip_smoke.py's phase 4 holds them:
    3 double convs on the tensor cores that also write their pool, one
    max_pool2x2 (after down3), 8 single and 4 concat convs."""
    from tpu_unet_torch.models import UNetConfig, fold_bn, init_unet, unet_infer_apply
    from tpu_unet_torch.models.unet import tree_map

    cfg = UNetConfig(3, 1, base_channels=64)  # the flagship: down3 and down4 are not fused
    params, state = init_unet(cfg, np.random.default_rng(0))
    folded = tree_map(lambda t: t.to("meta", BF), fold_bn(params, state, cfg))
    out = unet_infer_apply(folded, torch.empty(1, 48, 37, 3, device="meta"), config=cfg,
                           backend="cuda", compute_dtype=BF)
    assert out.shape == (1, 48, 37, 1)
    counts = {k: v for k, v in K.launch_counts().items() if v}
    assert counts == {"fused_double_conv": 3, "fused_double_conv.tc": 3,
                      "fused_double_conv.pool": 3, "max_pool2x2": 1,
                      "fused_conv3x3_scale_relu": 8, "fused_conv3x3_scale_relu.tc": 8,
                      "fused_conv3x3_concat_scale_relu": 4,
                      "fused_conv3x3_concat_scale_relu.tc": 4}
    assert card.lib == ["tuk_max_pool2x2"]
