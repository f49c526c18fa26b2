"""The fp32 tensor-core route of ``conv3x3_fwd`` and ``conv3x3_dw`` in 3xTF32
(``tpu_unet_torch/kernels/tc_conv.py``, kernels in
``tpu_unet_torch/csrc/tc_conv.cu``) on the CPU, where the kernels cannot run:

- a torch emulation of ``cvt.rna.tf32.f32`` (round half away from zero on the
  low 13 bits of the fp32 pattern) and of the split v = hi + lo, which keeps
  every value to 2^-22 of itself;
- emulations of what the kernels compute, each in its own order (fwd: the
  fp32 plan's tiles, chunks of KC_F32 = 16 channels with the 9 taps inside,
  per k8 step lo*hi + hi*lo + hi*hi into a fresh sum added to the
  accumulator, per-tile stats partials added in row order; dw: per split of
  the fp32 ``dw_plan``, its tiles in order, the three products of every tap
  window), held to the plain versions at the fp32 tolerances the chip run
  holds the kernels to, and to the JAX Pallas kernels in interpret mode;
- a negative control: one TF32 pass at K = 9 * 512 breaks that tolerance,
  which is why the kernels take three;
- the Python mirrors of the fp32 constants match the source, and the fp32
  tile and dw plans fit the 227 KB of shared memory at the step's shapes;
- meta tensors on recording launchers: fp32 fwd, dw and dx reach the
  tensor-core launchers and count ``.tc``; the launchers hand the C
  functions the fp32 plans and a weight-split buffer (dx's and the concat
  conv's in ``tests/test_torch_tc_fp32_dx_concat.py``).

Tolerances, as ``chip_smoke.py`` holds the kernels: z within 1e-4 + 1e-4 *
|plain| (the same sums of products to about 2^-21 each, in another order,
over at most 9 * 512 terms); the stats and dw within 1e-4 of their largest
value (sums over N*H*W). Against Pallas (fp32 on the CPU): the same.
"""

import contextlib
import math
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from tests.test_torch_tc_conv import _Card
from tests.test_torch_tc_conv_bwd import _reduce_rows
from tpu_unet.kernels.train_conv import conv3x3_dw as j_dw, conv3x3_fwd as j_fwd
from tpu_unet_torch import kernels as K
from tpu_unet_torch.kernels import _build, tc_conv
from tpu_unet_torch.kernels.tc_conv import (
    DC_MAX_SMEM,
    DWF_CI,
    DWF_CO,
    DWF_MAX_PX,
    DWF_MAX_STAGED,
    F32_CONFIGS,
    KC_F32,
    dw_plan,
    tc_plan,
)
from tpu_unet_torch.kernels.train_conv import conv3x3_dw_plain, conv3x3_fwd_plain

F32 = torch.float32
TOL = (1e-4, 1e-4)
STATS_TOL = 1e-4
DW_TOL = 1e-4
SMS = 132  # the H100's SMs: the split plan depends on them


def _tf32(v: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: fp32 v rounded to 10 mantissa bits, half away from
    zero. Adding half of the 13 dropped bits' unit to the sign-magnitude
    pattern rounds the magnitude up at a tie, whatever the sign."""
    u = v.contiguous().view(torch.int32)
    return ((u + 0x1000) & -0x2000).view(torch.float32)


def _split(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo): hi the TF32 rounding of v, lo that of the exact v - hi."""
    hi = _tf32(v)
    return hi, _tf32(v - hi)


def _edge_values() -> torch.Tensor:
    """Powers of two, values one pattern step off them, exact ties of the
    13-bit rounding (low bits 0x1000) and the patterns around them, both
    signs."""
    pows = [2.0 ** k for k in range(-30, 31, 3)]
    base = torch.tensor(pows + [1.5, 3.1415927, 1e-3, 6.5e4], dtype=F32).view(torch.int32)
    pats = torch.cat([base, base + 1, base - 1, (base & -0x2000) | 0x1000,
                      (base & -0x2000) | 0x0FFF, (base & -0x2000) | 0x1001,
                      (base & -0x2000) | 0x1FFF])
    v = pats.view(F32)
    return torch.cat([v, -v])


@pytest.mark.parametrize("case", ["normal", "wide", "edges"])
def test_tf32_split_keeps_fp32_accuracy(case):
    if case == "normal":
        v = torch.from_numpy(np.random.default_rng(0).standard_normal(20000, dtype=np.float32))
    elif case == "wide":
        rng = np.random.default_rng(1)
        v = torch.from_numpy((rng.standard_normal(20000) * 10.0 ** rng.uniform(-6, 6, 20000))
                             .astype(np.float32))
    else:
        v = _edge_values()
    hi, lo = _split(v)
    for part in (hi, lo):  # TF32 values: the low 13 bits are zero
        assert (part.view(torch.int32) & 0x1FFF == 0).all()
    err = (v.double() - (hi.double() + lo.double())).abs()
    assert (err <= 2.0 ** -21 * v.double().abs()).all(), err.max()
    # one TF32 pass alone is about 2^-11 off
    assert ((v.double() - hi.double()).abs() <= 2.0 ** -11 * v.double().abs()).all()


def test_tf32_rounding_is_half_away_from_zero():
    one = torch.tensor([1.0], dtype=F32).view(torch.int32)
    tie = (one | 0x1000).view(F32)      # 1 + 2^-11: halfway between two TF32 values
    below = (one | 0x0FFF).view(F32)
    assert _tf32(tie).item() == 1.0 + 2.0 ** -10
    assert _tf32(-tie).item() == -(1.0 + 2.0 ** -10)
    assert _tf32(below).item() == 1.0
    top = torch.tensor([2.0 - 2.0 ** -23], dtype=F32)  # rounds up into the next binade
    assert _tf32(top).item() == 2.0


def _ceil8(v):
    return -(-v // 8) * 8


def _mm3(a, b):
    """a @ b as the kernels sum it for one k8 step: lo*hi, hi*lo, hi*hi into
    a fresh sum (the caller adds it to its accumulator)."""
    ah, al = _split(a)
    bh, bl = _split(b)
    t = al @ bh
    t = t + ah @ bl
    return t + ah @ bh


def _emulate_fwd(x, w, a=None, c=None):
    """What tuk_tc_conv3x3_fwd_f32 computes: the fp32 plan's tiles, each
    staged with a zero halo (the prologue on in-image positions only),
    chunk-major over KC_F32 channels, 9 shifted windows a chunk, two k8
    steps a window; fp32 z and its per-tile (sum, sum of squares) rows
    added in order."""
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    p = tc_plan(n, h, wd, _ceil8(cout), True)
    assert p.kc == KC_F32
    kin = math.ceil(_ceil8(cin) / KC_F32) * KC_F32
    xf = F.pad(x, (0, kin - cin))
    if a is not None:
        xf = torch.relu(xf * F.pad(a, (0, kin - cin)) + F.pad(c, (0, kin - cin)))
    xh = F.pad(xf, (0, 0, 1, 1, 1, 1))
    wf = F.pad(w, (0, 0, 0, kin - cin)).reshape(9, kin, cout)
    out = torch.zeros(n, h, wd, cout)
    rows = []
    for b in range(n):
        for t in range(p.tiles):
            h0, w0 = p.tile_origin(t)
            th, tw = min(p.th, h - h0), min(p.tw, wd - w0)
            acc = torch.zeros(th * tw, cout)
            for k0 in range(0, kin, KC_F32):
                for tap in range(9):
                    ky, kx = divmod(tap, 3)
                    win = xh[b, h0 + ky:h0 + ky + th, w0 + kx:w0 + kx + tw, k0:k0 + KC_F32]
                    win = win.reshape(-1, KC_F32)
                    for k8 in (0, 8):
                        acc = acc + _mm3(win[:, k8:k8 + 8], wf[tap, k0 + k8:k0 + k8 + 8])
            out[b, h0:h0 + th, w0:w0 + tw] = acc.reshape(th, tw, cout)
            rows.append(torch.stack([acc.sum(0), (acc * acc).sum(0)]))
    return out, torch.stack(rows).sum(0)


def _emulate_dw(x, g, z, coef, a=None, c=None):
    """What tuk_tc_conv3x3_dw_f32 computes: per split of the fp32 dw_plan,
    its tiles in order, each tap's window against the tile's dz in k8 steps
    of pixels, the splits' partials added in reduce_rows' order."""
    n, h, wd, cin = x.shape
    cout = g.shape[3]
    cin8, cout8 = _ceil8(cin), _ceil8(cout)
    p = dw_plan(n, h, wd, cin8, cout8, SMS, True)
    xf = F.pad(x, (0, cin8 - cin))
    if a is not None:
        xf = torch.relu(xf * F.pad(a, (0, cin8 - cin)) + F.pad(c, (0, cin8 - cin)))
    xh = F.pad(xf, (0, 0, 1, 1, 1, 1))
    dz = F.pad((coef[0] * g + coef[1] * z) + coef[2], (0, cout8 - cout))
    parts = []
    for s in range(p.splits):
        acc = torch.zeros(9, cin8, cout8)
        for t in p.split_tiles(s):
            b, h0, w0 = p.tile_origin(t)
            th, tw = min(p.th, h - h0), min(p.tw, wd - w0)
            d = dz[b, h0:h0 + th, w0:w0 + tw].reshape(-1, cout8)
            for tap in range(9):
                ky, kx = divmod(tap, 3)
                win = xh[b, h0 + ky:h0 + ky + th, w0 + kx:w0 + kx + tw].reshape(-1, cin8)
                for k8 in range(0, th * tw, 8):
                    acc[tap] = acc[tap] + _mm3(win[k8:k8 + 8].T, d[k8:k8 + 8])
        parts.append(acc)
    dw = parts[0] if p.splits == 1 else _reduce_rows(parts)
    return dw.reshape(3, 3, cin8, cout8)[:, :, :cin, :cout]


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _inputs(rng, n, h, w, cin, cout, prologue):
    """fp32 x, w, g, z, coef with gamma != 0, and with the prologue a c
    whose relu is > 0, so a leak into the SAME padding shows."""
    x = _t(rng.standard_normal((n, h, w, cin)))
    wt = _t(rng.standard_normal((3, 3, cin, cout)) * (9 * cin) ** -0.5)
    g = _t(rng.standard_normal((n, h, w, cout)))
    z = _t(rng.standard_normal((n, h, w, cout)))
    coef = _t(np.stack([np.ones(cout), 0.3 * rng.standard_normal(cout),
                        0.5 + 0.2 * rng.standard_normal(cout)]))
    if not prologue:
        return x, wt, g, z, coef, None, None
    a = _t(0.5 + rng.random(cin))
    c = _t(0.5 * rng.standard_normal(cin))
    c[0] = 0.7
    return x, wt, g, z, coef, a, c


def _close(got, ref):
    torch.testing.assert_close(got, ref, atol=TOL[0], rtol=TOL[1])


def _close_to_scale(got, ref, frac):
    err = (got - ref).abs().max().item()
    assert err <= frac * ref.abs().max().item(), err


@pytest.mark.parametrize("prologue", [False, True], ids=["raw", "pro"])
@pytest.mark.parametrize("cin,cout", [(3, 64), (64, 24), (40, 136)])
def test_emulated_fwd_matches_the_plain_version(rng, cin, cout, prologue):
    x, w, _, _, _, a, c = _inputs(rng, 2, 13, 20, cin, cout, prologue)
    z, s = _emulate_fwd(x, w, a, c)
    pz, ps = conv3x3_fwd_plain(x, w, a, c, stats=True)
    _close(z, pz)
    _close_to_scale(s, ps, STATS_TOL)


# (n, h, w, Cin, Cout): ragged tiles and several splits; Cin = 3 padded to 8.
DW_SHAPES = [(2, 13, 20, 16, 24), (1, 35, 35, 8, 16), (2, 11, 17, 3, 8)]


@pytest.mark.parametrize("prologue", [False, True], ids=["raw", "pro"])
@pytest.mark.parametrize("n,h,w,cin,cout", DW_SHAPES)
def test_emulated_dw_matches_the_plain_version(rng, n, h, w, cin, cout, prologue):
    x, _, g, z, coef, a, c = _inputs(rng, n, h, w, cin, cout, prologue)
    got = _emulate_dw(x, g, z, coef, a, c)
    assert got.shape == (3, 3, cin, cout)
    _close_to_scale(got, conv3x3_dw_plain(x, g, z, coef, a, c), DW_TOL)


def test_emulated_fp32_kernels_match_pallas(rng):
    """The emulations against the Pallas kernels in interpret mode, fp32 at
    35 x 35 (ragged tiles in both plans), with the prologue."""
    x, w, g, z, coef, a, c = _inputs(rng, 1, 35, 35, 16, 32, True)
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    with pltpu.force_tpu_interpret_mode():
        jz, js = j_fwd(j(x), j(w), j(a), j(c), stats=True)
        jdw = j_dw(j(x), j(g), j(z), j(coef), j(a), j(c))
    to = lambda v: torch.from_numpy(np.array(v, np.float32))  # noqa: E731
    ez, es = _emulate_fwd(x, w, a, c)
    _close(ez, to(jz))
    _close_to_scale(es, to(js), STATS_TOL)
    _close_to_scale(_emulate_dw(x, g, z, coef, a, c), to(jdw), DW_TOL)


def test_one_tf32_pass_breaks_the_fp32_tolerance(rng):
    """The negative control, at down4's K = 9 * 512: rounding both operands
    to TF32 once (one MMA pass, the sums in float64 so only that rounding
    shows) leaves the fp32 TOL; the three passes of the split stay inside
    it."""
    x, w, *_ = _inputs(rng, 1, 6, 7, 512, 16, False)
    ref = conv3x3_fwd_plain(x, w).double()

    def conv(p, q):  # float64 sums of the given fp32 operands
        return F.conv2d(p.double().permute(0, 3, 1, 2), q.double().permute(3, 2, 0, 1),
                        padding=1).permute(0, 2, 3, 1)

    exact = conv(x, w)
    one = conv(_tf32(x), _tf32(w))
    (xh, xl), (wh, wl) = _split(x), _split(w)
    three = conv(xl, wh) + conv(xh, wl) + conv(xh, wh)
    bound = TOL[0] + TOL[1] * ref.abs()
    assert ((one - ref).abs() > bound).any()
    assert ((three - ref).abs() <= bound).all()
    # what each leaves of the exact sums: three passes, three orders less
    assert (three - exact).abs().max() < 1e-3 * (one - exact).abs().max()


def _src_const(name: str) -> int:
    src = (_build.CSRC_DIR / "tc_conv.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _up_align(v: int) -> int:
    return -(-v // 1024) * 1024


def _fwd_f32_smem(cfg: int) -> int:
    """One fp32 forward block's dynamic shared memory, as Config::SMEM: the
    alignment slack, two input slots, the ring of 4 k-steps of both weight
    planes [2][BN][KC_F32], the stats scratch and 6 mbarriers."""
    bm, bn, max_staged = F32_CONFIGS[cfg]
    warps = bm * bn // (64 * 64)
    return (1024 + 2 * _up_align(max_staged * 64) + 4 * 2 * bn * KC_F32 * 4
            + warps * 2 * bn * 4 + 6 * 8)


def _dw_f32_smem() -> int:
    """One fp32 dw block's, as DWF_SMEM: the slack, the raw x halves (tile
    plus halo) and g and z halves (tile), xT and dzT, the per-channel
    vectors, each K row's staged pixel and the mbarrier."""
    return (1024 + 2 * _up_align(DWF_MAX_STAGED * 128) + 4 * DWF_MAX_PX * 128
            + DWF_CI * _src_const("DWF_XROW") * 4 + DWF_CO * _src_const("DWF_DROW") * 4
            + 5 * 64 * 4 + DWF_MAX_PX * 4 + 8)


def test_python_mirrors_of_the_fp32_constants_match_the_source():
    src = (_build.CSRC_DIR / "tc_conv.cu").read_text()
    common = (_build.CSRC_DIR / "tc_common.cuh").read_text()  # the operand traits
    kc = re.search(r"struct Tf32x3Op \{[^}]*static constexpr int KC = (\d+);", common)
    assert int(kc.group(1)) == KC_F32
    found = {int(m.group(1)): tuple(int(v) for v in m.group(2).split(","))
             for m in re.finditer(r"using F32Cfg(\d+) = Config<([\d, ]+), Tf32x3Op>;", src)}
    assert set(found) == set(F32_CONFIGS)
    for cfg, (bm, bn, max_staged) in F32_CONFIGS.items():
        cbm, cbn, wm, wn, cmax, _ = found[cfg]
        assert (cbm, cbn, cmax) == (bm, bn, max_staged), cfg
        assert bm % (16 * wm) == 0 and bn % (16 * wn) == 0 and bn % 64 == 0, cfg
        assert f"TUK_F32_CASE({cfg})" in src, cfg
    for name, value in (("DWF_CI", DWF_CI), ("DWF_CO", DWF_CO), ("DWF_MAX_PX", DWF_MAX_PX),
                        ("DWF_MAX_STAGED", DWF_MAX_STAGED)):
        assert _src_const(name) == value, name
    # the K-contiguous copies: rows wide enough, 4 mod 32 words apart
    xrow, drow = _src_const("DWF_XROW"), _src_const("DWF_DROW")
    assert xrow >= DWF_MAX_STAGED and drow >= DWF_MAX_PX
    assert xrow % 32 == 4 and drow % 32 == 4


# The train step's conv shapes at 572² b16 and the 959x640 parity batch:
# (n, h, w, Cin, Cout) of every DoubleConv conv (Cin 3 padded to 8).
STEP_SHAPES = [
    (16, 572, 572, 8, 64), (16, 572, 572, 64, 64), (16, 286, 286, 64, 128),
    (16, 143, 143, 128, 256), (16, 71, 71, 256, 512), (16, 35, 35, 512, 1024),
    (16, 35, 35, 1024, 1024), (16, 71, 71, 1024, 512), (16, 143, 143, 512, 256),
    (16, 286, 286, 256, 128), (16, 572, 572, 128, 64), (4, 640, 959, 8, 64),
    (4, 320, 479, 64, 128), (4, 40, 59, 512, 1024), (4, 80, 119, 1024, 512),
]


@pytest.mark.parametrize("n,h,w,cin,cout", STEP_SHAPES)
def test_fp32_plans_fit_the_shared_memory(n, h, w, cin, cout):
    """Two fp32 forward blocks an SM (the launch bounds), one dw block; each
    plan's tiles within its kernel's limits, covering every pixel once."""
    p = tc_plan(n, h, w, cout, True)
    bm, _, max_staged = F32_CONFIGS[p.cfg]
    assert p.kc == KC_F32 and p.th * p.tw <= bm and (p.th + 2) * (p.tw + 2) <= max_staged
    assert 2 * (_fwd_f32_smem(p.cfg) + 1024) <= 228 * 1024  # 1 KB reserved a block
    assert _dw_f32_smem() <= DC_MAX_SMEM  # the 227 KB a block may use
    d = dw_plan(n, h, w, cin, cout, SMS, True)
    assert 1 <= d.th * d.tw <= DWF_MAX_PX and (d.th + 2) * (d.tw + 2) <= DWF_MAX_STAGED
    walked = [t for s in range(d.splits) for t in d.split_tiles(s)]
    assert walked == list(range(d.total_tiles))
    assert d.splits == 1 or d.splits * d.ci_blocks * d.co_blocks <= 2 * SMS
    assert d.tiles_h * d.th >= h > (d.tiles_h - 1) * d.th
    assert d.tiles_w * d.tw >= w > (d.tiles_w - 1) * d.tw


@pytest.fixture
def card(monkeypatch):
    K.reset_launch_counts()
    yield _Card(monkeypatch)
    K.reset_launch_counts()


def test_fp32_fwd_and_dw_count_tensor_core_launches(card):
    """On meta tensors standing in for CUDA ones: fp32 fwd (with and
    without its stats and prologue), dw and dx reach the tensor-core
    launchers and count ``.tc``; none reaches the CUDA-core library."""
    x = torch.empty(1, 5, 6, 8, device="meta")
    g = torch.empty(1, 5, 6, 16, device="meta")
    w = torch.empty(3, 3, 8, 16, device="meta")
    coef = torch.zeros(3, 16)
    K.conv3x3_fwd(x, w, stats=True)
    K.conv3x3_fwd(x, w, torch.ones(8), torch.zeros(8))
    K.conv3x3_dw(x, g, g, coef, torch.ones(8), torch.zeros(8))
    K.conv3x3_dx(g, g, coef, w)
    counts = K.launch_counts()
    assert card.tc == ["conv3x3_fwd"] * 2 + ["conv3x3_dw", "conv3x3_dx"] and card.lib == []
    assert counts["conv3x3_fwd"] == counts["conv3x3_fwd.tc"] == 2
    assert counts["conv3x3_dw"] == counts["conv3x3_dw.tc"] == 1
    assert counts["conv3x3_dx"] == counts["conv3x3_dx.tc"] == 1


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


@pytest.mark.parametrize("stats", [False, True], ids=["z", "stats"])
def test_fp32_fwd_launcher_passes_the_fp32_plan_and_a_split_buffer(lib, stats):
    """The fp32 launcher calls tuk_tc_conv3x3_fwd_f32 with every argument of
    its signature: the fp32 plan (cfg, th, tw), Cin and Cout padded to 8,
    and a [2, 9, Cout, Cin] fp32 buffer for the split weights."""
    x = torch.zeros(2, 13, 20, 3)
    w = torch.zeros(3, 3, 3, 20)
    z = tc_conv.conv3x3_fwd(x, w, None, None, stats)
    (name, args), = lib.calls
    assert name == "tuk_tc_conv3x3_fwd_f32"
    assert len(args) == len(_build._SIGNATURES[name][0])
    p = tc_plan(2, 13, 20, 24, True)
    assert args[8:] == (2, 13, 20, 8, 24, p.cfg, p.th, p.tw, 0)
    assert (args[6] is None) == (args[7] is None) == (not stats)
    assert all(args[i] is not None for i in (0, 3, 4, 5))
    out = z[0] if stats else z
    assert out.shape == (2, 13, 20, 20) and out.dtype == F32


def test_fp32_dw_launcher_passes_the_fp32_plan(lib):
    """conv3x3_dw in fp32 calls tuk_tc_conv3x3_dw_f32 with the fp32 dw_plan
    (tiles of at most DWF_MAX_PX pixels) and a partials buffer when it
    splits."""
    x = torch.zeros(1, 300, 3, 16)
    g = torch.zeros(1, 300, 3, 8)
    dw = tc_conv.conv3x3_dw(x, g, g, torch.zeros(3, 8), torch.ones(16), torch.zeros(16))
    (name, args), = lib.calls
    assert name == "tuk_tc_conv3x3_dw_f32"
    assert len(args) == len(_build._SIGNATURES[name][0])
    p = dw_plan(1, 300, 3, 16, 8, SMS, True)
    assert p.splits > 1 and p.th * p.tw <= DWF_MAX_PX
    assert args[8:] == (1, 300, 3, 16, 8, p.th, p.tw, p.tiles_per_split, p.splits, 0)
    assert args[6] is not None and dw.shape == (3, 3, 16, 8)
