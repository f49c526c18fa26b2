"""The bf16 tensor-core route of ``conv3x3_dx`` and ``conv3x3_dw``
(``tpu_unet_torch/kernels/tc_conv.py``, kernels in
``tpu_unet_torch/csrc/tc_conv.cu``) on the CPU, where the kernels cannot run:

- plain PyTorch emulations of what the kernels compute, each in its own
  order, equal the plain versions and the JAX Pallas kernels:
  dx: ``tc_conv_kernel`` with the DzLoad loader over the plan of its output
  width, chunk-major over the (zero-padded) C channels, 9 shifted windows a
  chunk, dz = alpha*g + beta*z + gamma rounded to bf16 while staged and zero
  outside the image; dw: per split of ``dw_plan``, its pixel tiles in order,
  9 shifted windows of the tile plus halo against the tile's dz, the
  splits' partials added in ``reduce_rows``' order;
- the dw plan covers every pixel tile exactly once, and its tiles every
  pixel once;
- the new C functions match their ctypes signatures and the Python mirrors
  of the dw constants match the source;
- the launchers refuse CPU and fp32 tensors, and the wrappers' ``.tc``
  counts move exactly when a tensor-core launcher returns.

Tolerances, as in ``tests/test_torch_tc_conv.py``: an emulation and a plain
version round the same values at the same points and sum the same exact
products in another order, so bf16 outputs may differ by one bf16 ulp (2e-2
+ 2e-2 * |plain|), fp32 outputs by fp32 summation order (1e-4 + 1e-4 *
|plain|), and dw, a sum over N*H*W, within 1e-4 of its largest value.
Against Pallas (which rounds on its own path): dx 2e-2 + 2e-2, dw 1e-2 of
its largest value, as ``tests/test_torch_train_kernels.py`` holds the plain
versions there.
"""

import contextlib
import gc
import math
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from tests.test_torch_tc_conv import _Card
from tpu_unet.kernels.train_conv import conv3x3_dw as j_dw, conv3x3_dx as j_dx
from tpu_unet_torch import kernels as K
from tpu_unet_torch.kernels import _build, tc_conv
from tpu_unet_torch.kernels.tc_conv import (
    DW_CI,
    DW_CO,
    DW_MAX_PX,
    DW_MAX_STAGED,
    KC,
    dw_plan,
    tc_plan,
)
from tpu_unet_torch.kernels.train_conv import conv3x3_dw_plain, conv3x3_dx_plain

BF = torch.bfloat16
TOL = {torch.float32: (1e-4, 1e-4), BF: (2e-2, 2e-2)}
DW_SCALE_TOL = 1e-4
SMS = 132  # the H100's SMs: the split plan depends on them


def _ceil8(v):
    return -(-v // 8) * 8


def _dz(g, z, coef, channels):
    """dz as the kernels stage it: fp32 alpha*g + beta*z + gamma in the plain
    version's order, rounded to bf16, zero-padded to ``channels``."""
    cf = coef.float()
    dz = ((cf[0] * g.float() + cf[1] * z.float()) + cf[2]).to(g.dtype).float()
    return F.pad(dz, (0, channels - dz.shape[3]))


def _emulate_dx(g, z, coef, w, out_dtype):
    """What tuk_tc_conv3x3_dx computes: the forward's mainloop over dz."""
    n, h, wd, ch = g.shape
    cin = w.shape[2]
    p = tc_plan(n, h, wd, _ceil8(cin))
    kin = math.ceil(_ceil8(ch) / KC) * KC  # zero-padded channels, whole chunks
    dzh = F.pad(_dz(g, z, coef, kin), (0, 0, 1, 1, 1, 1))  # the halo stays zero
    wt = w.flip(0, 1).transpose(2, 3).float()                # [3,3,C,Cin]
    wt = F.pad(wt, (0, 0, 0, kin - ch)).reshape(9, kin, cin)
    out = torch.zeros(n, h, wd, cin)
    for b in range(n):
        for t in range(p.tiles):
            h0, w0 = p.tile_origin(t)
            th, tw = min(p.th, h - h0), min(p.tw, wd - w0)
            acc = torch.zeros(th * tw, cin)
            for k0 in range(0, kin, KC):  # chunk-major ...
                for tap in range(9):      # ... 9 shifted windows of the staged chunk
                    ky, kx = divmod(tap, 3)
                    win = dzh[b, h0 + ky:h0 + ky + th, w0 + kx:w0 + kx + tw, k0:k0 + KC]
                    acc += win.reshape(-1, KC) @ wt[tap, k0:k0 + KC]
            out[b, h0:h0 + th, w0:w0 + tw] = acc.reshape(th, tw, cin)
    return out.to(out_dtype)


def _reduce_rows(rows):
    """reduce_rows' order for a few rows (one pass): thread row q adds rows
    q, q + 32, ... in order, then the 32 sums are added in order."""
    assert len(rows) <= 256  # more rows would take its two-pass path
    parts = []
    for q in range(min(32, len(rows))):
        v = rows[q].clone()
        for r in rows[q + 32::32]:
            v = v + r
        parts.append(v)
    total = parts[0].clone()
    for v in parts[1:]:
        total = total + v
    return total


def _emulate_dw(x, g, z, coef, a=None, c=None):
    """What tuk_tc_conv3x3_dw computes: per split, its tiles in order, the 9
    shifted windows of the tile plus halo against the tile's dz."""
    n, h, wd, cin = x.shape
    cout = g.shape[3]
    cin8, cout8 = _ceil8(cin), _ceil8(cout)
    p = dw_plan(n, h, wd, cin8, cout8, SMS)
    xf = F.pad(x.float(), (0, cin8 - cin))
    if a is not None:  # in-image positions only: the halo stays zero
        xf = torch.relu(xf * F.pad(a.float(), (0, cin8 - cin))
                        + F.pad(c.float(), (0, cin8 - cin))).to(x.dtype).float()
    xh = F.pad(xf, (0, 0, 1, 1, 1, 1))
    dz = _dz(g, z, coef, cout8)
    parts = []
    for s in range(p.splits):
        acc = torch.zeros(9, cin8, cout8)
        for t in p.split_tiles(s):
            b, h0, w0 = p.tile_origin(t)
            th, tw = min(p.th, h - h0), min(p.tw, wd - w0)  # past the image: dz = 0
            d = dz[b, h0:h0 + th, w0:w0 + tw].reshape(-1, cout8)
            for tap in range(9):
                ky, kx = divmod(tap, 3)
                win = xh[b, h0 + ky:h0 + ky + th, w0 + kx:w0 + kx + tw].reshape(-1, cin8)
                acc[tap] += win.T @ d
        parts.append(acc)
    dw = parts[0] if p.splits == 1 else _reduce_rows(parts)
    return dw.reshape(3, 3, cin8, cout8)[:, :, :cin, :cout]


def _inputs(rng, n, h, w, cin, cout, prologue):
    """bf16 x, forward weights, g, z; fp32 coef with gamma != 0 and, with the
    prologue, a c whose relu is > 0, so a leak into the padding shows."""
    def t(a, dtype=BF):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)

    x = t(rng.standard_normal((n, h, w, cin)))
    wt = t(rng.standard_normal((3, 3, cin, cout)) * (9 * cin) ** -0.5)
    g = t(rng.standard_normal((n, h, w, cout)))
    z = t(rng.standard_normal((n, h, w, cout)))
    coef = t(np.stack([np.ones(cout), 0.3 * rng.standard_normal(cout),
                       0.5 + 0.2 * rng.standard_normal(cout)]), torch.float32)
    if not prologue:
        return x, wt, g, z, coef, None, None
    a = t(0.5 + rng.random(cin), torch.float32)
    c = t(0.5 * rng.standard_normal(cin), torch.float32)
    c[0] = 0.7
    return x, wt, g, z, coef, a, c


def _close(got, ref, dtype):
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)


def _close_to_scale(got, ref, frac):
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= frac * ref.float().abs().max().item(), err


# (n, h, w, C, Cin): ragged tiles, Cin / C not multiples of 8 or of a chunk.
DX_SHAPES = [(2, 13, 20, 16, 24), (1, 11, 17, 40, 8), (2, 9, 14, 8, 3)]


@pytest.mark.parametrize("out_dtype", [BF, torch.float32], ids=["bf16_out", "fp32_out"])
@pytest.mark.parametrize("n,h,w,ch,cin", DX_SHAPES)
def test_emulated_dx_matches_the_plain_version(rng, n, h, w, ch, cin, out_dtype):
    _, wt, g, z, coef, _, _ = _inputs(rng, n, h, w, cin, ch, False)
    got = _emulate_dx(g, z, coef, wt, out_dtype)
    assert got.shape == (n, h, w, cin) and got.dtype == out_dtype
    _close(got, conv3x3_dx_plain(g, z, coef, wt, out_dtype=out_dtype), out_dtype)


@pytest.mark.parametrize("h,w,cin", [(100, 3, 64), (128, 1, 128)])
def test_emulated_dx_matches_the_plain_version_on_a_narrow_image(rng, h, w, cin):
    """Tiles shorter than the image's height, as tc_plan picks them there."""
    _, wt, g, z, coef, _, _ = _inputs(rng, 1, h, w, cin, 16, False)
    assert tc_plan(1, h, w, cin).tiles_h > 1
    got = _emulate_dx(g, z, coef, wt, torch.float32)
    _close(got, conv3x3_dx_plain(g, z, coef, wt, out_dtype=torch.float32), torch.float32)


def test_dz_stays_zero_in_the_padding():
    """gamma = 1 with g = z = 0 gives dz = 1 inside the image and 0 outside:
    a border pixel of dx sees fewer ones than an interior one."""
    g = torch.zeros(1, 4, 5, 1, dtype=BF)
    coef = torch.tensor([[1.0], [0.0], [1.0]])
    w = torch.ones(3, 3, 1, 1, dtype=BF)
    dx = _emulate_dx(g, g, coef, w, torch.float32)[0, :, :, 0]
    assert dx[1, 1] == 9 and dx[0, 0] == 4 and dx[0, 2] == 6
    assert torch.equal(dx, conv3x3_dx_plain(g, g, coef, w, out_dtype=torch.float32)[0, :, :, 0])


# (n, h, w, Cin, Cout): ragged tiles and several splits; Cin = 3 padded to 8.
DW_SHAPES = [(2, 13, 20, 16, 24), (1, 35, 35, 8, 16), (2, 11, 17, 3, 8)]


@pytest.mark.parametrize("prologue", [False, True], ids=["raw", "pro"])
@pytest.mark.parametrize("n,h,w,cin,cout", DW_SHAPES)
def test_emulated_dw_matches_the_plain_version(rng, n, h, w, cin, cout, prologue):
    x, _, g, z, coef, a, c = _inputs(rng, n, h, w, cin, cout, prologue)
    got = _emulate_dw(x, g, z, coef, a, c)
    assert got.shape == (3, 3, cin, cout)
    _close_to_scale(got, conv3x3_dw_plain(x, g, z, coef, a, c), DW_SCALE_TOL)


def test_emulated_dw_matches_the_plain_version_on_a_narrow_image(rng):
    """Tiles shorter than the image's height, over several splits."""
    x, _, g, z, coef, a, c = _inputs(rng, 1, 300, 3, 16, 8, True)
    p = dw_plan(1, 300, 3, 16, 8, SMS)
    assert p.tiles_h > 1 and p.splits > 1
    _close_to_scale(_emulate_dw(x, g, z, coef, a, c), conv3x3_dw_plain(x, g, z, coef, a, c),
                    DW_SCALE_TOL)


def test_emulated_kernels_match_pallas(rng):
    """The emulations against the Pallas kernels in interpret mode, bf16 at
    35 x 35 (ragged tiles in both plans), dx in both output dtypes, dw with
    the prologue."""
    x, wt, g, z, coef, a, c = _inputs(rng, 1, 35, 35, 16, 32, True)
    j = lambda t: jnp.asarray(t.float().numpy()).astype(  # noqa: E731
        jnp.bfloat16 if t.dtype == BF else jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        jdx = j_dx(j(g), j(z), j(coef), j(wt))
        jdx32 = j_dx(j(g), j(z), j(coef), j(wt), out_dtype=jnp.float32)
        jdw = j_dw(j(x), j(g), j(z), j(coef), j(a), j(c))
    to = lambda v: torch.from_numpy(np.array(v, np.float32))  # noqa: E731
    _close(_emulate_dx(g, z, coef, wt, BF), to(jdx), BF)
    _close(_emulate_dx(g, z, coef, wt, torch.float32), to(jdx32), BF)
    _close_to_scale(_emulate_dw(x, g, z, coef, a, c), to(jdw), 1e-2)


@pytest.mark.parametrize("n,h,w,cin,cout", [
    (2, 13, 20, 16, 24), (1, 300, 3, 16, 8), (16, 35, 35, 512, 1024), (4, 572, 572, 64, 64),
    (16, 572, 572, 64, 64), (16, 71, 71, 256, 512), (4, 320, 479, 64, 128), (1, 1, 1, 8, 8),
    (3, 7, 300, 8, 64),
])
def test_dw_plan_covers_every_tile_once(n, h, w, cin, cout):
    p = dw_plan(n, h, w, cin, cout, SMS)
    assert 1 <= p.th * p.tw <= DW_MAX_PX and (p.th + 2) * (p.tw + 2) <= DW_MAX_STAGED
    assert (p.ci_blocks, p.co_blocks) == (math.ceil(cin / DW_CI), math.ceil(cout / DW_CO))
    walked = [t for s in range(p.splits) for t in p.split_tiles(s)]
    assert walked == list(range(p.total_tiles))  # each tile once, splits in order
    assert all(len(p.split_tiles(s)) > 0 for s in range(p.splits))
    assert p.splits == 1 or p.splits * p.ci_blocks * p.co_blocks <= 2 * SMS
    cover = np.zeros((n, h, w), np.int64)
    for t in walked:
        b, h0, w0 = p.tile_origin(t)
        assert 0 <= h0 < h and 0 <= w0 < w  # no tile lies wholly outside
        cover[b, h0:h0 + p.th, w0:w0 + p.tw] += 1
    assert (cover == 1).all()


def test_tc_bwd_c_interface_matches_the_ctypes_signatures():
    src = (_build.CSRC_DIR / "tc_conv.cu").read_text()
    for name in ("tuk_tc_conv3x3_dx", "tuk_tc_conv3x3_dw"):
        head = f'extern "C" int {name}('
        assert head in src, name
        params = src.split(head, 1)[1].split(")", 1)[0]
        assert params.count(",") + 1 == len(_build._SIGNATURES[name][0]), name


def test_python_mirrors_of_the_dw_constants_match_the_source():
    src = (_build.CSRC_DIR / "tc_conv.cu").read_text()
    for name, value in (("DW_CI", DW_CI), ("DW_CO", DW_CO), ("DW_MAX_PX", DW_MAX_PX),
                        ("DW_MAX_STAGED", DW_MAX_STAGED)):
        assert int(re.search(rf"constexpr int {name} = (\d+);", src).group(1)) == value, name


def _dx(g, coef, w):
    return tc_conv.conv3x3_dx(g, g, coef, w, g.dtype)


def _dw(g, coef, w):
    return tc_conv.conv3x3_dw(g, g, g, coef, None, None)


# (launcher, the dtype it refuses past the device check, the error's words):
# dx and dw take fp32 too (3xTF32) and refuse any other type.
@pytest.mark.parametrize("launch,refused,match", [
    (_dx, torch.float16, "bfloat16 or float32"),
    (_dw, torch.float16, "bfloat16 or float32"),
], ids=["conv3x3_dx", "conv3x3_dw"])
def test_tc_bwd_launchers_refuse_cpu_and_fp32_tensors(monkeypatch, launch, refused, match):
    g = torch.zeros(1, 4, 4, 8, dtype=BF)
    w = torch.zeros(3, 3, 8, 8, dtype=BF)
    coef = torch.zeros(3, 8)
    with pytest.raises(ValueError, match="CUDA device"):
        launch(g, coef, w)
    # Past the device check, a refused dtype raises before any build.
    monkeypatch.setattr(_build, "validate", lambda kernel, *tensors: _build.DTYPE_F32)
    monkeypatch.setattr(_build, "library", lambda: pytest.fail("built a library"))
    with pytest.raises(ValueError, match=match):
        launch(g.to(refused), coef, w.to(refused))


@pytest.fixture
def card(monkeypatch):
    K.reset_launch_counts()
    yield _Card(monkeypatch)
    K.reset_launch_counts()


def _bwd_calls(dtype):
    """dx (both output dtypes) and dw (with and without the prologue) on meta
    tensors."""
    x = torch.empty(1, 5, 6, 8, device="meta", dtype=dtype)
    g = torch.empty(1, 5, 6, 16, device="meta", dtype=dtype)
    w = torch.empty(3, 3, 8, 16, device="meta", dtype=dtype)
    coef = torch.zeros(3, 16)
    K.conv3x3_dx(g, g, coef, w)
    K.conv3x3_dx(g, g, coef, w, out_dtype=torch.float32)
    K.conv3x3_dw(x, g, g, coef)
    K.conv3x3_dw(x, g, g, coef, torch.ones(8), torch.zeros(8))


@pytest.mark.parametrize("dtype", [BF, torch.float32], ids=["bf16", "fp32"])
def test_bwd_tc_counts_follow_the_tensor_core_launcher(card, dtype):
    """dx and dw count ``.tc`` once per return of their tensor-core launcher
    and never reach the CUDA-core library, in bf16 and in fp32 (3xTF32)."""
    _bwd_calls(dtype)
    counts = K.launch_counts()
    assert counts["conv3x3_dx"] == counts["conv3x3_dw"] == 2
    for name in ("conv3x3_dx", "conv3x3_dw"):
        assert counts[f"{name}.tc"] == card.tc.count(name), (counts, card.tc)
    assert card.tc == ["conv3x3_dx"] * 2 + ["conv3x3_dw"] * 2 and card.lib == []


def test_a_failed_bwd_tensor_core_launch_counts_nothing(card):
    card.fail = True
    x = torch.empty(1, 5, 6, 8, device="meta", dtype=BF)
    g = torch.empty(1, 5, 6, 16, device="meta", dtype=BF)
    w = torch.empty(3, 3, 8, 16, device="meta", dtype=BF)
    with pytest.raises(RuntimeError, match="launch failed"):
        K.conv3x3_dx(g, g, torch.zeros(3, 16), w)
    with pytest.raises(RuntimeError, match="launch failed"):
        K.conv3x3_dw(x, g, g, torch.zeros(3, 16))
    assert card.lib == []  # no retreat to the CUDA-core kernels
    assert all(v == 0 for v in K.launch_counts().values())


def _unaligned(t):
    """A contiguous view of a copy of ``t`` with a storage offset of one
    element: its data starts 2 (bf16) or 4 (fp32) bytes past a 16-byte
    boundary, so the launchers must copy it."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)
    v = buf[1:].view(t.shape)
    v.copy_(t)
    assert v.is_contiguous() and v.data_ptr() % 16 != 0
    return v


@pytest.mark.parametrize("prologue", [False, True], ids=["raw", "pro"])
def test_dw_launcher_gets_live_distinct_operands(monkeypatch, rng, prologue):
    """conv3x3_dw's aligned copies of unaligned operands stay alive until its
    C function returns: every pointer that function receives is the data of
    a tensor still alive at the call, equal to its operand, and no two
    operands share a pointer (a freed copy's block can go to the next one:
    g and z always have one shape)."""
    x, _, g, z, coef, a, c = _inputs(rng, 1, 5, 6, 8, 16, prologue)
    ops = {"x": x, "a": a, "c": c, "g": g, "z": z, "coef": coef}
    ops = {k: None if v is None else _unaligned(v) for k, v in ops.items()}
    calls = []

    class Lib:
        def tuk_tc_conv3x3_dw(self, *args):
            live = {}
            for t in gc.get_objects():
                if issubclass(type(t), torch.Tensor) and t.device.type == "cpu":
                    live.setdefault(t.data_ptr(), []).append(t)
            ptrs = dict(zip(ops, args[:6]))
            for name, op in ops.items():
                if op is None:
                    assert ptrs[name] is None, name
                    continue
                assert ptrs[name] % 16 == 0, name
                assert any(t.dtype == op.dtype and t.numel() == op.numel()
                           and torch.equal(t.reshape(-1), op.reshape(-1))
                           for t in live.get(ptrs[name], ())), f"{name}: not a live copy"
            given = [p for p in ptrs.values() if p is not None]
            assert len(set(given)) == len(given), ptrs
            calls.append(ptrs)
            return 0

    class Props:
        multi_processor_count = SMS

    monkeypatch.setattr(_build, "validate", lambda kernel, *tensors: _build.DTYPE_BF16)
    monkeypatch.setattr(_build, "library", Lib)
    monkeypatch.setattr(_build, "stream", lambda t: 0)
    monkeypatch.setattr(_build, "on_device", lambda t: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d: Props)
    dw = tc_conv.conv3x3_dw(ops["x"], ops["g"], ops["z"], ops["coef"], ops["a"], ops["c"])
    assert len(calls) == 1 and dw.shape == (3, 3, 8, 16)
