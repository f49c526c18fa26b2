"""The bf16 tensor-core route of ``fused_conv3x3_scale_relu`` and
``conv3x3_fwd`` (``tpu_unet_torch/kernels/tc_conv.py``, kernel
``tpu_unet_torch/csrc/tc_conv.cu``) on the CPU, where the kernel cannot run:

- the tile plan covers every output pixel exactly once at ragged shapes, and
  its stats partial rows are one per (image, tile);
- a plain PyTorch emulation of what the kernel computes (the plan's tiles
  staged with a 1-pixel halo, channels zero-padded to 8 and walked in chunks
  of 32, the 9 taps inside a chunk as shifted windows, the prologue applied
  to in-image positions only, per-tile stats partials of the rounded output
  added in row order) equals the plain versions, and the JAX Pallas kernels;
- the exported C functions match their ctypes signatures, and the Python
  mirrors of the kernel's constants match the source.

Tolerances, |emulation - plain| <= atol + rtol * |plain|: fp32 1e-4 + 1e-4
(the two sum the same exact products in another order over at most 9 * 96
terms); bf16 2e-2 + 2e-2 (both round fp32 sums once, so an output may differ
by one bf16 ulp, 2^-8 relative), the same TOL as chip_smoke.py holds the
kernel to. Stats within 1e-4 (fp32) / 1e-3 (bf16) of their largest value.
"""

import contextlib
import math
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from tpu_unet.kernels.fused_conv import fused_conv3x3_scale_relu as j_conv
from tpu_unet.kernels.train_conv import conv3x3_fwd as j_fwd
from tpu_unet_torch import kernels as K
from tpu_unet_torch.kernels import _build, tc_conv
from tpu_unet_torch.kernels.fused_conv import fused_conv3x3_scale_relu_plain
from tpu_unet_torch.kernels.tc_conv import CONFIGS, KC, tc_plan
from tpu_unet_torch.kernels.train_conv import conv3x3_fwd_plain

TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
STATS_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}

# (n, h, w, cout): ragged shapes, the served forward's and the train step's.
PLAN_SHAPES = [
    (2, 13, 20, 64), (2, 13, 20, 128), (1, 35, 35, 64), (16, 35, 35, 1024),
    (1, 40, 59, 1024), (1, 80, 119, 512), (1, 640, 959, 64), (1, 640, 959, 128),
    (4, 572, 572, 64), (1, 1, 1, 8), (3, 7, 300, 24),
    # tall and narrow: the tallest tile of the image's width does not fit
    # the staging buffer, so the plan must take a shorter one
    (1, 128, 1, 1024), (1, 200, 2, 64), (1, 100, 3, 64),
]


@pytest.mark.parametrize("n,h,w,cout", PLAN_SHAPES)
def test_tc_plan_covers_every_output_pixel_once(n, h, w, cout):
    p = tc_plan(n, h, w, cout)
    assert (p.bm, p.bn, p.kc) == (*CONFIGS[p.cfg][:2], KC)
    max_staged = CONFIGS[p.cfg][2]
    assert 1 <= p.th * p.tw <= p.bm
    assert (p.th + 2) * (p.tw + 2) <= max_staged
    assert p.co_blocks * p.bn >= cout > (p.co_blocks - 1) * p.bn
    assert p.grid == (p.tiles, p.co_blocks, n) and p.partial_rows == n * p.tiles
    cover = np.zeros((h, w), np.int64)
    for t in range(p.tiles):
        h0, w0 = p.tile_origin(t)
        assert 0 <= h0 < h and 0 <= w0 < w  # no tile lies wholly outside
        cover[h0:h0 + p.th, w0:w0 + p.tw] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("h,w,cout,least", [
    (35, 35, 1024, 0.9), (40, 59, 1024, 0.9), (80, 119, 512, 0.9), (13, 20, 64, 0.5),
    (572, 572, 64, 0.98), (640, 959, 64, 0.99),
])
def test_tc_plan_fills_its_tiles(h, w, cout, least):
    """The MMA rows computed (tiles x bm) are mostly real pixels: 35 x 35 on
    fixed 8 x 16 tiles filled only 64%."""
    p = tc_plan(1, h, w, cout)
    assert h * w / (p.tiles * p.bm) >= least, p


def _emulate(x, w, a=None, c=None, scale=None, bias=None, relu=False, stats=False, x2=None,
             out_dtype=None):
    """What tc_conv.cu computes, in plain PyTorch at fp32 on the given
    (possibly bf16) values, rounding where the kernel rounds (to
    ``out_dtype``, x's by default). With ``x2`` the input is the channel
    concat of x and x2, read as the kernel reads it: x's chunks of 32
    channels, then x2's, x2's chunk j against the weight rows Ca + 32 j
    (each source zero-padded to 8 channels, as the wrapper pads it), so
    x's last chunk, when partial, meets x2's first rows with zeros."""
    dt = x.dtype
    n, h, wd, _ = x.shape
    cout = w.shape[3]
    p = tc_plan(n, h, wd, cout)
    kc = p.kc
    srcs = [x] if x2 is None else [x, x2]
    widths = [t.shape[3] for t in srcs]
    pad8 = [math.ceil(cw / 8) * 8 for cw in widths]
    # The weight map's rows: each source's rows zero-padded to 8, then zero
    # rows past the end (the map's fill) for the last chunk.
    wf = torch.cat([torch.nn.functional.pad(part.float(), (0, 0, 0, c8 - cw))
                    for part, cw, c8 in zip(torch.split(w, widths, dim=2), widths, pad8)], dim=2)
    chunks, off = [], 0  # (source, its first channel, first weight row)
    for i, c8 in enumerate(pad8):
        chunks += [(i, k0, off + k0) for k0 in range(0, c8, kc)]
        off += c8
    wf = torch.nn.functional.pad(wf, (0, 0, 0, chunks[-1][2] + kc - off)).reshape(9, -1, cout)
    staged = []
    for t, cw in zip(srcs, widths):
        kin = math.ceil(math.ceil(cw / 8) * 8 / kc) * kc  # zero-padded, whole chunks
        tf = torch.nn.functional.pad(t.float(), (0, kin - cw))
        if a is not None:  # single source: in-image positions only
            af = torch.nn.functional.pad(a.float(), (0, kin - cw))
            cf = torch.nn.functional.pad(c.float(), (0, kin - cw))
            tf = torch.relu(tf * af + cf).to(dt).float()
        staged.append(torch.nn.functional.pad(tf, (0, 0, 1, 1, 1, 1)))  # the halo stays zero
    out = torch.zeros(n, h, wd, cout)
    rows = []
    for b in range(n):
        for t in range(p.tiles):
            h0, w0 = p.tile_origin(t)
            th, tw = min(p.th, h - h0), min(p.tw, wd - w0)
            acc = torch.zeros(th * tw, cout)
            for src, k0, r0 in chunks:  # chunk-major ...
                for tap in range(9):    # ... 9 shifted windows of the staged tile
                    ky, kx = divmod(tap, 3)
                    win = staged[src][b, h0 + ky:h0 + ky + th, w0 + kx:w0 + kx + tw, k0:k0 + kc]
                    acc += win.reshape(-1, kc) @ wf[tap, r0:r0 + kc]
            y = acc if scale is None else acc * scale.float() + bias.float()
            y = (torch.relu(y) if relu else y).to(out_dtype or dt).float()
            out[b, h0:h0 + th, w0:w0 + tw] = y.reshape(th, tw, cout)
            rows.append(torch.stack([y.sum(0), (y * y).sum(0)]))
    z = out.to(out_dtype or dt)
    if not stats:
        return z
    return z, torch.stack(rows).sum(0)  # the fixed-order sum of the partial rows


def _inputs(rng, n, h, w, cin, cout, dtype, prologue):
    x = torch.from_numpy(rng.standard_normal((n, h, w, cin), dtype=np.float32)).to(dtype)
    wt = torch.from_numpy(rng.standard_normal((3, 3, cin, cout), dtype=np.float32)
                          * (9 * cin) ** -0.5).to(dtype)
    if not prologue:
        return x, wt, None, None
    a = torch.from_numpy((0.5 + rng.random(cin)).astype(np.float32))
    c = torch.from_numpy((0.5 * rng.standard_normal(cin)).astype(np.float32))
    c[0] = 0.7  # relu(c) > 0: the SAME padding must still read zeros
    return x, wt, a, c


def _close(got, ref, dtype):
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)


def _close_to_scale(got, ref, frac):
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= frac * ref.float().abs().max().item(), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("prologue", [False, True], ids=["raw", "pro"])
@pytest.mark.parametrize("cin", [3, 64, 96])
def test_emulated_fwd_matches_the_plain_version(rng, cin, prologue, dtype):
    x, w, a, c = _inputs(rng, 2, 13, 20, cin, 16, dtype, prologue)
    z, s = _emulate(x, w, a, c, stats=True)
    pz, ps = conv3x3_fwd_plain(x, w, a, c, stats=True)
    assert z.dtype == dtype and s.shape == (2, 16)
    _close(z, pz, dtype)
    _close_to_scale(s, ps, STATS_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("relu", [False, True], ids=["linear", "relu"])
@pytest.mark.parametrize("cin", [3, 64, 96])
def test_emulated_fused_conv_matches_the_plain_version(rng, cin, relu, dtype):
    x, w, _, _ = _inputs(rng, 1, 11, 17, cin, 72, dtype, False)
    scale = torch.from_numpy(1.0 + 0.1 * rng.standard_normal(72, dtype=np.float32))
    bias = torch.from_numpy(0.1 * rng.standard_normal(72, dtype=np.float32))
    y = _emulate(x, w, scale=scale, bias=bias, relu=relu)
    _close(y, fused_conv3x3_scale_relu_plain(x, w, scale, bias, apply_relu=relu), dtype)


@pytest.mark.parametrize("h,w,cout", [(100, 3, 64), (128, 1, 128)])
def test_emulated_fwd_matches_the_plain_version_on_a_narrow_image(rng, h, w, cout):
    """Tiles shorter than the image's height, as tc_plan picks them there."""
    x, wt, a, c = _inputs(rng, 1, h, w, 16, cout, torch.bfloat16, True)
    assert tc_plan(1, h, w, cout).tiles_h > 1
    z, s = _emulate(x, wt, a, c, stats=True)
    pz, ps = conv3x3_fwd_plain(x, wt, a, c, stats=True)
    _close(z, pz, torch.bfloat16)
    _close_to_scale(s, ps, STATS_TOL[torch.bfloat16])


def test_emulated_kernels_match_pallas(rng):
    """The emulation against the Pallas kernels in interpret mode, bf16, at a
    shape whose plan has ragged tiles (35 x 35 at Cout 128)."""
    x, w, a, c = _inputs(rng, 1, 35, 35, 16, 128, torch.bfloat16, True)
    scale = torch.ones(128)
    bias = torch.from_numpy(0.1 * rng.standard_normal(128, dtype=np.float32))
    jx, jw = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (x, w))
    with pltpu.force_tpu_interpret_mode():
        jz, js = j_fwd(jx, jw, jnp.asarray(a.numpy()), jnp.asarray(c.numpy()), stats=True)
        jy = j_conv(jx, jw, jnp.asarray(scale.numpy()), jnp.asarray(bias.numpy()))
    z, s = _emulate(x, w, a, c, stats=True)
    y = _emulate(x, w, scale=scale, bias=bias, relu=True)
    _close(z, torch.from_numpy(np.asarray(jz, np.float32)), torch.bfloat16)
    _close_to_scale(s, torch.from_numpy(np.array(js)), 1e-2)
    _close(y, torch.from_numpy(np.asarray(jy, np.float32)), torch.bfloat16)


def test_tc_c_interface_matches_the_ctypes_signatures():
    src = (_build.CSRC_DIR / "tc_conv.cu").read_text()
    for name in ("tuk_tc_fused_conv3x3", "tuk_tc_concat_conv3x3", "tuk_tc_im2col_conv3x3",
                 "tuk_tc_conv3x3_fwd"):
        head = f'extern "C" int {name}('
        assert head in src, name
        params = src.split(head, 1)[1].split(")", 1)[0]
        assert params.count(",") + 1 == len(_build._SIGNATURES[name][0]), name


def test_python_mirrors_of_the_kernel_constants_match_the_source():
    src = (_build.CSRC_DIR / "tc_conv.cu").read_text()
    common = (_build.CSRC_DIR / "tc_common.cuh").read_text()  # KC, shared with the double conv
    assert '#include "tc_common.cuh"' in src
    assert int(re.search(r"constexpr int KC = (\d+);", common).group(1)) == KC
    found = {int(m.group(1)): tuple(int(v) for v in m.group(2).split(","))
             for m in re.finditer(r"using Cfg(\d+) = Config<([\d, ]+)>;", src)}
    assert set(found) == set(CONFIGS)
    for cfg, (bm, bn, max_staged) in CONFIGS.items():
        # Config<BM, BN, WM, WN, MAX_STAGED, MIN_BLOCKS>
        cbm, cbn, wm, wn, cmax, _ = found[cfg]
        assert (cbm, cbn, cmax) == (bm, bn, max_staged), cfg
        assert bm % (16 * wm) == 0 and bn % (16 * wn) == 0 and bn % 64 == 0, cfg
        assert f"TUK_TC_CASE({cfg})" in src, cfg


def _fwd(x, w):
    return tc_conv.conv3x3_fwd(x, w, None, None, stats=False)


def _fused(x, w):
    return tc_conv.fused_conv3x3(x, w, torch.ones(8), torch.zeros(8), True)


# (launcher, the dtype it refuses past the device check, the error's words):
# conv3x3_fwd and the fused conv take fp32 too (3xTF32) and refuse any other
# type.
@pytest.mark.parametrize("launch,refused,match", [
    (_fwd, torch.float16, "bfloat16 or float32"),
    (_fused, torch.float16, "bfloat16 or float32"),
], ids=["conv3x3_fwd", "fused_conv3x3"])
def test_tc_launchers_refuse_cpu_and_fp32_tensors(monkeypatch, launch, refused, match):
    x = torch.zeros(1, 4, 4, 8, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 8, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA device"):
        launch(x, w)
    # Past the device check, a refused dtype raises before any build.
    monkeypatch.setattr(_build, "validate", lambda kernel, *tensors: _build.DTYPE_F32)
    monkeypatch.setattr(_build, "library", lambda: pytest.fail("built a library"))
    with pytest.raises(ValueError, match=match):
        launch(x.to(refused), w.to(refused))


def test_cpu_bf16_calls_count_no_tensor_core_launch():
    """On CPU tensors the wrappers run their plain versions; the ``.tc``
    counts sit beside the others and reset with them."""
    K.fused_conv3x3_scale_relu.tc_launches = 5
    K.reset_launch_counts()
    x = torch.randn(1, 5, 6, 8).to(torch.bfloat16)
    w = torch.randn(3, 3, 8, 8).to(torch.bfloat16)
    K.fused_conv3x3_scale_relu(x, w, torch.ones(8), torch.zeros(8))
    K.fused_conv3x3_concat_scale_relu(x, x, torch.cat([w, w], 2), torch.ones(8), torch.zeros(8))
    K.conv3x3_fwd(x, w, stats=True)
    K.im2col_conv3x3(x, w, torch.ones(8), torch.zeros(8), out_dtype=torch.float32)
    counts = K.launch_counts()
    assert {f"{fn.__name__}.tc" for fn in K.TC_WRAPPERS} <= set(counts)
    assert all(v == 0 for v in counts.values()), counts


class _Card:
    """Meta tensors stand in for CUDA ones, so the wrappers take their launch
    routes on the CPU: the tensor-core launchers and the C library are
    replaced by recorders that launch nothing."""

    def __init__(self, monkeypatch):
        self.tc = []     # tensor-core launcher calls
        self.lib = []    # C library calls
        self.fail = False
        card = self

        class Lib:
            def __getattr__(self, name):
                def call(*args):
                    card.lib.append(name)
                    return 0
                return call

        def record(name):
            if card.fail:
                raise RuntimeError(f"{name}: launch failed")
            card.tc.append(name)

        def launcher(name):
            def launch(x, w, *args):
                record(name)
                z = torch.empty(x.shape[:3] + (w.shape[3],), dtype=x.dtype, device=x.device)
                if name == "conv3x3_fwd" and args[-1]:  # stats
                    return z, torch.empty(2, w.shape[3], device=x.device)
                return z
            return launch

        def launch_concat(a, b, w, *args):
            record("fused_conv3x3_concat_scale_relu")
            return torch.empty(a.shape[:3] + (w.shape[3],), dtype=a.dtype, device=a.device)

        def launch_im2col(x, w, scale, bias, relu, out_dtype):
            record("im2col_conv3x3")
            return torch.empty(x.shape[:3] + (w.shape[3],), dtype=out_dtype, device=x.device)

        def launch_dx(g, z, coef, w, out_dtype):  # w: the forward weights [3,3,Cin,C]
            record("conv3x3_dx")
            return torch.empty(g.shape[:3] + (w.shape[2],), dtype=out_dtype, device=g.device)

        def launch_dw(x, g, z, coef, a, c):
            record("conv3x3_dw")
            return torch.empty(3, 3, x.shape[3], g.shape[3], device=x.device)

        def launch_dc(x, w1, s1, b1, w2, s2, b2, pool):
            record("fused_double_conv")
            y = torch.empty(x.shape[:3] + (w2.shape[3],), dtype=x.dtype, device=x.device)
            return y, (y[:, : y.shape[1] // 2, : y.shape[2] // 2].clone() if pool else None)

        def validate(kernel, *tensors):
            return _build.DTYPE_BF16 if tensors[0].dtype == torch.bfloat16 else _build.DTYPE_F32

        class Props:
            multi_processor_count = 132

        monkeypatch.setattr(_build, "validate", validate)
        monkeypatch.setattr(_build, "library", Lib)
        monkeypatch.setattr(_build, "stream", lambda t: 0)
        monkeypatch.setattr(_build, "on_device", lambda t: contextlib.nullcontext())
        monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d: Props)
        monkeypatch.setattr(tc_conv, "fused_conv3x3", launcher("fused_conv3x3_scale_relu"))
        monkeypatch.setattr(tc_conv, "fused_conv3x3_concat", launch_concat)
        monkeypatch.setattr(tc_conv, "im2col_conv3x3", launch_im2col)
        monkeypatch.setattr(tc_conv, "conv3x3_fwd", launcher("conv3x3_fwd"))
        monkeypatch.setattr(tc_conv, "conv3x3_dx", launch_dx)
        monkeypatch.setattr(tc_conv, "conv3x3_dw", launch_dw)
        monkeypatch.setattr(tc_conv, "double_conv", launch_dc)


@pytest.fixture
def card(monkeypatch):
    K.reset_launch_counts()
    yield _Card(monkeypatch)
    K.reset_launch_counts()


def _meta_calls(dtype):
    """One call of the fused and the concat conv and two each of
    conv3x3_fwd and of im2col_conv3x3 (both output dtypes), on meta
    tensors."""
    x = torch.empty(1, 5, 6, 8, device="meta", dtype=dtype)
    w = torch.empty(3, 3, 8, 8, device="meta", dtype=dtype)
    w2 = torch.empty(3, 3, 16, 8, device="meta", dtype=dtype)
    one, zero = torch.ones(8), torch.zeros(8)
    K.fused_conv3x3_scale_relu(x, w, one, zero)
    K.fused_conv3x3_concat_scale_relu(x, x, w2, one, zero)
    K.conv3x3_fwd(x, w, stats=True)
    K.conv3x3_fwd(x, w, one, zero)
    for out_dtype in (None, torch.float32):
        assert K.im2col_conv3x3(x, w, one, zero, out_dtype=out_dtype).dtype == (out_dtype or dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_tc_counts_follow_the_tensor_core_launcher(card, dtype):
    """Each ``.tc`` count moves once per call of its tensor-core launcher and
    never otherwise; every launch, on either route, moves the wrapper's own."""
    _meta_calls(dtype)
    counts = K.launch_counts()
    assert counts["fused_conv3x3_scale_relu"] == counts["fused_conv3x3_concat_scale_relu"] == 1
    assert counts["conv3x3_fwd"] == counts["im2col_conv3x3"] == 2
    for name in ("fused_conv3x3_scale_relu", "fused_conv3x3_concat_scale_relu", "conv3x3_fwd",
                 "im2col_conv3x3"):
        assert counts[f"{name}.tc"] == card.tc.count(name), (counts, card.tc)
    # every call on the tensor cores in both dtypes (fp32 in 3xTF32), none
    # in the C library's other kernels
    assert card.tc == ["fused_conv3x3_scale_relu", "fused_conv3x3_concat_scale_relu"] + [
        "conv3x3_fwd"] * 2 + ["im2col_conv3x3"] * 2
    assert card.lib == []


def test_a_failed_tensor_core_launch_counts_nothing(card):
    card.fail = True
    x = torch.empty(1, 5, 6, 8, device="meta", dtype=torch.bfloat16)
    w = torch.empty(3, 3, 8, 8, device="meta", dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="launch failed"):
        K.fused_conv3x3_scale_relu(x, w, torch.ones(8), torch.zeros(8))
    with pytest.raises(RuntimeError, match="launch failed"):
        K.conv3x3_fwd(x, w, stats=True)
    with pytest.raises(RuntimeError, match="launch failed"):
        K.fused_conv3x3_concat_scale_relu(x, x, torch.cat([w, w], 2), torch.ones(8),
                                          torch.zeros(8))
    with pytest.raises(RuntimeError, match="launch failed"):
        K.im2col_conv3x3(x, w, torch.ones(8), torch.zeros(8))
    assert card.lib == []  # no retreat to the CUDA-core kernels
    assert all(v == 0 for v in K.launch_counts().values())
