"""The fp32 tensor-core routes of ``conv3x3_dx`` and
``fused_conv3x3_concat_scale_relu`` in 3xTF32 (``tuk_tc_conv3x3_dx_f32``
and ``tuk_tc_concat_conv3x3_f32`` in ``tpu_unet_torch/csrc/tc_conv.cu``,
through ``tpu_unet_torch/kernels/tc_conv.py``) on the CPU, where the kernels
cannot run:

- emulations of what each kernel computes, in its own order: the fp32 tile
  plan, chunk-major over KC_F32 = 16 channels with the 9 taps inside, per
  k8 step lo*hi + hi*lo + hi*hi into a fresh sum added to the accumulator
  (``_mm3`` of ``tests/test_torch_tc_fp32.py``). dx builds dz = alpha*g +
  beta*z + gamma in fp32 on in-image positions only and reads the forward
  weights with the taps reversed; the concat conv reads the skip's chunks,
  then the upsampled tensor's against the weight rows Ca + 16 j, and ends
  with acc * scale + bias (ReLU optional). Each is held to the plain
  version and to the JAX Pallas kernel in interpret mode;
- the fp32 dx's block configurations (a 3-k-step weight ring for the 128 x
  128 block, whose aux slot would otherwise leave one block an SM) match
  the Python mirrors, and two blocks an SM fit at every train-step dx
  shape; the concat conv's at its four served shapes;
- on recording launchers: fp32 dx and the fp32 concat conv pass the fp32
  plan and a weight-split buffer to their C functions, reach the
  tensor-core launchers from the wrappers and count ``.tc``; a failed
  launch counts nothing and reaches no other kernel.

Tolerance, as ``chip_smoke.py`` holds the kernels: 1e-4 + 1e-4 * |plain|
(the same sums of products, each to about 2^-21, in another order, over at
most 9 * 1024 terms); the same against Pallas (fp32 on the CPU).
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
from tests.test_torch_tc_fp32 import STEP_SHAPES, _mm3, _Recorder, _up_align
from tpu_unet.kernels.fused_conv import fused_conv3x3_concat_scale_relu as j_concat
from tpu_unet.kernels.train_conv import conv3x3_dx as j_dx
from tpu_unet_torch import kernels as K
from tpu_unet_torch.kernels import _build, tc_conv
from tpu_unet_torch.kernels.fused_conv import fused_conv3x3_concat_scale_relu_plain
from tpu_unet_torch.kernels.tc_conv import (
    F32_CONFIGS,
    F32_DX_STAGES,
    KC_F32,
    STAGES,
    tc_plan,
)
from tpu_unet_torch.kernels.train_conv import conv3x3_dx_plain

F32 = torch.float32
TOL = (1e-4, 1e-4)


def _ceil8(v):
    return -(-v // 8) * 8


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(got, ref):
    torch.testing.assert_close(got, ref, atol=TOL[0], rtol=TOL[1])


def _emulate_dx(g, z, coef, w):
    """What tuk_tc_conv3x3_dx_f32 computes: the fp32 plan of the output
    width (the forward's Cin); dz in fp32 in the plain version's order on
    in-image positions (the halo and the channels past C keep the fill's
    zeros); chunk-major over KC_F32 channels, 9 shifted windows a chunk, two
    k8 steps a window; B of tap t the forward weights' tap 8 - t, [Cin][C]
    as it lies in HWIO (K = C contiguous)."""
    n, h, wd, ch = g.shape
    cin = w.shape[2]
    p = tc_plan(n, h, wd, _ceil8(cin), True)
    assert p.kc == KC_F32
    kin = math.ceil(_ceil8(ch) / KC_F32) * KC_F32
    dz = (coef[0] * g + coef[1] * z) + coef[2]
    dzh = F.pad(F.pad(dz, (0, kin - ch)), (0, 0, 1, 1, 1, 1))
    planes = F.pad(w.reshape(9, cin, ch).flip(0), (0, kin - ch))  # plane t = w[8 - t]
    out = torch.zeros(n, h, wd, cin)
    for b in range(n):
        for t in range(p.tiles):
            h0, w0 = p.tile_origin(t)
            th, tw = min(p.th, h - h0), min(p.tw, wd - w0)
            acc = torch.zeros(th * tw, cin)
            for k0 in range(0, kin, KC_F32):
                for tap in range(9):
                    ky, kx = divmod(tap, 3)
                    win = dzh[b, h0 + ky:h0 + ky + th, w0 + kx:w0 + kx + tw, k0:k0 + KC_F32]
                    win = win.reshape(-1, KC_F32)
                    for k8 in (0, 8):
                        acc = acc + _mm3(win[:, k8:k8 + 8], planes[tap, :, k0 + k8:k0 + k8 + 8].T)
            out[b, h0:h0 + th, w0:w0 + tw] = acc.reshape(th, tw, cin)
    return out


def _concat_chunks(ca, cb):
    """(source, its first channel, first weight row) of each K chunk: the
    skip's channels (padded to 8, as the wrapper pads them) in chunks of
    KC_F32, then the upsampled tensor's, its chunk j against the rows Ca8 +
    16 j."""
    ca8, cb8 = _ceil8(ca), _ceil8(cb)
    return ([(0, k0, k0) for k0 in range(0, ca8, KC_F32)]
            + [(1, k0, ca8 + k0) for k0 in range(0, cb8, KC_F32)])


def _emulate_concat(a, b, w, scale, bias, relu):
    """What tuk_tc_concat_conv3x3_f32 computes: the fp32 plan; the chunks of
    ``_concat_chunks``, each source staged with a zero halo and zeros past
    its channels (a partial last chunk of the skip meets the upsampled
    tensor's first weight rows with zeros); two k8 steps a window; then
    acc * scale, + bias, each rounded, ReLU optional."""
    n, h, wd, ca = a.shape
    cb, cout = b.shape[3], w.shape[3]
    ca8, cb8 = _ceil8(ca), _ceil8(cb)
    p = tc_plan(n, h, wd, _ceil8(cout), True)
    rows = torch.cat([F.pad(w[:, :, :ca], (0, 0, 0, ca8 - ca)),
                      F.pad(w[:, :, ca:], (0, 0, 0, cb8 - cb))], dim=2).reshape(9, -1, cout)
    rows = F.pad(rows, (0, 0, 0, KC_F32))  # the map's zero fill past Ca8 + Cb8
    staged = [F.pad(F.pad(t, (0, math.ceil(_ceil8(c) / KC_F32) * KC_F32 - c)), (0, 0, 1, 1, 1, 1))
              for t, c in ((a, ca), (b, cb))]
    out = torch.zeros(n, h, wd, cout)
    for bi in range(n):
        for t in range(p.tiles):
            h0, w0 = p.tile_origin(t)
            th, tw = min(p.th, h - h0), min(p.tw, wd - w0)
            acc = torch.zeros(th * tw, cout)
            for src, k0, r0 in _concat_chunks(ca, cb):
                for tap in range(9):
                    ky, kx = divmod(tap, 3)
                    win = staged[src][bi, h0 + ky:h0 + ky + th, w0 + kx:w0 + kx + tw,
                                      k0:k0 + KC_F32].reshape(-1, KC_F32)
                    for k8 in (0, 8):
                        acc = acc + _mm3(win[:, k8:k8 + 8], rows[tap, r0 + k8:r0 + k8 + 8])
            y = acc * scale + bias
            out[bi, h0:h0 + th, w0:w0 + tw] = (torch.relu(y) if relu else y).reshape(th, tw, cout)
    return out


def _dx_inputs(rng, n, h, w, ch, cin):
    """fp32 g, z, coef with gamma != 0 (a leak into the SAME padding would
    show), and the forward weights [3,3,Cin,C]."""
    g = _t(rng.standard_normal((n, h, w, ch)))
    z = _t(rng.standard_normal((n, h, w, ch)))
    coef = _t(np.stack([np.ones(ch), 0.3 * rng.standard_normal(ch),
                        0.5 + 0.2 * rng.standard_normal(ch)]))
    wt = _t(rng.standard_normal((3, 3, cin, ch)) * (9 * ch) ** -0.5)
    return g, z, coef, wt


def _concat_inputs(rng, n, h, w, ca, cb, cout):
    a = _t(rng.standard_normal((n, h, w, ca)))
    b = _t(rng.standard_normal((n, h, w, cb)))
    wt = _t(rng.standard_normal((3, 3, ca + cb, cout)) * (9 * (ca + cb)) ** -0.5)
    return a, b, wt, _t(1.0 + 0.1 * rng.standard_normal(cout)), _t(0.1 * rng.standard_normal(cout))


# (n, h, w, C, Cin) of dx: ragged tiles in both configurations (Cin <= 64 and
# > 64); a forward Cin of 3, padded to 8; C = 40, a partial KC_F32 chunk; a
# narrow image, whose tiles are shorter than it.
DX_CASES = [(2, 13, 20, 16, 24), (1, 11, 17, 24, 72), (2, 11, 17, 16, 3), (1, 9, 12, 40, 16),
            (1, 100, 3, 16, 64)]


@pytest.mark.parametrize("n,h,w,ch,cin", DX_CASES,
                         ids=["ragged", "cout>64", "cin3", "c40", "narrow"])
def test_emulated_fp32_dx_matches_the_plain_version(rng, n, h, w, ch, cin):
    g, z, coef, wt = _dx_inputs(rng, n, h, w, ch, cin)
    got = _emulate_dx(g, z, coef, wt)
    assert got.shape == (n, h, w, cin)
    if h == 100:
        assert tc_plan(n, h, w, cin, True).tiles_h > 1
    _close(got, conv3x3_dx_plain(g, z, coef, wt, out_dtype=F32))


def test_fp32_dz_stays_zero_in_the_padding():
    """gamma = 1 with g = z = 0 gives dz = 1 inside the image and 0 outside:
    a border pixel of dx sees fewer ones than an interior one, exactly."""
    g = torch.zeros(1, 4, 5, 8)
    coef = torch.stack([torch.ones(8), torch.zeros(8), torch.ones(8)])
    w = torch.ones(3, 3, 8, 8)
    dx = _emulate_dx(g, g, coef, w)[0, :, :, 0]
    assert dx[1, 1] == 72 and dx[0, 0] == 32 and dx[0, 2] == 48
    assert torch.equal(dx, conv3x3_dx_plain(g, g, coef, w, out_dtype=F32)[0, :, :, 0])


# (Ca, Cb, Cout): Ca = 40 leaves the skip's last 16-channel chunk half full
# (Ca % 16 == 8); 64 + 64 -> 64 is level 0's; Ca = 8 a chunk that is half
# zeros before the upsampled tensor's.
CONCAT_WIDTHS = [(40, 24, 72), (64, 64, 64), (8, 16, 16)]


@pytest.mark.parametrize("relu", [False, True], ids=["linear", "relu"])
@pytest.mark.parametrize("ca,cb,cout", CONCAT_WIDTHS)
def test_emulated_fp32_concat_matches_the_plain_version(rng, ca, cb, cout, relu):
    a, b, w, scale, bias = _concat_inputs(rng, 2, 11, 17, ca, cb, cout)
    got = _emulate_concat(a, b, w, scale, bias, relu)
    _close(got, fused_conv3x3_concat_scale_relu_plain(a, b, w, scale, bias, apply_relu=relu))


def test_the_skips_partial_chunk_adds_nothing_to_the_upsampled_rows(rng):
    """Ca = 40: the skip's last chunk (channels 32-47) reads zeros past Ca
    against weight rows 40-47, the upsampled tensor's first rows. Scaled up
    a thousandfold, those rows still change the result only as the plain
    version's, through the upsampled tensor's first chunk."""
    assert _concat_chunks(40, 24) == [(0, 0, 0), (0, 16, 16), (0, 32, 32), (1, 0, 40),
                                      (1, 16, 56)]
    a, b, w, scale, bias = _concat_inputs(rng, 1, 9, 10, 40, 24, 16)
    w[:, :, 40:48] *= 1e3
    ref = fused_conv3x3_concat_scale_relu_plain(a, b, w, scale, bias, apply_relu=False)
    torch.testing.assert_close(_emulate_concat(a, b, w, scale, bias, False), ref,
                               atol=TOL[0] * 1e3, rtol=TOL[1])


def _jnp(t):
    return jnp.asarray(t.numpy())


def _np(j):
    return torch.from_numpy(np.array(j, np.float32))


def test_emulated_fp32_dx_matches_pallas(rng):
    """fp32 at 35 x 35 (ragged tiles), C = 40 (a partial chunk), against the
    Pallas kernel in interpret mode."""
    g, z, coef, wt = _dx_inputs(rng, 1, 35, 35, 40, 24)
    with pltpu.force_tpu_interpret_mode():
        ref = j_dx(_jnp(g), _jnp(z), _jnp(coef), _jnp(wt))
    _close(_emulate_dx(g, z, coef, wt), _np(ref))


@pytest.mark.parametrize("n,h,w,ca,cb,cout", [(1, 13, 21, 40, 24, 72), (1, 35, 35, 16, 16, 128)])
def test_emulated_fp32_concat_matches_pallas(rng, n, h, w, ca, cb, cout):
    a, b, wt, scale, bias = _concat_inputs(rng, n, h, w, ca, cb, cout)
    with pltpu.force_tpu_interpret_mode():
        ref = j_concat(_jnp(a), _jnp(b), _jnp(wt), _jnp(scale), _jnp(bias))
    _close(_emulate_concat(a, b, wt, scale, bias, True), _np(ref))


def _smem(cfg: int, stages: int, aux: bool) -> int:
    """One fp32 block's dynamic shared memory, as Config::SMEM plus
    smem_bytes' aux slot: the alignment slack, two input slots, the weight
    ring of both planes [2][BN][KC_F32], the stats scratch, the mbarriers;
    with ``aux`` one more input slot and its mbarrier."""
    bm, bn, max_staged = F32_CONFIGS[cfg]
    warps = bm * bn // (64 * 64)
    in_slot = _up_align(max_staged * 64)
    return (1024 + 2 * in_slot + stages * 2 * bn * KC_F32 * 4 + warps * 2 * bn * 4
            + (2 + stages) * 8 + (in_slot + 8 if aux else 0))


def _two_blocks_fit(smem: int) -> bool:
    return 2 * (smem + 1024) <= 228 * 1024  # 1 KB the card reserves a block


def test_python_mirrors_of_the_fp32_dx_configurations_match_the_source():
    """F32DxCfg0 is F32Cfg0's block with a 3-k-step weight ring (with 4 its
    aux slot would leave one block an SM), F32DxCfg1 is F32Cfg1; both are
    reachable from the dispatch."""
    src = (_build.CSRC_DIR / "tc_conv.cu").read_text()
    assert int(re.search(r"constexpr int STAGES = (\d+);", src).group(1)) == STAGES
    fwd = {int(m.group(1)): m.group(2)
           for m in re.finditer(r"using F32Cfg(\d+) = Config<([\d, ]+), Tf32x3Op>;", src)}
    dx = {int(m.group(1)): (m.group(2), int(m.group(3)))
          for m in re.finditer(r"using F32DxCfg(\d+) = Config<([\d, ]+), Tf32x3Op, (\d+)>;", src)}
    same = {int(m.group(1)) for m in re.finditer(r"using F32DxCfg(\d+) = F32Cfg\1;", src)}
    assert set(dx) | same == set(F32_DX_STAGES) == set(F32_CONFIGS)
    for cfg, stages in F32_DX_STAGES.items():
        if cfg in same:
            assert stages == STAGES, cfg
        else:
            assert dx[cfg] == (fwd[cfg], stages), cfg
    assert "std::conditional_t<Load::kAux, F32DxCfg##ID, F32Cfg##ID>" in src
    assert not _two_blocks_fit(_smem(0, STAGES, aux=True))  # why F32DxCfg0 exists


@pytest.mark.parametrize("n,h,w,cin,cout", STEP_SHAPES)
def test_fp32_dx_fits_two_blocks_an_sm(n, h, w, cin, cout):
    """dx's output width is the forward's Cin: its plan and configuration."""
    p = tc_plan(n, h, w, _ceil8(cin), True)
    bm, _, max_staged = F32_CONFIGS[p.cfg]
    assert p.th * p.tw <= bm and (p.th + 2) * (p.tw + 2) <= max_staged
    assert _two_blocks_fit(_smem(p.cfg, F32_DX_STAGES[p.cfg], aux=True))


# The served forward's four decoder concat convs: (n, h, w, Ca + Cb, Cout).
SERVED_CONCAT = [(1, 640, 959, 128, 64), (1, 80, 119, 1024, 512), (1, 160, 239, 512, 256),
                 (1, 320, 479, 256, 128)]


@pytest.mark.parametrize("n,h,w,cin,cout", SERVED_CONCAT)
def test_fp32_concat_fits_two_blocks_an_sm(n, h, w, cin, cout):
    p = tc_plan(n, h, w, cout, True)
    bm, _, max_staged = F32_CONFIGS[p.cfg]
    assert p.th * p.tw <= bm and (p.th + 2) * (p.tw + 2) <= max_staged
    assert _two_blocks_fit(_smem(p.cfg, STAGES, aux=False))


def test_new_c_interface_matches_the_ctypes_signatures():
    src = (_build.CSRC_DIR / "tc_conv.cu").read_text()
    for name in ("tuk_tc_conv3x3_dx_f32", "tuk_tc_concat_conv3x3_f32"):
        head = f'extern "C" int {name}('
        assert head in src, name
        params = src.split(head, 1)[1].split(")", 1)[0]
        assert params.count(",") + 1 == len(_build._SIGNATURES[name][0]), name
    gone = "".join(p.read_text() for p in _build.sources())
    for name in ("tconv_kernel", "DzIn", "tuk_conv3x3_dx("):
        assert name not in gone, name


@pytest.fixture
def lib(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(_build, "validate", lambda kernel, *tensors: _build.DTYPE_F32)
    monkeypatch.setattr(_build, "library", lambda: rec)
    monkeypatch.setattr(_build, "stream", lambda t: 0)
    monkeypatch.setattr(_build, "on_device", lambda t: contextlib.nullcontext())
    return rec


def test_fp32_dx_launcher_passes_the_fp32_plan_and_a_split_buffer(lib):
    """tuk_tc_conv3x3_dx_f32 gets every argument of its signature: the
    forward weights as they are (padded to [3,3,Cin8,C8], no flipped copy),
    a [2, 9, Cin8, C8] split buffer, C and Cin padded to 8, the fp32 plan of
    the output width."""
    g = torch.zeros(2, 13, 20, 12)
    w = torch.arange(3 * 3 * 3 * 12, dtype=F32).reshape(3, 3, 3, 12)
    dx = tc_conv.conv3x3_dx(g, g, torch.zeros(3, 12), w, F32)
    (name, args), = lib.calls
    assert name == "tuk_tc_conv3x3_dx_f32"
    assert len(args) == len(_build._SIGNATURES[name][0])
    p = tc_plan(2, 13, 20, 8, True)
    assert args[6:] == (2, 13, 20, 16, 8, p.cfg, p.th, p.tw, 0)
    assert all(isinstance(v, int) for v in args[:6])
    assert dx.shape == (2, 13, 20, 3) and dx.dtype == F32


def test_fp32_dx_launcher_refuses_a_bf16_output(monkeypatch):
    monkeypatch.setattr(_build, "validate", lambda kernel, *tensors: _build.DTYPE_F32)
    monkeypatch.setattr(_build, "library", lambda: pytest.fail("built a library"))
    g = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError, match="fp32 dx"):
        tc_conv.conv3x3_dx(g, g, torch.zeros(3, 8), torch.zeros(3, 3, 8, 8), torch.bfloat16)


def test_fp32_concat_launcher_passes_the_fp32_plan_and_a_split_buffer(lib):
    """tuk_tc_concat_conv3x3_f32 gets every argument of its signature: each
    source padded to 8 channels, Cout to 8, the fp32 plan, a [2, 9, Cout8,
    Ca8 + Cb8] split buffer; the fp32 output cut back to Cout."""
    a = torch.zeros(1, 7, 9, 40)
    b = torch.zeros(1, 7, 9, 20)
    w = torch.zeros(3, 3, 60, 70)
    y = tc_conv.fused_conv3x3_concat(a, b, w, torch.ones(70), torch.zeros(70), True)
    (name, args), = lib.calls
    assert name == "tuk_tc_concat_conv3x3_f32"
    assert len(args) == len(_build._SIGNATURES[name][0])
    p = tc_plan(1, 7, 9, 72, True)
    assert args[7:] == (1, 7, 9, 40, 24, 72, 1, p.cfg, p.th, p.tw, 0)
    assert y.shape == (1, 7, 9, 70) and y.dtype == F32


@pytest.fixture
def card(monkeypatch):
    K.reset_launch_counts()
    yield _Card(monkeypatch)
    K.reset_launch_counts()


def test_fp32_dx_and_concat_count_tensor_core_launches(card):
    """On meta tensors standing in for CUDA ones: fp32 dx (both ways its
    output dtype is given), the fp32 concat conv and the fp32 single conv
    reach their tensor-core launchers and count ``.tc``; none reaches the
    CUDA-core library."""
    g = torch.empty(1, 5, 6, 16, device="meta")
    x = torch.empty(1, 5, 6, 8, device="meta")
    w = torch.empty(3, 3, 8, 16, device="meta")
    wc = torch.empty(3, 3, 16, 16, device="meta")
    one, zero = torch.ones(16), torch.zeros(16)
    assert K.conv3x3_dx(g, g, torch.zeros(3, 16), w).shape == (1, 5, 6, 8)
    K.conv3x3_dx(g, g, torch.zeros(3, 16), w, out_dtype=F32)
    K.fused_conv3x3_concat_scale_relu(x, x, wc, one, zero)
    K.fused_conv3x3_scale_relu(x, w, one, zero)
    counts = K.launch_counts()
    assert card.tc == ["conv3x3_dx"] * 2 + ["fused_conv3x3_concat_scale_relu",
                                             "fused_conv3x3_scale_relu"]
    assert card.lib == []
    assert counts["conv3x3_dx"] == counts["conv3x3_dx.tc"] == 2
    assert counts["fused_conv3x3_concat_scale_relu"] == 1
    assert counts["fused_conv3x3_concat_scale_relu.tc"] == 1
    assert counts["fused_conv3x3_scale_relu"] == counts["fused_conv3x3_scale_relu.tc"] == 1


def test_a_failed_fp32_tensor_core_launch_counts_nothing(card):
    card.fail = True
    g = torch.empty(1, 5, 6, 16, device="meta")
    x = torch.empty(1, 5, 6, 8, device="meta")
    w = torch.empty(3, 3, 8, 16, device="meta")
    with pytest.raises(RuntimeError, match="launch failed"):
        K.conv3x3_dx(g, g, torch.zeros(3, 16), w)
    with pytest.raises(RuntimeError, match="launch failed"):
        K.fused_conv3x3_concat_scale_relu(x, x, torch.empty(3, 3, 16, 16, device="meta"),
                                          torch.ones(16), torch.zeros(16))
    assert card.lib == []  # no retreat to the CUDA-core kernels
    assert all(v == 0 for v in K.launch_counts().values())
