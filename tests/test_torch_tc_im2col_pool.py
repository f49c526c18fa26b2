"""fp32 ``im2col_conv3x3`` on the tensor cores (3xTF32, ``tuk_tc_im2col_conv3x3_f32``
in ``tpu_unet_torch/csrc/tc_conv.cu``) and the redesigned ``max_pool2x2``
(``tpu_unet_torch/csrc/pooling.cu``, its plan ``kernels/pooling.py``
``pool_plan``) on the CPU, where the kernels cannot run:

- meta tensors on the recording launchers of ``tests/test_torch_tc_conv.py``:
  fp32 im2col makes one tensor-core launch and no other C-library call, for
  fp32 and bf16 output, with and without ReLU, and at Cin 320 (past the 256
  that the removed CUDA-core kernel took); a failed launch counts nothing;
- the launcher hands ``tuk_tc_im2col_conv3x3_f32`` the fp32 plan, a split
  buffer and the output dtype; both new C parameter lists match their
  ctypes signatures; the CUDA-core im2col conv and its exports are gone;
- the plain version with fp32 x and bf16 out against the JAX kernel, and a
  torch emulation of the 3xTF32 route (``tests/test_torch_tc_fp32.py``'s,
  then the epilogue's multiply, add, ReLU and one rounding) against the JAX
  kernel in interpret mode;
- the pool: the plain version equals the JAX kernel in both dtypes at odd H
  and W with NaNs placed in windows; a numpy emulation of the kernel's
  indexing under ``pool_plan`` (the block's row and chunk, each thread's
  pixel and channel vectors, its 32-bit offsets, the max order) writes
  every output vector exactly once and equals the plain version, at both
  shapes ``chip_smoke.py`` times, in both dtypes, and on the scalar path;
  the plan's constants match the source.

Tolerances: fp32 outputs 1e-4 + 1e-4 * |ref| (the same products to about
2^-21 each, summed in another order), bf16 outputs 2e-2 + 2e-2 * |ref|
(one bf16 ulp where a sum lands near a rounding boundary), as
``chip_smoke.py`` holds the kernel; pools exact (a max selects an input).
"""

import contextlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from tests.test_torch_tc_conv import _Card
from tests.test_torch_tc_fp32 import _emulate_fwd
from tpu_unet.kernels.im2col_conv import im2col_conv3x3 as j_im2col
from tpu_unet.kernels.pooling import max_pool2x2 as j_pool
from tpu_unet_torch import kernels as K
from tpu_unet_torch.kernels import _build, tc_conv
from tpu_unet_torch.kernels.im2col_conv import im2col_conv3x3_plain
from tpu_unet_torch.kernels.pooling import POOL_THREADS, max_pool2x2_plain, pool_plan
from tpu_unet_torch.kernels.tc_conv import tc_plan

F32, BF = torch.float32, torch.bfloat16
TOL = {F32: (1e-4, 1e-4), BF: (2e-2, 2e-2)}
SMS = 132  # the H100's SMs
# The shapes chip_smoke.py times the pool at: down3's output (the forward's
# one max_pool2x2) and level 0's width.
POOL_SHAPES = [(1, 80, 119, 512), (1, 640, 959, 64)]


def _close(got, ref, dtype):
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)


# ---- routing and counts -------------------------------------------------------


@pytest.fixture
def card(monkeypatch):
    K.reset_launch_counts()
    yield _Card(monkeypatch)
    K.reset_launch_counts()


@pytest.mark.parametrize("cin", [8, 320])
@pytest.mark.parametrize("relu", [False, True], ids=["linear", "relu"])
@pytest.mark.parametrize("out_dtype", [F32, BF], ids=["fp32out", "bf16out"])
def test_fp32_im2col_makes_one_tensor_core_launch(card, cin, relu, out_dtype):
    x = torch.empty(1, 5, 6, cin, device="meta")
    w = torch.empty(3, 3, cin, 16, device="meta")
    y = K.im2col_conv3x3(x, w, torch.ones(16), torch.zeros(16), apply_relu=relu,
                         out_dtype=out_dtype)
    assert y.shape == (1, 5, 6, 16) and y.dtype == out_dtype
    assert card.tc == ["im2col_conv3x3"] and card.lib == []
    counts = {k: v for k, v in K.launch_counts().items() if v}
    assert counts == {"im2col_conv3x3": 1, "im2col_conv3x3.tc": 1}


def test_a_failed_fp32_im2col_launch_counts_nothing(card):
    card.fail = True
    x = torch.empty(1, 5, 6, 320, device="meta")
    w = torch.empty(3, 3, 320, 16, device="meta")
    for out_dtype in (F32, BF):
        with pytest.raises(RuntimeError, match="launch failed"):
            K.im2col_conv3x3(x, w, torch.ones(16), torch.zeros(16), out_dtype=out_dtype)
    assert card.lib == []  # no retreat to a CUDA-core kernel: none is left
    assert all(v == 0 for v in K.launch_counts().values())


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
    monkeypatch.setattr(_build, "validate", lambda kernel, *tensors: (
        _build.DTYPE_BF16 if tensors[0].dtype == BF else _build.DTYPE_F32))
    monkeypatch.setattr(_build, "library", lambda: rec)
    monkeypatch.setattr(_build, "stream", lambda t: 0)
    monkeypatch.setattr(_build, "on_device", lambda t: contextlib.nullcontext())
    K.reset_launch_counts()
    yield rec
    K.reset_launch_counts()


@pytest.mark.parametrize("out_dtype", [F32, BF], ids=["fp32out", "bf16out"])
def test_fp32_im2col_launcher_passes_the_fp32_plan_a_split_buffer_and_the_out_dtype(
        lib, out_dtype):
    """tuk_tc_im2col_conv3x3_f32 gets every argument of its signature: x, w,
    a split buffer, scale, bias and the output (all distinct), Cin and Cout
    padded to 8, the ReLU and fp32-output flags and the fp32 plan."""
    x = torch.zeros(2, 13, 20, 3)
    y = tc_conv.im2col_conv3x3(x, torch.zeros(3, 3, 3, 20), torch.ones(20), torch.zeros(20),
                               True, out_dtype)
    (name, args), = lib.calls
    assert name == "tuk_tc_im2col_conv3x3_f32"
    assert len(args) == len(_build._SIGNATURES[name][0])
    assert len(set(args[:6])) == 6 and None not in args[:6]
    p = tc_plan(2, 13, 20, 24, True)
    assert args[6:] == (2, 13, 20, 8, 24, 1, int(out_dtype == F32), p.cfg, p.th, p.tw, 0)
    assert y.shape == (2, 13, 20, 20) and y.dtype == out_dtype


def test_new_c_interfaces_match_the_ctypes_signatures():
    for file, name in (("tc_conv.cu", "tuk_tc_im2col_conv3x3_f32"),
                       ("pooling.cu", "tuk_max_pool2x2")):
        src = (_build.CSRC_DIR / file).read_text()
        head = f'extern "C" int {name}('
        assert head in src, name
        params = src.split(head, 1)[1].split(")", 1)[0]
        assert params.count(",") + 1 == len(_build._SIGNATURES[name][0]), name
        assert params.count("*") == sum(t is _build._P for t in _build._SIGNATURES[name][0])


def test_the_cuda_core_im2col_conv_is_gone():
    names = {p.name for p in _build.sources()}
    assert not names & {"im2col_conv.cu", "common.cuh"}
    text = "".join(p.read_text() for p in _build.sources())
    for name in ("tuk_im2col_", "im2col_conv3x3_kernel", "kImMaxCin"):
        assert name not in text, name
    assert not [n for n in _build._SIGNATURES if n.startswith("tuk_im2col_")]


# ---- im2col numerics ------------------------------------------------------------


def _im2col_inputs(rng, shape, cout):
    cin = shape[-1]
    x = rng.standard_normal(shape, dtype=np.float32)
    w = (rng.standard_normal((3, 3, cin, cout)) * (9 * cin) ** -0.5).astype(np.float32)
    s = (1.0 + 0.2 * rng.standard_normal(cout)).astype(np.float32)
    b = (0.2 * rng.standard_normal(cout)).astype(np.float32)
    return x, w, s, b


def _jax_im2col(x, w, s, b, relu, out_dtype):
    with pltpu.force_tpu_interpret_mode():
        ref = j_im2col(*(jnp.asarray(a) for a in (x, w, s, b)), apply_relu=relu,
                       out_dtype=jnp.bfloat16 if out_dtype == BF else jnp.float32)
    return torch.from_numpy(np.array(ref.astype(jnp.float32)))


@pytest.mark.parametrize("relu", [False, True], ids=["linear", "relu"])
@pytest.mark.parametrize("shape,cout", [((2, 13, 20, 16), 8), ((1, 9, 11, 3), 24)])
def test_plain_fp32_x_bf16_out_matches_jax(rng, shape, cout, relu):
    x, w, s, b = _im2col_inputs(rng, shape, cout)
    got = im2col_conv3x3_plain(*(torch.from_numpy(a) for a in (x, w, s, b)), apply_relu=relu,
                               out_dtype=BF)
    assert got.dtype == BF
    _close(got, _jax_im2col(x, w, s, b, relu, BF), BF)


def _emulate_im2col(x, w, s, b, relu, out_dtype):
    """What tuk_tc_im2col_conv3x3_f32 computes: the fp32 conv's 3xTF32 order
    (``_emulate_fwd``: the fp32 plan's tiles, 16-channel chunks with the 9
    taps inside, a fresh sum a k8 step), then acc * s, + b (each rounded),
    the ReLU and one rounding to ``out_dtype``."""
    acc, _ = _emulate_fwd(x, w)
    y = acc * s + b
    return (torch.relu(y) if relu else y).to(out_dtype)


@pytest.mark.parametrize("out_dtype", [F32, BF], ids=["fp32out", "bf16out"])
@pytest.mark.parametrize("shape,cout,relu", [((1, 16, 24, 8), 16, True),
                                             ((2, 13, 20, 16), 8, False),
                                             ((1, 9, 11, 40), 24, True)])
def test_emulated_fp32_im2col_matches_the_plain_version_and_jax(rng, shape, cout, relu,
                                                                out_dtype):
    x, w, s, b = _im2col_inputs(rng, shape, cout)
    tx, tw, ts, tb = (torch.from_numpy(a) for a in (x, w, s, b))
    got = _emulate_im2col(tx, tw, ts, tb, relu, out_dtype)
    assert got.dtype == out_dtype
    _close(got, im2col_conv3x3_plain(tx, tw, ts, tb, apply_relu=relu, out_dtype=out_dtype),
           out_dtype)
    _close(got, _jax_im2col(x, w, s, b, relu, out_dtype), out_dtype)


# ---- the pool -------------------------------------------------------------------


def _with_nans(rng, shape):
    """A seeded input with NaNs at a few window positions, one in each
    corner of some 2x2 window, and one in the dropped odd row and column."""
    x = rng.standard_normal(shape).astype(np.float32)
    x[0, 0, 0, 0] = x[0, 1, 3, 1] = x[0, 2, 4, 2] = x[0, 5, 7, -1] = np.nan
    x[0, -1, 0, 0] = x[0, 0, -1, 1] = np.nan  # H and W odd: never read
    return x


@pytest.mark.parametrize("dtype", [F32, BF], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(1, 13, 21, 8), (2, 9, 11, 3)])
def test_plain_pool_matches_jax_with_nans(rng, shape, dtype):
    x = _with_nans(rng, shape)
    tx = torch.from_numpy(x).to(dtype)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == BF else jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(j_pool(jx).astype(jnp.float32))
    got = max_pool2x2_plain(tx)
    assert got.dtype == dtype and got.shape == (shape[0], shape[1] // 2, shape[2] // 2, shape[3])
    assert np.isnan(ref).sum() == 4  # each placed window NaN kept, the dropped ones not read
    np.testing.assert_array_equal(got.float().numpy(), ref)


def _emulate_pool(x: np.ndarray, plan) -> tuple[np.ndarray, np.ndarray]:
    """max_pool2x2_kernel's indexing under ``plan``, vectorised: every
    (block, ty, channel-vector step, tx) the kernel runs, the output vector
    it writes, its four 32-bit input offsets inside the row pair, and
    max(max(p00, p10), max(p01, p11)). Returns (the output, how many times
    each output element was written)."""
    n, h, w, c = x.shape
    h2, w2 = h // 2, w // 2
    v, tx, py = plan.vec, plan.tx, plan.py
    chunks = -(-w2 // py)
    assert 2 * w * c < 2 ** 31 and n * h2 * chunks < 2 ** 31  # 32-bit offsets, grid
    blocks = np.arange(n * h2 * chunks)
    row, chunk = blocks // chunks, blocks % chunks
    bn, bi = row // h2, row % h2
    steps = -(-(c // v) // tx)
    # all (block, ty, step, tx) a thread visits, kept where the kernel acts
    b_, ty_, s_, t_ = np.meshgrid(blocks, np.arange(py), np.arange(steps), np.arange(tx),
                                  indexing="ij")
    jj, cv = chunk[b_] * py + ty_, t_ + s_ * tx
    live = (jj < w2) & (cv < c // v)
    jj, cv, b_ = jj[live], cv[live], b_[live]
    off = 2 * jj * c + cv * v                                        # inside the row pair
    assert off.max(initial=0) + c + v <= 2 * w * c
    base0 = ((bn[b_] * h + 2 * bi[b_]) * w * c)[:, None]
    e = np.arange(v)[None, :]
    flat = x.reshape(-1)
    p00, p01 = flat[base0 + off[:, None] + e], flat[base0 + off[:, None] + c + e]
    p10, p11 = flat[base0 + w * c + off[:, None] + e], flat[base0 + w * c + off[:, None] + c + e]
    val = np.maximum(np.maximum(p00, p10), np.maximum(p01, p11))
    out = np.zeros(n * h2 * w2 * c, x.dtype)
    hits = np.zeros(n * h2 * w2 * c, np.int64)
    dst = (row[b_] * w2 * c + jj * c + cv * v)[:, None] + e
    out[dst] = val
    np.add.at(hits, dst.reshape(-1), 1)
    return out.reshape(n, h2, w2, c), hits


@pytest.mark.parametrize("elem", [4, 2], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", POOL_SHAPES)
def test_pool_plan_at_the_timed_shapes_covers_every_vector_once(rng, shape, elem):
    """Both shapes chip_smoke.py times: 16-byte vectors, full blocks, at
    least four blocks an SM; every output element written once, the
    emulated result exactly the plain version's."""
    plan = pool_plan(shape[3], elem, True)
    assert plan.vec == 16 // elem and plan.tx * plan.py == POOL_THREADS
    assert shape[0] * (shape[1] // 2) * -(-(shape[2] // 2) // plan.py) >= 4 * SMS  # blocks
    x = rng.standard_normal(shape).astype(np.float32)
    out, hits = _emulate_pool(x, plan)
    assert (hits == 1).all()
    np.testing.assert_array_equal(out, max_pool2x2_plain(torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("shape,elem,aligned", [
    ((2, 9, 11, 3), 2, True),       # 6-byte channel rows: the scalar path
    ((1, 13, 21, 8), 4, False),     # a pointer off 16 bytes: the scalar path
    ((3, 7, 5, 24), 2, True),       # 48-byte rows, 3 vectors a pixel
    ((1, 5, 9, 4096), 4, True),     # 1024 vectors a pixel: tx loops
    ((1, 1, 9, 8), 2, True),        # no output row
])
def test_pool_plan_covers_every_vector_once_at_ragged_shapes(rng, shape, elem, aligned):
    plan = pool_plan(shape[3], elem, aligned)
    assert plan.vec == (16 // elem if aligned and shape[3] * elem % 16 == 0 else 1)
    x = _with_nans(rng, shape) if min(shape[1:3]) > 7 else rng.standard_normal(shape).astype(
        np.float32)
    out, hits = _emulate_pool(x, plan)
    assert (hits == 1).all()
    np.testing.assert_array_equal(out, max_pool2x2_plain(torch.from_numpy(x)).numpy())


def test_pool_plan_mirrors_the_source():
    src = (_build.CSRC_DIR / "pooling.cu").read_text()
    assert int(re.search(r"constexpr int kPoolThreads = (\d+);", src).group(1)) == POOL_THREADS
    assert "__launch_bounds__(kPoolThreads)" in src and "dim3(tx, py)" in src
    assert "__hmax2_nan" in src and "L1::no_allocate" in src


def test_pool_wrapper_passes_its_plan(lib):
    """tuk_max_pool2x2 gets x, out, the shape, the dtype code and the plan
    (16-byte vectors, tx, py); one launch counted."""
    for dtype, code in ((BF, _build.DTYPE_BF16), (F32, _build.DTYPE_F32)):
        lib.calls.clear()
        x = torch.empty(1, 80, 119, 512, dtype=dtype, device="meta")
        y = K.max_pool2x2(x)
        (name, args), = lib.calls
        p = pool_plan(512, x.element_size(), True)
        assert name == "tuk_max_pool2x2" and len(args) == len(_build._SIGNATURES[name][0])
        assert args[2:] == (1, 80, 119, 512, code, p.vec, p.tx, p.py, 0)
        assert y.shape == (1, 40, 59, 512) and y.dtype == dtype
    assert K.launch_counts()["max_pool2x2"] == 2


def test_pool_refuses_a_row_pair_past_32_bit_offsets(monkeypatch):
    monkeypatch.setattr(_build, "validate", lambda kernel, *tensors: _build.DTYPE_F32)
    monkeypatch.setattr(_build, "library", lambda: pytest.fail("built a library"))
    x = torch.empty(1, 2, 2 ** 20, 1024, device="meta")
    with pytest.raises(ValueError, match="32-bit offsets"):
        K.max_pool2x2(x)
    assert K.launch_counts()["max_pool2x2"] == 0
