"""The train step's multi-tensor clip and RMSprop update
(``tpu_unet_torch/kernels/multi_tensor.py``, kernel
``tpu_unet_torch/csrc/multi_tensor.cu``) on the CPU, where the kernels
cannot run:

- the plain versions, which CPU trees take, give the per-leaf code's results
  bit for bit on the U-Net's 64 leaves and Attention U-Net's 100 (at base 8:
  the same leaves, narrower), through ``clip_grad_norm``, ``clip_to_norm``
  and ``rmsprop_update``, with the state's keys in another order than the
  params';
- the C interface's table holds the leaves in order, leaves of 1 and of 0
  values among them, and refuses the dtypes and layouts the kernels do not
  take;
- meta tensors stand in for CUDA ones, so the wrappers take their launch
  routes against a recording library: one call each, the leaves counted
  under ``optim.fused_leaves``;
- the exported C functions match their ctypes signatures, and the Python
  mirrors of the kernel's constants match the source.

The kernels themselves are held against the plain versions on the card by
``tests/test_torch_multi_tensor_card.py``.
"""

import contextlib
import ctypes
import gc
import re
import weakref

import numpy as np
import pytest
import torch

from tpu_unet_torch import kernels as K
from tpu_unet_torch import tracing
from tpu_unet_torch.kernels import _build, multi_tensor as mt
from tpu_unet_torch.models import UNetConfig, init_unet
from tpu_unet_torch.models.unet import tree_leaves, tree_map, tree_unflatten, unet_apply
from tpu_unet_torch.optim import (
    RMSpropState,
    clip_grad_norm,
    clip_to_norm,
    rmsprop_update,
)
from tpu_unet_torch.train import compute_loss

LEAVES = {"unet": 64, "attention": 100}


# ---- the per-leaf code the kernels replaced, as it was -------------------------


def _rmsprop_per_leaf(grads, state, params, lr, *, alpha=0.99, eps=1e-8, weight_decay=1e-8,
                      momentum=0.999):
    def leaf(p, g, sq, buf):
        g = g.float()
        pf = p.float()
        if weight_decay != 0:
            g = g + weight_decay * pf
        sq = alpha * sq + (1 - alpha) * (g * g)
        buf = momentum * buf + g / (torch.sqrt(sq) + eps)
        return (pf - lr * buf).to(p.dtype), sq, buf

    new = tree_map(leaf, params, grads, state.square_avg, state.momentum_buf)

    def part(tree, i):
        return {k: part(v, i) for k, v in tree.items()} if isinstance(tree, dict) else tree[i]

    return part(new, 0), RMSpropState(part(new, 1), part(new, 2))


def _scale_per_leaf(grads, total, max_norm):
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    return tree_map(lambda g: (g.float() * coef).to(g.dtype), grads)


def _clip_per_leaf(grads, max_norm):
    total = torch.sqrt(sum((g.float() * g.float()).sum() for g in tree_leaves(grads)))
    return _scale_per_leaf(grads, total, max_norm), total


def _reversed_keys(tree):
    """The same tree with every dict's keys in reverse order."""
    if isinstance(tree, dict):
        return {k: _reversed_keys(tree[k]) for k in reversed(list(tree))}
    return tree


def _trees(arch, dtype, seed=0):
    """(params, grads, RMSprop state after one step's worth of values) of a
    base-8 ``arch`` with numpy-drawn values; params in ``dtype``."""
    rng = np.random.default_rng(seed)
    params, _ = init_unet(UNetConfig(n_channels=3, n_classes=1, base_channels=8, arch=arch),
                          rng)
    params = tree_map(lambda p: p.to(dtype), params)

    def draw(p, scale):
        return torch.from_numpy(scale * rng.standard_normal(p.shape).astype(np.float32))

    grads = tree_map(lambda p: draw(p, 1e-2).to(dtype), params)
    sq = tree_map(lambda p: draw(p, 1e-3).abs(), params)
    buf = tree_map(lambda p: draw(p, 1e-1), params)
    return params, grads, RMSpropState(sq, buf)


def _autograd_grads(arch, params):
    """The gradients of one bf16 step's loss at ``params`` (library convs),
    in the layouts autograd returns."""
    config = UNetConfig(n_channels=3, n_classes=1, base_channels=8, arch=arch)
    _, state = init_unet(config, np.random.default_rng(1))
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    rng = np.random.default_rng(2)
    images = torch.from_numpy(rng.random((2, 32, 48, 3), dtype=np.float32))
    masks = torch.from_numpy((rng.random((2, 32, 48)) > 0.5).astype(np.int64))
    logits, _ = unet_apply(tree_unflatten(params, leaves), state, images, config=config,
                           train=True, compute_dtype=torch.bfloat16)
    grads = torch.autograd.grad(compute_loss(logits, masks, 1), leaves)
    return tree_unflatten(params, grads)


def _same(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        torch.testing.assert_close(x, y, atol=0, rtol=0, equal_nan=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("arch", sorted(LEAVES))
def test_plain_versions_are_the_per_leaf_code_bit_for_bit(arch, dtype):
    params, grads, state = _trees(arch, dtype)
    assert len(tree_leaves(params)) == LEAVES[arch]
    K.reset_launch_counts()
    want_g, want_n = _clip_per_leaf(grads, 1.0)
    got_g, got_n = clip_grad_norm(grads, 1.0)
    _same(got_g, want_g)
    torch.testing.assert_close(got_n, want_n, atol=0, rtol=0)
    # a norm above max_norm and one below it: both sides of the clamp
    for total in (want_n, want_n / 1e3):
        _same(clip_to_norm(grads, total, 0.5), _scale_per_leaf(grads, total, 0.5))
    state_r = RMSpropState(*(_reversed_keys(t) for t in state))
    for lr in (1e-5, 3e-4):
        want_p, want_s = _rmsprop_per_leaf(want_g, state, params, lr)
        got_p, got_s = rmsprop_update(want_g, state_r, params, lr)
        _same(got_p, want_p)
        _same(got_s, want_s)
        assert list(got_s.square_avg) == list(params)  # the params' key order
    zp, zs = rmsprop_update(grads, state, params, 1e-5, weight_decay=0.0, momentum=0.9)
    wp, ws = _rmsprop_per_leaf(grads, state, params, 1e-5, weight_decay=0.0, momentum=0.9)
    _same(zp, wp)
    _same(zs, ws)
    assert all(n == 0 for n in K.launch_counts().values())  # CPU: plain versions


def test_the_clip_and_update_free_their_inputs_without_the_cyclic_gc():
    """Dropping a step's trees frees their tensors at once: nothing on the
    clip's and update's path holds them in a reference cycle (one would
    keep each step's gradients until the cyclic GC ran, and raise the
    step's peak memory)."""
    params, grads, state = _trees("unet", torch.float32)
    gc.collect()
    gc.disable()
    try:
        refs = [weakref.ref(t) for t in tree_leaves(grads)]
        clipped, _ = clip_grad_norm(grads, 1.0)
        refs += [weakref.ref(t) for t in tree_leaves(clipped)]
        new_p, new_s = rmsprop_update(clipped, state, params, 1e-5)
        refs += [weakref.ref(t) for t in tree_leaves((new_p, *new_s))]
        del grads, clipped, new_p, new_s
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


def test_plain_versions_are_the_wrappers_on_cpu():
    params, grads, state = _trees("unet", torch.float32, seed=1)
    leaves = [tree_leaves(t) for t in (params, grads, *state)]
    sq, total = mt.grad_sumsq(leaves[1])
    psq, ptotal = mt.grad_sumsq_plain(leaves[1])
    assert sq.shape == (len(leaves[1]),) and torch.equal(sq, psq) and torch.equal(total, ptotal)
    for a, b in zip(mt.scale_to_norm(leaves[1], total, 0.1),
                    mt.scale_to_norm_plain(leaves[1], total, 0.1)):
        assert torch.equal(a, b)
    got = mt.rmsprop_step(*leaves, 1e-4)
    want = mt.rmsprop_step_plain(*leaves, 1e-4)
    for a, b in zip(got, want):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_float64_trees_take_the_plain_versions(card):
    """float64 is the reference steps' precision, which the kernels do not
    compute: float64 leaves run the plain versions on the CPU, and on the
    card (meta tensors here) only where the caller chose them with
    ``plain_versions()``; outside it the wrappers refuse them."""
    lib, _ = card
    g = [torch.ones(3, dtype=torch.float64, device="meta") for _ in range(2)]
    p, s = [torch.ones(3, dtype=torch.float64, device="meta")], [torch.ones(3, device="meta")]
    with mt.plain_versions():
        sq, total = mt.grad_sumsq(g)
        out = mt.scale_to_norm(g, total, 1.0)
        new = K.rmsprop_step(p, p, s, s, 1e-3)
    assert sq.shape == (2,) and out[0].dtype == torch.float64 and new[0][0].dtype == torch.float64
    cpu = [torch.ones(3, dtype=torch.float64) for _ in range(2)]
    assert torch.equal(mt.grad_sumsq(cpu)[0], torch.full((2,), 3.0, dtype=torch.float64))
    for call in (lambda: mt.grad_sumsq(g), lambda: mt.scale_to_norm(g, total, 1.0),
                 lambda: K.rmsprop_step(p, p, s, s, 1e-3)):
        with pytest.raises(ValueError, match="dtype must be one of"):
            call()
    assert lib.calls == [] and all(n == 0 for n in K.launch_counts().values())


# ---- the C interface's table ---------------------------------------------------


def test_the_table_holds_the_leaves_in_order():
    sizes = [1, 0, 5, mt.CHUNK, mt.CHUNK + 1, 70000, 3]
    grads = [torch.zeros(n) for n in sizes]
    half = [torch.zeros(n, dtype=torch.bfloat16) for n in sizes]
    out = [torch.empty_like(g) for g in grads]
    ptrs, numel, codes = mt.leaf_table("k", (grads, half), ((torch.float32,),
                                                            (torch.bfloat16, torch.float32)),
                                       (out,))
    assert ptrs.dtype == np.uint64 and numel.dtype == np.int64
    assert ptrs.tolist() == [t.data_ptr() for leaf in zip(grads, half, out) for t in leaf]
    assert numel.tolist() == sizes
    assert codes == [_build.DTYPE_F32, _build.DTYPE_BF16]
    # contiguous tensors whose size-1 dims' strides differ are laid out alike
    odd = torch.zeros(64).as_strided((1, 1, 64, 1), (64, 64, 1, 64))
    assert mt.leaf_table("k", ([torch.zeros(1, 1, 64, 1)], [odd]), (mt._PARAM,) * 2)[1] == [64]
    # blocks: 1 + 0 + 1 + 1 + 2 + 3 + 1; an empty leaf takes none
    assert mt.chunks(numel) == 9
    assert mt.chunks(np.zeros(0, np.int64)) == 0


def _refused(columns, dtypes, match):
    with pytest.raises(ValueError, match=match):
        mt.leaf_table("k", columns, dtypes)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int32])
def test_the_table_refuses_dtypes_the_kernels_do_not_take(dtype):
    _refused(([torch.zeros(4, dtype=dtype)],), (mt._PARAM,), "dtype must be one of")


def test_the_table_refuses_a_state_that_is_not_fp32():
    p = [torch.zeros(4)]
    _refused((p, p, [torch.zeros(4, dtype=torch.bfloat16)]), (mt._PARAM, mt._PARAM, mt._STATE),
             "dtype must be one of")


@pytest.mark.parametrize("case", ["mixed_dtypes", "shapes", "layout", "device", "lengths"])
def test_the_table_refuses_what_the_kernels_do_not_take(case):
    a, b = torch.zeros(2, 3), torch.zeros(3, 2)
    if case == "mixed_dtypes":
        _refused(([a, b.bfloat16()],), (mt._PARAM,), "one dtype a list")
    elif case == "shapes":
        _refused(([a], [b]), (mt._PARAM, mt._PARAM), "differ in shape")
    elif case == "layout":
        _refused(([a], [b.t()]), (mt._PARAM, mt._PARAM), "contiguous")
    elif case == "device":
        _refused(([a, torch.zeros(2, device="meta")],), (mt._PARAM,), "one device")
    else:
        _refused(([a, b], [a]), (mt._PARAM, mt._PARAM), "differ in length")
        with pytest.raises(ValueError, match="differ in length"):
            mt.leaf_table("k", ([a, b],), (mt._PARAM,), ([a],))


# ---- the launch routes, against a recording library -----------------------------


class _Lib:
    """Records each C call's name and its table (numel read from the
    pointer the wrapper passed)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(ptrs, numel, count, *args):
            got = np.ctypeslib.as_array(ctypes.cast(numel, ctypes.POINTER(ctypes.c_int64)),
                                        (count,)).tolist() if count else []
            self.calls.append((name, got, args))
            return 0
        return call


@pytest.fixture
def card(monkeypatch):
    """Meta tensors take the launch routes; the library, stream and device
    context are stand-ins; ``optim.fused_leaves`` is recorded as if a
    profiler session were on."""
    lib, counted = _Lib(), {}
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream", lambda t: 0)
    monkeypatch.setattr(_build, "on_device", lambda t: contextlib.nullcontext())
    monkeypatch.setattr(tracing, "count",
                        lambda name, n=1: counted.__setitem__(name, counted.get(name, 0) + n))
    K.reset_launch_counts()
    yield lib, counted
    K.reset_launch_counts()


@pytest.mark.parametrize("arch", sorted(LEAVES))
def test_a_step_s_clip_and_update_are_one_call_each(card, arch):
    """On the gradients autograd gives (library convs' weights' laid out as
    permutations, the 1x1 head's with size-1 dims' strides of its own)."""
    lib, counted = card
    params, grads, state = _trees(arch, torch.float32)
    grads = _autograd_grads(arch, params)
    assert any(not g.is_contiguous() for g in tree_leaves(grads))
    params, grads, state = (tree_map(lambda t: t.to("meta"), tree)
                            for tree in (params, grads, state))
    n = LEAVES[arch]
    clipped, total = clip_grad_norm(grads, 1.0)
    new_p, new_s = rmsprop_update(clipped, state, params, 1e-5)
    assert [c[0] for c in lib.calls] == ["tuk_mt_sumsq", "tuk_mt_scale", "tuk_mt_rmsprop"]
    sizes = [p.numel() for p in tree_leaves(params)]
    assert all(c[1] == sizes for c in lib.calls)
    assert total.shape == () and total.dtype == torch.float32
    for tree in (clipped, new_p, *new_s):
        assert [(t.shape, t.dtype) for t in tree_leaves(tree)] == [
            (p.shape, p.dtype) for p in tree_leaves(params)]
    # dtype, lr, weight decay, alpha, 1 - alpha, eps, momentum, decay on
    assert lib.calls[2][2][:8] == (_build.DTYPE_F32, 1e-5, 1e-8, 0.99, 1 - 0.99, 1e-8, 0.999, 1)
    counts = K.launch_counts()
    assert (counts["grad_sumsq"], counts["scale_to_norm"], counts["rmsprop_step"]) == (1, 1, 1)
    assert counted == {"optim.fused_leaves": 2 * n}


def test_gradients_that_are_not_contiguous_are_copied_once_a_step(card, monkeypatch):
    """A gradient laid out as autograd gives a library conv's weight's (a
    permutation of a contiguous tensor) is copied once, in the clip, for
    both of its launches; the update takes the clipped copy as it is."""
    lib, _ = card
    copies = []
    real = torch.Tensor.contiguous
    monkeypatch.setattr(torch.Tensor, "contiguous",
                        lambda t, *a, **k: copies.append(tuple(t.shape)) or real(t, *a, **k))
    p = torch.zeros(3, 3, 4, 8, device="meta")
    g = torch.zeros(8, 4, 3, 3, device="meta").permute(2, 3, 1, 0)
    assert not g.is_contiguous()
    clipped, _ = clip_grad_norm({"w": g}, 1.0)
    rmsprop_update(clipped, RMSpropState({"w": torch.zeros_like(p)}, {"w": torch.zeros_like(p)}),
                   {"w": p}, 1e-3)
    assert copies == [(3, 3, 4, 8)] and clipped["w"].is_contiguous()
    assert [c[0] for c in lib.calls] == ["tuk_mt_sumsq", "tuk_mt_scale", "tuk_mt_rmsprop"]


def test_shards_that_are_not_contiguous_are_copied_contiguous(card):
    lib, _ = card
    p = torch.zeros(6, 8, device="meta")[:, 2:6]  # a ZeRO-style shard of the last dim
    assert not p.is_contiguous()
    out = K.rmsprop_step([p], [p.clone()], [p.float()], [p.float()], 1e-3)
    assert all(t[0].is_contiguous() and t[0].shape == (6, 4) for t in out)
    assert lib.calls[0][1] == [24]


def test_the_wrappers_refuse_what_the_kernels_do_not_take(card):
    g = [torch.zeros(3, device="meta")]
    for total in (torch.zeros((), dtype=torch.float64, device="meta"), torch.zeros(()),
                  torch.zeros(2, device="meta")):
        with pytest.raises(ValueError, match="total must be one fp32 value"):
            K.scale_to_norm(g, total, 1.0)
    half, state = torch.zeros(3, dtype=torch.float16, device="meta"), torch.zeros(3, device="meta")
    with pytest.raises(ValueError, match="dtype must be one of"):
        K.rmsprop_step([half], [half], [state], [state], 1e-3)
    bf16 = torch.zeros(3, dtype=torch.bfloat16, device="meta")
    for p, g in ((bf16, state), (state, bf16)):  # the gradients in another dtype than the params
        with pytest.raises(ValueError, match="in the params' dtype"):
            K.rmsprop_step([p], [g], [state], [state], 1e-3)
    assert all(n == 0 for n in K.launch_counts().values())


# ---- the source ------------------------------------------------------------------


def test_c_interface_and_mirrors_match_the_source():
    src = (_build.CSRC_DIR / "multi_tensor.cu").read_text()
    for name in ("tuk_mt_sumsq", "tuk_mt_scale", "tuk_mt_rmsprop"):
        head = f'extern "C" int {name}('
        assert head in src, name
        params = src.split(head, 1)[1].split(")", 1)[0]
        assert params.count(",") + 1 == len(_build._SIGNATURES[name][0]), name
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kChunk"]) == mt.CHUNK
    assert int(consts["kMaxLeaves"]) == mt.MAX_LEAVES
    assert "multi_tensor.cu" in {p.name for p in _build.sources()}
