"""On the card: the multi-tensor clip and RMSprop update
(``tpu_unet_torch/csrc/multi_tensor.cu``) against their plain versions, at
the full-width U-Net's 64 leaves, Attention U-Net's 100 (also with its
conv weights' gradients laid out as autograd gives a library conv's: a
permutation of a contiguous tensor), a ZeRO shard of the U-Net (half of
each leaf's last dim: views, not contiguous) and a list
longer than one table (300 leaves of 0 to 70,000 values, some of them not
aligned to a vector):

- the squared sums and the norm within 1e-6 relative of the plain ones;
- the scaling by a given norm, and RMSprop at a given lr on the clipped
  gradients, bit for bit the plain versions' (params fp32 and bf16);
- a second call bit for bit the first;
- a train step counts 2 x leaves under ``optim.fused_leaves``.

The tests skip without a CUDA device. This file imports no JAX, so it runs
on a machine without it, past the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_multi_tensor_card.py -q
"""

import numpy as np
import pytest
import torch

from tpu_unet_torch import kernels as K
from tpu_unet_torch.kernels import multi_tensor as mt
from tpu_unet_torch.models import UNetConfig, init_unet
from tpu_unet_torch.models.unet import tree_leaves

NORM_RTOL = 1e-6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    K.reset_launch_counts()
    yield torch.device("cuda", 0)
    K.reset_launch_counts()


def _flagship(arch, dev):
    params, _ = init_unet(UNetConfig(n_channels=3, n_classes=1, base_channels=64, arch=arch),
                          np.random.default_rng(0), device=dev)
    return tree_leaves(params)


def _ragged(dev):
    """300 leaves of 0 to 70,000 values; every third a view at an odd
    offset into a buffer, so that no vector of it is aligned."""
    rng = np.random.default_rng(1)
    sizes = [0, 1, 3, mt.CHUNK, mt.CHUNK + 1, 70000] + rng.integers(0, 5000, 294).tolist()
    out = []
    for i, n in enumerate(sizes):
        if i % 3 == 2:
            out.append(torch.randn(n + 1, device=dev)[1:])
        else:
            out.append(torch.randn(n, device=dev))
    return out


def _leaf_set(name, dev):
    if name == "attention_permuted_grads":
        return _flagship("attention", dev)
    if name == "zero_shard":
        return [p[..., : max(1, p.shape[-1] // 2)] for p in _flagship("unet", dev)]
    return _ragged(dev) if name == "ragged" else _flagship(name, dev)


def _state(params, gen, permuted=False):
    def draw(p, scale):
        return scale * torch.randn(p.shape, generator=gen, device=p.device)

    def grad(p):
        if permuted and p.ndim == 4:  # laid out as autograd gives a library conv's weight's
            return 1e-2 * torch.randn(p.shape[::-1], generator=gen,
                                      device=p.device).permute(3, 2, 1, 0)
        return draw(p, 1e-2)

    grads = [grad(p) for p in params]
    sq = [draw(p, 1e-4).abs() for p in params]
    buf = [draw(p, 1e-1) for p in params]
    return grads, sq, buf


def _bits(t):
    return t.reshape(-1).view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _bitwise(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        assert torch.equal(_bits(a), _bits(b)), i


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("leaves", ["unet", "attention", "attention_permuted_grads",
                                    "zero_shard", "ragged"])
def test_clip_and_rmsprop_match_the_plain_versions(card, leaves, dtype):
    gen = torch.Generator(card).manual_seed(7)
    params = [p.to(dtype) for p in _leaf_set(leaves, card)]
    grads, sq, buf = _state(params, gen, permuted=leaves.endswith("permuted_grads"))
    grads = [g.to(dtype) for g in grads]

    got_sq, got_total = mt.grad_sumsq(grads)
    want_sq, want_total = mt.grad_sumsq_plain(grads)
    torch.testing.assert_close(got_sq, want_sq, atol=0, rtol=NORM_RTOL)
    torch.testing.assert_close(got_total, want_total, atol=0, rtol=NORM_RTOL)
    again_sq, again_total = mt.grad_sumsq(grads)
    assert torch.equal(again_sq, got_sq) and torch.equal(again_total, got_total)

    for max_norm in (want_total.item() / 3, 2 * want_total.item()):  # clipped, and not
        clipped = mt.scale_to_norm(grads, want_total, max_norm)
        _bitwise(clipped, mt.scale_to_norm_plain(grads, want_total, max_norm))
    for lr, kw in ((1e-5, {}), (3e-4, {"weight_decay": 0.0, "momentum": 0.9})):
        got = mt.rmsprop_step(params, clipped, sq, buf, lr, **kw)
        want = mt.rmsprop_step_plain(params, clipped, sq, buf, lr, **kw)
        for a, b in zip(got, want):
            _bitwise(a, b)
        for a, b in zip(mt.rmsprop_step(params, clipped, sq, buf, lr, **kw), got):
            _bitwise(a, b)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    assert (counts["grad_sumsq"], counts["scale_to_norm"], counts["rmsprop_step"]) == (2, 2, 4)


@pytest.mark.card
@pytest.mark.parametrize("arch", ["unet", "attention"])
def test_a_train_step_counts_its_fused_leaves(card, arch):
    from torch.profiler import ProfilerActivity, profile

    from tpu_unet_torch import tracing
    from tpu_unet_torch.optim import rmsprop_init
    from tpu_unet_torch.train import make_train_step

    config = UNetConfig(n_channels=3, n_classes=1, base_channels=16, arch=arch)
    params, state = init_unet(config, np.random.default_rng(0), device=card)
    trees = (params, state, rmsprop_init(params))
    step = make_train_step(config, amp=True)
    images = torch.rand(2, 64, 96, 3, device=card)
    masks = (torch.rand(2, 64, 96, device=card) > 0.5).long()
    with profile(activities=[ProfilerActivity.CUDA]):
        for _ in range(2):
            trees = step(*trees, images, masks, 1e-5)[:3]
        torch.cuda.synchronize()
    leaves = len(tree_leaves(params))
    assert tracing.readout()["counters"]["optim.fused_leaves"] == 2 * 2 * leaves
    counts = K.launch_counts()
    assert (counts["grad_sumsq"], counts["scale_to_norm"], counts["rmsprop_step"]) == (2, 2, 2)
