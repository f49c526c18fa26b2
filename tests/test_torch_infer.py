"""The port's folded-BN forward (tpu_unet_torch.models.infer) against the
JAX one, on JAX-initialised weights with a perturbed BN state, fp32 on the
CPU. Tolerance 1e-3 on the logits, as the JAX package's own folded-vs-train
test uses: 18 stacked convs summed in another order."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from tpu_unet.checkpoint import _flatten_with_paths
from tpu_unet.models import UNetConfig as JConfig
from tpu_unet.models import init_unet as j_init
from tpu_unet.models import unet_apply as j_apply
from tpu_unet.models.infer import fold_bn as j_fold
from tpu_unet.models.infer import unet_infer_apply as j_infer
from tpu_unet_torch.checkpoint import flatten, from_jax_arrays
from tpu_unet_torch.models import UNetConfig, fold_bn, init_unet, param_count, unet_infer_apply


def _jax_model(bilinear: bool, n_classes: int = 2, base: int = 8):
    jcfg = JConfig(3, n_classes, bilinear=bilinear, base_channels=base)
    params, state = j_init(jax.random.PRNGKey(0), jcfg)
    state = jax.tree.map(
        lambda a: a + 0.05 * jnp.arange(a.size, dtype=a.dtype) / a.size, state)
    flat = {"params/" + k: v for k, v in _flatten_with_paths(params).items()}
    flat.update({"state/" + k: v for k, v in _flatten_with_paths(state).items()})
    return jcfg, params, state, flat


@pytest.mark.parametrize("bilinear", [False, True])
def test_fold_bn_matches_jax(bilinear):
    jcfg, params, state, flat = _jax_model(bilinear)
    tp, ts = from_jax_arrays(flat)
    ref = _flatten_with_paths(j_fold(params, state, jcfg))
    folded = fold_bn(tp, ts, UNetConfig(*jcfg))
    out = {k[len("params/"):]: v for k, v in flatten(folded, {}).items()}
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-6, atol=1e-7, err_msg=k)


@functools.lru_cache(maxsize=None)
def _jax_references(bilinear: bool):
    """(flat weights, x, JAX pallas logits, JAX train=False logits) at 48x37,
    which exercises pad_to_match at every decoder level (37 -> 18 -> 9 -> 4
    -> 2 on the way down). Cached: the interpret-mode forward is the slow
    part and both backends compare against it."""
    jcfg, params, state, flat = _jax_model(bilinear)
    x = np.random.default_rng(1).standard_normal((1, 48, 37, 3), dtype=np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref_pallas = np.asarray(j_infer(j_fold(params, state, jcfg), jnp.asarray(x),
                                        config=jcfg, backend="pallas"))
    ref_train_false = np.asarray(j_apply(params, state, jnp.asarray(x), config=jcfg,
                                         train=False)[0])
    return jcfg, flat, x, ref_pallas, ref_train_false


@pytest.mark.parametrize("bilinear", [False, True])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_infer_matches_jax_pallas_and_train_false(bilinear, backend):
    jcfg, flat, x, ref_pallas, ref_train_false = _jax_references(bilinear)
    tp, ts = from_jax_arrays(flat)
    cfg = UNetConfig(*jcfg)
    with torch.inference_mode():
        out = unet_infer_apply(fold_bn(tp, ts, cfg), torch.from_numpy(x), config=cfg,
                               backend=backend)
    assert out.dtype == torch.float32 and out.shape == (1, 48, 37, 2)
    np.testing.assert_allclose(out.numpy(), ref_pallas, atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(out.numpy(), ref_train_false, atol=1e-3, rtol=1e-3)


def test_backends_agree_bitwise_on_cpu():
    """On CPU tensors backend="cuda" runs the wrappers, which run the plain
    versions: the same numbers as backend="torch", in bf16 too."""
    jcfg, params, state, flat = _jax_model(False, n_classes=1)
    tp, ts = from_jax_arrays(flat)
    cfg = UNetConfig(*jcfg)
    folded = fold_bn(tp, ts, cfg)
    x = torch.from_numpy(np.random.default_rng(2).random((2, 24, 19, 3), dtype=np.float32))
    for dtype in (None, torch.bfloat16):
        a = unet_infer_apply(folded, x, config=cfg, backend="torch", compute_dtype=dtype)
        b = unet_infer_apply(folded, x, config=cfg, backend="cuda", compute_dtype=dtype)
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_bf16_forward_close_to_jax_pallas_bf16():
    """compute_dtype=bf16 casts params (scale and bias too) as the JAX forward
    does; bf16 roundings in two frameworks drift apart, so the bar here is
    2e-2 of the logit range, not fp32 tolerance."""
    jcfg, params, state, flat = _jax_model(False, n_classes=1)
    x = np.random.default_rng(3).random((1, 16, 20, 3), dtype=np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(j_infer(j_fold(params, state, jcfg), jnp.asarray(x), config=jcfg,
                                 backend="pallas", compute_dtype=jnp.bfloat16))
    tp, ts = from_jax_arrays(flat)
    cfg = UNetConfig(*jcfg)
    out = unet_infer_apply(fold_bn(tp, ts, cfg), torch.from_numpy(x), config=cfg,
                           backend="cuda", compute_dtype=torch.bfloat16).numpy()
    assert np.abs(out - ref).max() <= 2e-2 * max(np.abs(ref).max(), 1.0)


def _shapes(prefix, tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {prefix + "/".join(str(getattr(p, "key", getattr(p, "name", p))) for p in path):
            tuple(leaf.shape) for path, leaf in flat}


@pytest.mark.parametrize("bilinear", [False, True])
def test_init_layout_and_param_count_match_jax(bilinear):
    jcfg = JConfig(3, 1, bilinear=bilinear, base_channels=64)
    jp, js = jax.eval_shape(lambda: j_init(jax.random.PRNGKey(0), jcfg))
    ref = {**_shapes("params/", jp), **_shapes("state/", js)}
    tp, ts = init_unet(UNetConfig(*jcfg), np.random.default_rng(0))
    assert {k: v.shape for k, v in flatten(tp, ts).items()} == ref
    n_jax = sum(int(np.prod(v.shape)) for v in jax.tree.leaves(jp))
    assert param_count(tp) == n_jax
    if not bilinear:
        assert n_jax == 31_037_633  # the flagship's 31.0M


def test_init_bounds_are_torch_kaiming_uniform():
    tp, _ = init_unet(UNetConfig(3, 1, base_channels=8), np.random.default_rng(0))
    w = tp["down1"]["conv1"]["w"]
    bound = 1.0 / (9 * 8) ** 0.5
    assert w.abs().max() <= bound and w.abs().max() > 0.9 * bound
    again, _ = init_unet(UNetConfig(3, 1, base_channels=8), np.random.default_rng(0))
    torch.testing.assert_close(w, again["down1"]["conv1"]["w"], atol=0, rtol=0)


def test_unported_arch_and_backend_refused():
    # fold_bn folds the U-Net and Attention U-Net; the other families are
    # refused with the JAX package's words, and attention's folded forward
    # has no CUDA tier, as JAX's has no Pallas one.
    with pytest.raises(ValueError, match="unknown arch"):
        init_unet(UNetConfig(arch="vnet"), np.random.default_rng(0))
    for arch in ("unetpp", "r2u", "r2attu"):
        cfg = UNetConfig(3, 1, base_channels=8, arch=arch)
        with pytest.raises(ValueError, match="support arch='unet'/'attention'"):
            fold_bn(*init_unet(cfg, np.random.default_rng(0)), cfg)
    att = UNetConfig(3, 1, base_channels=8, arch="attention")
    with pytest.raises(ValueError, match="wired for the flagship U-Net only"):
        unet_infer_apply(fold_bn(*init_unet(att, np.random.default_rng(0)), att),
                         torch.zeros(1, 16, 16, 3), config=att, backend="cuda")
    tp, ts = init_unet(UNetConfig(3, 1, base_channels=8), np.random.default_rng(0))
    with pytest.raises(ValueError, match="backend"):
        unet_infer_apply(fold_bn(tp, ts, UNetConfig(3, 1, base_channels=8)),
                         torch.zeros(1, 16, 16, 3), config=UNetConfig(3, 1, base_channels=8),
                         backend="pallas")
