"""The port's synthetic data generators against the JAX package's: every
generator configuration and both dataset writers give the same bytes for
the same seed (the draw order is part of the frozen quality gates)."""

import numpy as np
import pytest
from PIL import Image

import tpu_unet.data.synthetic as J
import tpu_unet_torch.data as T_data
import tpu_unet_torch.data.synthetic as T

GENS = ("TRAIN_GEN", "HELDOUT_GEN", "OVERHEAD_GEN", "OVERHEAD_HELDOUT_GEN")


def test_generator_tables_equal_jax():
    for name in (*GENS, "_OVERHEAD_DELTA"):
        assert getattr(T, name) == getattr(J, name), name
    for name in GENS:
        assert getattr(T_data, name) is getattr(T, name)
    assert T_data.make_synthetic_voc is T.make_synthetic_voc


@pytest.mark.parametrize("gen", (None, *GENS))
@pytest.mark.parametrize("seed", (0, 7, 4242))
def test_synth_sample_bitwise_jax(gen, seed):
    g_t = getattr(T, gen) if gen else None
    g_j = getattr(J, gen) if gen else None
    rng_t, rng_j = np.random.default_rng(seed), np.random.default_rng(seed)
    for h, w in ((24, 40), (33, 20)):
        img_t, mask_t = T.synth_sample(rng_t, h, w, gen=g_t)
        img_j, mask_j = J.synth_sample(rng_j, h, w, gen=g_j)
        assert img_t.dtype == img_j.dtype and mask_t.dtype == mask_j.dtype
        np.testing.assert_array_equal(img_t, img_j)
        np.testing.assert_array_equal(mask_t, mask_j)
    # Both generators are left at the same point of their streams.
    assert rng_t.random() == rng_j.random()


def _files(root):
    return {p.relative_to(root).as_posix(): np.asarray(Image.open(p))
            for p in sorted(root.rglob("*")) if p.is_file()}


def _same_tree(a, b):
    fa, fb = _files(a), _files(b)
    assert fa.keys() == fb.keys() and fa
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.mark.parametrize("gen,seed,fmt", [
    (None, 0, ("png", "png")),
    ("HELDOUT_GEN", 4242, ("png", "png")),
    ("OVERHEAD_GEN", 3, ("png", "png")),
    ("OVERHEAD_HELDOUT_GEN", 4242, ("jpg", "gif")),
])
def test_make_synthetic_carvana_bitwise_jax(tmp_path, gen, seed, fmt):
    kw = dict(n=3, h=20, w=28, seed=seed, img_format=fmt[0], mask_format=fmt[1])
    dirs_t = T.make_synthetic_carvana(tmp_path / "t", gen=getattr(T, gen) if gen else None, **kw)
    J.make_synthetic_carvana(tmp_path / "j", gen=getattr(J, gen) if gen else None, **kw)
    assert dirs_t == (tmp_path / "t" / "imgs", tmp_path / "t" / "masks")
    assert (tmp_path / "t" / "imgs" / f"car_0002.{fmt[0]}").exists()
    _same_tree(tmp_path / "t", tmp_path / "j")


@pytest.mark.parametrize("seed,n_classes", [(0, 21), (5, 4)])
def test_make_synthetic_voc_bitwise_jax(tmp_path, seed, n_classes):
    kw = dict(n=3, h=24, w=30, n_classes=n_classes, seed=seed)
    T.make_synthetic_voc(tmp_path / "t", **kw)
    J.make_synthetic_voc(tmp_path / "j", **kw)
    _same_tree(tmp_path / "t", tmp_path / "j")
    masks = [np.asarray(Image.open(p)) for p in (tmp_path / "t" / "masks").glob("*.png")]
    assert max(int(m.max()) for m in masks) < n_classes


@pytest.mark.parametrize("seed", (0, 11))
def test_synth_batch_bitwise_jax(seed):
    it, mt = T.synth_batch(np.random.default_rng(seed), 3, 16, 24)
    ij, mj = J.synth_batch(np.random.default_rng(seed), 3, 16, 24)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(mt, mj)
