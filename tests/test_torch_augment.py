"""The port's augmentation (``tpu_unet_torch.data.augment``) against the JAX
package's on the CPU: JAX's own draws for a key (``jax_draws``) go through
the port's ``apply_augment`` and the result is held to JAX's
``augment_batch`` on the same batch.

Tolerances: flips and the 180° rotation move values only: bitwise.
Brightness and contrast: 1e-6 (the contrast mean is an fp32 sum in another
order). The warp: images within 1e-4 (the bilinear field upsampling and the
inverse map round in another order, moving source coordinates by ~1e-5 px),
masks, sampled at the nearest pixel, equal on >= 99.9% of pixels (a
coordinate within ~1e-5 of .5 may round the other way). The port's own
draws repeat for one (seed, step) and differ across steps.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import tpu_unet.data.augment as JA
import tpu_unet.train_cli as j_cli
import tpu_unet_torch.data.augment as TA
from tpu_unet_torch import train_cli


def jax_draws(key, config, n: int, h: int, w: int) -> TA.AugmentDraws:
    """The draws JAX's ``augment_batch(key, ...)`` makes, as the port's
    ``AugmentDraws`` (the same key splits, shapes and bounds)."""
    def t(a, shape):
        return torch.from_numpy(np.array(a)).reshape(shape)

    k_h, k_v, k_r, k_b, k_c, k_e = jax.random.split(key, 6)
    d = TA.AugmentDraws()
    if config.warps:
        k_field, k_rot, k_scale, k_shift = jax.random.split(k_e, 4)
        d.rot_deg = t(jax.random.uniform(k_rot, (n, 1, 1), minval=-config.rot_deg,
                                         maxval=config.rot_deg), (n,))
        d.scale_jitter = t(jax.random.uniform(k_scale, (n, 1, 1), minval=-config.scale_jitter,
                                              maxval=config.scale_jitter), (n,))
        d.shift = t(jax.random.uniform(k_shift, (n, 2, 1, 1), minval=-config.shift_px,
                                       maxval=config.shift_px), (n, 2))
        if config.elastic_alpha > 0:
            gh, gw = TA.elastic_grid_shape(h, w, config.elastic_grid)
            d.field = t(jax.random.uniform(k_field, (n, gh, gw, 2), minval=-1.0, maxval=1.0),
                        (n, gh, gw, 2))
    for name, k in (("hflip", k_h), ("vflip", k_v), ("rot180", k_r)):
        if getattr(config, name):
            setattr(d, name, t(jax.random.bernoulli(k, 0.5, (n,)), (n,)))
    if config.brightness > 0:
        d.brightness = t(jax.random.uniform(k_b, (n, 1, 1, 1), minval=-config.brightness,
                                            maxval=config.brightness), (n,))
    if config.contrast > 0:
        d.contrast = t(jax.random.uniform(k_c, (n, 1, 1, 1), minval=-config.contrast,
                                          maxval=config.contrast), (n,))
    return d


def _both(cfg: dict, seed: int, n=4, h=40, w=56):
    rng = np.random.default_rng(seed)
    images = rng.random((n, h, w, 3), dtype=np.float32)
    masks = rng.integers(0, 3, (n, h, w)).astype(np.int32)
    key = jax.random.PRNGKey(seed)
    ji, jm = JA.augment_batch(key, jnp.asarray(images), jnp.asarray(masks),
                              config=JA.AugmentConfig(**cfg))
    config = TA.AugmentConfig(**cfg)
    ti, tm = TA.apply_augment(jax_draws(key, config, n, h, w), torch.from_numpy(images),
                              torch.from_numpy(masks), config)
    assert ti.dtype == torch.float32 and tm.dtype == torch.int32
    return (ti.numpy(), tm.numpy()), (np.asarray(ji), np.asarray(jm)), (images, masks)


def test_config_is_jaxs():
    names = [f.name for f in dataclasses.fields(JA.AugmentConfig)]
    assert [f.name for f in dataclasses.fields(TA.AugmentConfig)] == names
    assert TA.AugmentConfig() == TA.AugmentConfig(**dataclasses.asdict(JA.AugmentConfig()))


@pytest.mark.parametrize("cfg", [{"hflip": True}, {"hflip": False, "vflip": True},
                                 {"hflip": False, "rot180": True},
                                 {"hflip": True, "vflip": True, "rot180": True}])
@pytest.mark.parametrize("seed", [0, 1])
def test_flips_bitwise(cfg, seed):
    (ti, tm), (ji, jm), (images, masks) = _both(cfg, seed)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tm, jm)


@pytest.mark.parametrize("cfg", [{"brightness": 0.1}, {"contrast": 0.1},
                                 {"hflip": True, "brightness": 0.1, "contrast": 0.1}])
def test_photometric_within_1e6(cfg):
    (ti, tm), (ji, jm), (images, masks) = _both(cfg, 2)
    np.testing.assert_allclose(ti, ji, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(tm, jm)
    assert ti.min() >= 0.0 and ti.max() <= 1.0


@pytest.mark.parametrize("cfg", [
    {"hflip": False, "rot_deg": 10.0},
    {"hflip": False, "scale_jitter": 0.1, "shift_px": 3.0},
    {"hflip": False, "elastic_alpha": 8.0, "elastic_grid": 16},
    {"hflip": True, "brightness": 0.1, "contrast": 0.1, "elastic_alpha": 34.0,
     "elastic_grid": 16, "rot_deg": 10.0, "scale_jitter": 0.1, "shift_px": 3.0},
])
def test_warp_within_1e4_masks_999(cfg):
    (ti, tm), (ji, jm), (images, masks) = _both(cfg, 3)
    np.testing.assert_allclose(ti, ji, atol=1e-4, rtol=0)
    assert (tm == jm).mean() >= 0.999
    assert set(np.unique(tm)) <= set(np.unique(masks))
    assert not np.allclose(ti, images)


def test_elastic_upsampling_keeps_edges_as_jax():
    """F.interpolate(bilinear, half-pixel) and jax.image.resize(bilinear)
    both keep the edge value past the outer sample centres (4x5 -> 40x56)."""
    field = np.random.default_rng(4).uniform(-1, 1, (2, 4, 5, 2)).astype(np.float32)
    j = np.asarray(jax.image.resize(jnp.asarray(field), (2, 40, 56, 2), method="bilinear"))
    t = F.interpolate(torch.from_numpy(field).permute(0, 3, 1, 2), size=(40, 56),
                      mode="bilinear", align_corners=False).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(t, j, atol=1e-6, rtol=0)
    # 40 / 4 = 10 output pixels a sample: the first and last 5 rows (and 5.6
    # columns) lie past the outer centres and hold the edge samples.
    np.testing.assert_allclose(t[:, :5, 0], np.repeat(field[:, :1, 0], 5, 1), atol=1e-6)
    np.testing.assert_allclose(t[:, -5:, -1], np.repeat(field[:, -1:, -1], 5, 1), atol=1e-6)


def test_identity_and_fixed_points():
    rng = np.random.default_rng(5)
    images = torch.from_numpy(rng.random((2, 24, 32, 3), dtype=np.float32))
    masks = torch.from_numpy(rng.integers(0, 2, (2, 24, 32)).astype(np.int32))
    none = TA.AugmentConfig(hflip=False)
    out = TA.augment_batch(images, masks, config=none, seed=0, step=0)
    assert torch.equal(out[0], images) and torch.equal(out[1], masks)
    warp = TA.AugmentConfig(hflip=False, rot_deg=15.0, elastic_alpha=8.0, elastic_grid=8)
    const = torch.full_like(images, 0.25)
    ci, _ = TA.augment_batch(const, masks, config=warp, seed=0, step=0)
    np.testing.assert_allclose(ci.numpy(), 0.25, atol=1e-6)


def test_same_seed_and_step_same_batch():
    rng = np.random.default_rng(6)
    images = torch.from_numpy(rng.random((4, 24, 32, 3), dtype=np.float32))
    masks = torch.from_numpy(rng.integers(0, 2, (4, 24, 32)).astype(np.int32))
    cfg = TA.AugmentConfig(hflip=True, brightness=0.1, contrast=0.1, elastic_alpha=8.0,
                           elastic_grid=8, rot_deg=10.0)
    a = TA.augment_batch(images, masks, config=cfg, seed=0, step=3)
    b = TA.augment_batch(images, masks, config=cfg, seed=0, step=3)
    c = TA.augment_batch(images, masks, config=cfg, seed=0, step=4)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    g = TA.augment_generator(0, 3, "cpu")
    assert g.device.type == "cpu"
    d = TA.draw_augment(cfg, 4, 24, 32, g)
    assert d.field.shape == (4, 4, 5, 2) and d.vflip is None and d.rot180 is None
    assert (d.rot_deg.abs() <= 10).all() and (d.field.abs() <= 1).all()


@pytest.mark.parametrize("argv", [["--augment"], ["--augment-elastic", "34"],
                                  ["--augment", "--augment-rot", "10", "--augment-scale", "0.1",
                                   "--augment-shift", "2"], []])
def test_cli_config_is_jaxs(argv):
    args, jargs = train_cli.get_args(argv), j_cli.get_args(argv)
    got = train_cli._build_augment(args)
    if not argv:
        assert got is None
        return
    want = j_cli._build_augment(jargs.augment, jargs.augment_elastic, jargs.augment_rot,
                                jargs.augment_scale, jargs.augment_shift)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
