"""The port's single-device tiled inference (``tpu_unet_torch/parallel/
tiling.py``) against the JAX package's ``tpu_unet/parallel/tiling.py``, and
against the port's own full-image forward, on the CPU in fp32 at base 4 and
JAX's sizes (384² with tile 128 and halo 128, ``tests/test_tiling.py``).

Tolerances: logits ``atol=rtol=1e-4``; masks equal except at ties, fewer
than 1e-3 of the pixels differing.
"""

import logging

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from tpu_unet.models import UNetConfig as JConfig, init_unet as j_init, unet_apply as j_apply
from tpu_unet.parallel.tiling import predict_img_tiled as j_predict_img_tiled
from tpu_unet.parallel.tiling import tiled_forward as j_tiled_forward
from tpu_unet_torch.checkpoint import tree_from_numpy
from tpu_unet_torch.models.unet import UNetConfig, unet_apply
from tpu_unet_torch.parallel.tiling import (
    DEFAULT_HALO,
    min_halo,
    padded_hw,
    predict_img_tiled,
    tiled_forward,
    tiled_forward_padded,
    window_coords,
)
from tpu_unet_torch.predict import predict_img

JCFG = JConfig(3, 2, bilinear=False, base_channels=4)
CFG = UNetConfig(*JCFG)
HALO = 128


@pytest.fixture(scope="module")
def net():
    """JAX's init with the BN state set to a random batch's statistics, so
    the argmax masks have both classes."""
    params, state = j_init(jax.random.PRNGKey(0), JCFG)
    x = jnp.asarray(np.random.default_rng(9).random((1, 64, 64, 3), dtype=np.float32))
    _, stepped = j_apply(params, state, x, config=JCFG, train=True)
    state = jax.tree.map(lambda new, old: (new - 0.9 * old) / 0.1, stepped, state)
    params, state = jax.device_get((params, state))
    return params, state, tree_from_numpy(params), tree_from_numpy(state)


def _image(h, w, seed=5):
    return Image.fromarray(np.random.default_rng(seed).integers(0, 255, (h, w, 3), np.uint8))


# 384²: 9 windows, one group padded from 1 to 4 by repeating the last window;
# 400x416: the last row and column of cores are moved back to end at the edge.
@pytest.mark.parametrize("hw", [(384, 384), (400, 416)])
def test_tiled_equals_full_and_jax(net, hw):
    params, state, tp, ts = net
    x = np.random.default_rng(0).standard_normal((1, *hw, 3), dtype=np.float32)
    with torch.inference_mode():
        tiled = tiled_forward(tp, ts, torch.from_numpy(x), config=CFG, tile=128, halo=HALO)
        full, _ = unet_apply(tp, ts, torch.from_numpy(x), config=CFG)
    ref = np.asarray(j_tiled_forward(params, state, jnp.asarray(x), config=JCFG, tile=128,
                                     halo=HALO))
    np.testing.assert_allclose(tiled.numpy(), full.numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tiled.numpy(), ref, atol=1e-4, rtol=1e-4)


def test_window_coords_cover_the_image():
    h, w, tile, halo = 400, 416, 128, 128
    seen = np.zeros((h, w), np.int64)
    for sy, sx, ay, ax in window_coords(h, w, tile, halo):
        assert sy % 16 == 0 and sx % 16 == 0
        assert 0 <= sy <= ay and ay + tile <= sy + tile + 2 * halo <= h
        assert 0 <= sx <= ax and ax + tile <= sx + tile + 2 * halo <= w
        seen[ay:ay + tile, ax:ax + tile] += 1
    assert seen.min() >= 1
    assert padded_hw(959, 640) == (960, 640) and padded_hw(384, 384) == (384, 384)


def test_tiled_rejects_unaligned_and_small_halo(net):
    _, _, tp, ts = net
    with pytest.raises(ValueError, match="multiple of 16"):
        tiled_forward(tp, ts, torch.zeros(1, 100, 96, 3), config=CFG, tile=32, halo=HALO)
    with pytest.raises(ValueError, match="exceeds image"):
        tiled_forward(tp, ts, torch.zeros(1, 256, 256, 3), config=CFG, tile=128, halo=HALO)
    with pytest.raises(ValueError, match="below the exactness requirement"):
        tiled_forward(tp, ts, torch.zeros(1, 384, 384, 3), config=CFG, tile=128, halo=64)
    assert min_halo(CFG) == DEFAULT_HALO == 128
    assert min_halo(CFG._replace(arch="r2u")) == 352  # 110·3 + 18, 16-aligned


def test_predict_img_tiled_equals_full_and_jax(net):
    params, state, tp, ts = net
    img = _image(384, 384)
    tiled = predict_img_tiled(tp, ts, CFG, img, tile=128, halo=HALO, scale_factor=1.0,
                              device="cpu")
    full = predict_img(tp, ts, CFG, img, scale_factor=1.0, device="cpu")
    ref = j_predict_img_tiled(params, state, JCFG, img, tile=128, halo=HALO, scale_factor=1.0)
    assert tiled.shape == (384, 384) and 0 < ref.mean() < 1
    assert (tiled != full).mean() < 1e-3
    assert (tiled != ref).mean() < 1e-3


def test_padded_tiling_unaligned_image(net, caplog):
    """376 % 16 != 0, the class of Carvana's 959x640: zero-padded to 384²,
    swept, cropped back, with a warning; agrees with JAX; its logits are the
    crop of the full-image forward of the zero-padded image, and more than
    one halo above the padded edge those of the unpadded image."""
    params, state, tp, ts = net
    img = _image(376, 384)
    with caplog.at_level(logging.WARNING, logger="tpu_unet_torch.parallel.tiling"):
        tiled = predict_img_tiled(tp, ts, CFG, img, tile=128, halo=HALO, scale_factor=1.0,
                                  device="cpu")
    assert any("padding 376x384 -> 384x384" in r.getMessage() for r in caplog.records)
    ref = j_predict_img_tiled(params, state, JCFG, img, tile=128, halo=HALO, scale_factor=1.0)
    assert tiled.shape == (376, 384)
    assert (tiled != ref).mean() < 1e-3
    x = torch.from_numpy(np.asarray(img, np.float32)[None] / 255)
    with torch.inference_mode():
        padded = tiled_forward_padded(tp, ts, x, config=CFG, tile=128, halo=HALO)
        full, _ = unet_apply(tp, ts, torch.nn.functional.pad(x, (0, 0, 0, 0, 0, 8)), config=CFG)
        unpadded, _ = unet_apply(tp, ts, x, config=CFG)
    assert padded.shape == (1, 376, 384, 2)
    np.testing.assert_allclose(padded.numpy(), full[:, :376].numpy(), atol=1e-4, rtol=1e-4)
    away = 376 - HALO
    np.testing.assert_allclose(padded[:, :away].numpy(), unpadded[:, :away].numpy(), atol=1e-4,
                               rtol=1e-4)


def test_tiled_fallback_warns(net, caplog):
    """An image smaller than one window even after padding runs the
    full-image forward, said out loud; a halo below the arch's need is
    raised to it."""
    _, _, tp, ts = net
    img = _image(100, 120)
    with caplog.at_level(logging.WARNING, logger="tpu_unet_torch.parallel.tiling"):
        got = predict_img_tiled(tp, ts, CFG, img, tile=64, halo=32, scale_factor=1.0,
                                device="cpu")
    messages = " ".join(r.getMessage() for r in caplog.records)
    assert "using halo=128" in messages and "falling back to full-image" in messages
    np.testing.assert_array_equal(got, predict_img(tp, ts, CFG, img, scale_factor=1.0,
                                                   device="cpu"))


@pytest.mark.parametrize("mode", ["flips", "hflip"])
def test_predict_img_tiled_tta_equals_jax(net, mode):
    """The flip views are batch rows of one sweep, merged after it."""
    params, state, tp, ts = net
    img = _image(384, 384, seed=6)
    got = predict_img_tiled(tp, ts, CFG, img, tile=128, halo=HALO, scale_factor=1.0, tta=True,
                            tta_mode=mode, device="cpu")
    ref = j_predict_img_tiled(params, state, JCFG, img, tile=128, halo=HALO, scale_factor=1.0,
                              tta=True, tta_mode=mode)
    full = predict_img(tp, ts, CFG, img, scale_factor=1.0, tta=True, tta_mode=mode,
                       device="cpu")
    assert (got != ref).mean() < 1e-3
    assert (got != full).mean() < 1e-3
