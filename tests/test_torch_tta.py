"""The port's flip TTA (``tpu_unet_torch/models/tta.py``) against the JAX
package's ``tpu_unet/models/tta.py``, on the CPU in fp32 at base 8, the same
weights (JAX's init, converted) and the same seeded inputs.

Tolerances: logits ``atol=rtol=1e-4`` against JAX (both sum the same views
in the same order; the convs differ by fp32 rounding); the port's batched
and one-view-at-a-time forms within ``atol=1e-5`` of each other, as
``tests/test_tta.py`` holds JAX's two forms.
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from tpu_unet.models import UNetConfig as JConfig, init_unet as j_init, unet_apply as j_apply
from tpu_unet.models.tta import tta_logits as j_tta_logits, tta_merge as j_merge
from tpu_unet.models.tta import tta_views as j_views
from tpu_unet.predict import predict_img as j_predict_img
from tpu_unet_torch.checkpoint import tree_from_numpy
from tpu_unet_torch.models.tta import TTA_MODES, flip, tta_logits, tta_merge, tta_views
from tpu_unet_torch.models.unet import UNetConfig, unet_apply
from tpu_unet_torch.predict import predict_img

JCFG = JConfig(3, 1, bilinear=False, base_channels=8)
CFG = UNetConfig(*JCFG)


@pytest.fixture(scope="module")
def model():
    """JAX's init with the BN state set to a random batch's statistics
    (recovered from one train-mode step's momentum-0.1 update), so the masks
    have both classes."""
    params, state = j_init(jax.random.PRNGKey(0), JCFG)
    x = jnp.asarray(np.random.default_rng(9).random((2, 32, 40, 3), dtype=np.float32))
    _, stepped = j_apply(params, state, x, config=JCFG, train=True)
    state = jax.tree.map(lambda new, old: (new - 0.9 * old) / 0.1, stepped, state)
    params, state = jax.device_get((params, state))
    return params, state, tree_from_numpy(params), tree_from_numpy(state)


@pytest.mark.parametrize("mode", ["flips", "hflip"])
def test_views_and_merge_equal_jax(mode):
    x = np.random.default_rng(0).random((2, 6, 10, 3), dtype=np.float32)
    views = tta_views(torch.from_numpy(x), mode)
    np.testing.assert_array_equal(views.numpy(), np.asarray(j_views(jnp.asarray(x), mode)))
    assert views.shape[0] == 2 * len(TTA_MODES[mode])
    # Merging the views of x themselves undoes every flip: the mean is x.
    merged = tta_merge(views, 2, mode).numpy()
    ref = j_merge(jnp.asarray(views.numpy()), 2, mode)
    np.testing.assert_array_equal(merged, np.asarray(ref))
    np.testing.assert_allclose(merged, x, rtol=0, atol=1e-7)


@pytest.mark.parametrize("mode", ["flips", "hflip"])
def test_tta_logits_equal_jax(model, mode):
    params, state, tp, ts = model
    # Odd sizes: the floor/ceil skip padding under flips.
    x = np.random.default_rng(1).random((2, 34, 46, 3), dtype=np.float32)
    ref = np.asarray(j_tta_logits(params, state, jnp.asarray(x), config=JCFG, mode=mode))
    for batched in (True, False):
        with torch.inference_mode():
            got = tta_logits(tp, ts, torch.from_numpy(x), config=CFG, mode=mode,
                             batched=batched).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("mode", ["flips", "hflip"])
def test_tta_scanned_matches_batched(model, mode):
    _, _, tp, ts = model
    x = torch.from_numpy(np.random.default_rng(2).random((2, 34, 46, 3), dtype=np.float32))
    with torch.inference_mode():
        batched = tta_logits(tp, ts, x, config=CFG, mode=mode).numpy()
        scanned = tta_logits(tp, ts, x, config=CFG, mode=mode, batched=False).numpy()
    np.testing.assert_allclose(scanned, batched, rtol=0, atol=1e-5)


def test_tta_logits_are_the_mean_of_flipped_forwards(model):
    """The four views by hand: flip, forward, flip back, average."""
    _, _, tp, ts = model
    x = torch.from_numpy(np.random.default_rng(3).random((1, 32, 40, 3), dtype=np.float32))
    with torch.inference_mode():
        outs = [flip(unet_apply(tp, ts, flip(x, fh, fw), config=CFG)[0], fh, fw)
                for fh, fw in TTA_MODES["flips"]]
        got = tta_logits(tp, ts, x, config=CFG)
    np.testing.assert_allclose(got.numpy(), torch.stack(outs).mean(0).numpy(), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("mode", ["flips", "hflip"])
def test_predict_img_tta_equals_jax(model, mode):
    params, state, tp, ts = model
    img = Image.fromarray(np.random.default_rng(4).integers(0, 255, (40, 56, 3), np.uint8))
    ref = j_predict_img(params, state, JCFG, img, scale_factor=1.0, tta=True, tta_mode=mode)
    got = predict_img(tp, ts, CFG, img, scale_factor=1.0, tta=True, tta_mode=mode,
                      device="cpu")
    assert got.shape == (40, 56) and got.dtype == bool and 0 < ref.mean() < 1
    assert (got != ref).mean() < 1e-3
