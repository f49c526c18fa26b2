"""The port's mean-field CRF (``tpu_unet_torch/postprocess/crf.py``) against
the JAX package's ``tpu_unet/postprocess/crf.py``, on the CPU in fp32 with
the same seeded images and probabilities: within 1e-5, and the blur (a
depthwise ``F.conv2d`` here, a conv with a per-channel identity kernel
there) within fp32 rounding. Then ``predict_img(use_crf=True)`` and the
predict CLI's ``--crf`` against JAX's.
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from tpu_unet.checkpoint import save_checkpoint as j_save
from tpu_unet.models import UNetConfig as JConfig, init_unet as j_init, unet_apply as j_apply
from tpu_unet.postprocess.crf import _blur as j_blur, _gaussian_kernel1d as j_kernel
from tpu_unet.postprocess.crf import crf_refine as j_crf, crf_refine_binary as j_crf_binary
from tpu_unet.predict import main as j_predict_main, predict_img as j_predict_img
from tpu_unet_torch.checkpoint import tree_from_numpy
from tpu_unet_torch.models.unet import UNetConfig
from tpu_unet_torch.postprocess import crf_refine, crf_refine_binary
from tpu_unet_torch.postprocess.crf import _blur, _gaussian_kernel1d
from tpu_unet_torch.predict import main as predict_main, predict_img

TOL = 1e-5


def _inputs(seed, c):
    rng = np.random.default_rng(seed)
    image = rng.random((2, 40, 50, 3), dtype=np.float32)
    probs = rng.random((2, 40, 50, c), dtype=np.float32) + 1e-3
    return image, probs / probs.sum(-1, keepdims=True)


@pytest.mark.parametrize("sigma", [1.0, 3.0])
def test_blur_equals_jax(sigma):
    _, probs = _inputs(0, 3)
    r = int(2 * sigma)
    np.testing.assert_array_equal(_gaussian_kernel1d(sigma, r).numpy(),
                                  np.asarray(j_kernel(sigma, r)))
    got = _blur(torch.from_numpy(probs), _gaussian_kernel1d(sigma, r)).numpy()
    np.testing.assert_allclose(got, np.asarray(j_blur(jnp.asarray(probs), j_kernel(sigma, r))),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("c,kwargs", [(2, {}), (3, {}),
                                      (3, {"iters": 2, "spatial_sigma": 1.5, "compat": 1.0})])
def test_crf_refine_equals_jax(c, kwargs):
    image, probs = _inputs(c, c)
    got = crf_refine(torch.from_numpy(image), torch.from_numpy(probs), **kwargs)
    ref = np.asarray(j_crf(jnp.asarray(image), jnp.asarray(probs), **kwargs))
    assert got.shape == probs.shape
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)  # on the simplex
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=TOL)


def test_crf_refine_binary_equals_jax():
    rng = np.random.default_rng(4)
    # A smooth image and sigmoid probabilities, as predict gives them.
    image = np.clip(np.cumsum(rng.normal(0, 0.02, (1, 64, 80, 3)), axis=2) + 0.5, 0, 1)
    image = image.astype(np.float32)
    fg = (1 / (1 + np.exp(-rng.normal(0, 3, (1, 64, 80))))).astype(np.float32)
    got = crf_refine_binary(torch.from_numpy(image), torch.from_numpy(fg)).numpy()
    ref = np.asarray(j_crf_binary(jnp.asarray(image), jnp.asarray(fg)))
    assert got.shape == fg.shape and 0 <= got.min() and got.max() <= 1
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


def test_crf_denoises_salt_and_pepper():
    """An isolated flipped pixel inside a uniform region is flipped back
    (``tests/test_crf.py``'s case)."""
    h = w = 32
    fg = np.zeros((1, h, w), np.float32)
    fg[0, :h // 2] = 0.9  # top half foreground
    fg[0, h // 4, w // 2] = 0.1  # noise inside fg
    fg[0, 3 * h // 4, w // 2] = 0.9  # noise inside bg
    out = crf_refine_binary(torch.full((1, h, w, 3), 0.5), torch.from_numpy(fg), iters=5)
    assert out[0, h // 4, w // 2] > 0.5 and out[0, 3 * h // 4, w // 2] < 0.5


@pytest.fixture(scope="module")
def model():
    """Base 8, three classes, BN state set to a random batch's statistics."""
    jcfg = JConfig(3, 3, bilinear=False, base_channels=8)
    params, state = j_init(jax.random.PRNGKey(2), jcfg)
    x = jnp.asarray(np.random.default_rng(9).random((2, 32, 40, 3), dtype=np.float32))
    _, stepped = j_apply(params, state, x, config=jcfg, train=True)
    state = jax.tree.map(lambda new, old: (new - 0.9 * old) / 0.1, stepped, state)
    return jcfg, jax.device_get(params), jax.device_get(state)


@pytest.mark.parametrize("n_classes", [1, 3])
def test_predict_img_crf_equals_jax(model, n_classes):
    jcfg, params, state = model
    if n_classes == 1:  # the first output channel of the same net
        jcfg = jcfg._replace(n_classes=1)
        params = {**params, "outc": {"w": params["outc"]["w"][..., :1],
                                     "b": params["outc"]["b"][:1]}}
    img = Image.fromarray(np.random.default_rng(5).integers(0, 255, (44, 52, 3), np.uint8))
    ref = j_predict_img(params, state, jcfg, img, scale_factor=0.5, use_crf=True)
    got = predict_img(tree_from_numpy(params), tree_from_numpy(state), UNetConfig(*jcfg), img,
                      scale_factor=0.5, use_crf=True, device="cpu")
    assert got.shape == (44, 52) and len(np.unique(ref)) > 1
    assert (got != ref).mean() < 1e-3


def test_predict_cli_crf_equals_jax(model, tmp_path):
    jcfg, params, state = model
    ckpt = tmp_path / "m.npz"
    j_save(ckpt, params, state, mask_values=[0, 100, 200], extra={"config": jcfg._asdict()})
    img_path = tmp_path / "in.png"
    Image.fromarray(np.random.default_rng(6).integers(0, 255, (36, 48, 3), np.uint8)).save(
        img_path)
    argv = ["-m", str(ckpt), "-i", str(img_path), "-s", "0.5", "--crf"]
    j_predict_main(argv + ["-o", str(tmp_path / "j.png")])
    predict_main(argv + ["-o", str(tmp_path / "t.png"), "--device", "cpu"])
    ref, got = (np.asarray(Image.open(tmp_path / f"{n}.png")) for n in ("j", "t"))
    assert got.shape == ref.shape and len(np.unique(ref)) > 1
    assert (got != ref).mean() < 1e-3
