"""The port's halo-sharded inference (``tpu_unet_torch/parallel/tiling.py::
make_halo_sharded_forward``, ``predict.py::predict_img_halo_sharded``,
``predict --tile-sharded``) on the CPU, fp32, base 8, ConvT decoder,
against the JAX package's ``tpu_unet/parallel/tiling.py`` and
``predict.py``: 2 gloo ranks spawned once for the module
(``tests/torch_dp_workers.py``), JAX on its virtual CPU mesh. (The bilinear
decoder upsamples with ``align_corners=True``, whose sample points depend
on the window's size, so no windowed forward of it is exact, in either
package: at base 8 JAX's 8-band mask of the 2048x64 image below differs
from its full-image mask in 1.6% of the pixels.)

- a 512x64 input (band 256, halo 128: each window the whole image) and a
  1024x64 one (band 512: windows of 768 rows, rank 1's from rank 0's rows)
  through the 2-rank forward against JAX's ``make_halo_sharded_forward`` on
  a 2-device ``spatial`` mesh with the same weights: 5e-4 + 1e-4 relative,
  the bar ``tests/test_tiling.py`` holds JAX's sharded forward to against
  its full forward (the 18 eval-BN layers amplify rounding); and the port's
  own full forward to the same;
- the fallbacks (an image too small, H not a multiple of 16 · ranks, a
  band under 2·halo) warn and give ``predict_img``'s mask; one process
  (no rank group) likewise;
- ``predict --tile-sharded`` under 2 ranks on a 2048x64 image writes from
  rank 0 alone the mask that JAX's ``predict_img_halo_sharded`` gives (its
  8 CPU devices, band 256), all but 1e-3 of the pixels (ties at the
  threshold), as JAX's own sharded mask is held to its full one; run as one
  process the CLI falls back with JAX's warning and writes ``predict``'s
  mask;
- ``predict_img_halo_sharded(tta=True)`` on the same image (the four flip
  views of the whole image as batch rows of one sharded forward, vflip
  among them, so each rank's band of a flipped view is the other end of
  the image) against JAX's ``predict_img_halo_sharded(tta=True)``, at the
  same ties bound.
"""

import functools
import logging

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from tests.test_torch_train import _numpy
from tests.torch_dp_workers import jobs_worker, port_numpy, run_ranks
from tpu_unet.models import UNetConfig as JConfig, init_unet as j_init, unet_apply as j_apply
from tpu_unet.parallel.mesh import make_mesh
from tpu_unet.parallel.tiling import make_halo_sharded_forward as j_halo_forward
from tpu_unet.predict import predict_img_halo_sharded as j_predict_sharded
from tpu_unet_torch import predict as t_predict
from tpu_unet_torch.checkpoint import save_checkpoint, tree_from_numpy
from tpu_unet_torch.models.unet import UNetConfig, unet_apply
from tpu_unet_torch.parallel.mesh import DataParallel
from tpu_unet_torch.parallel.tiling import make_halo_sharded_forward

JCFG = JConfig(3, 1, bilinear=False, base_channels=8)
CFG = UNetConfig(*JCFG)
HALO = 128
TOL = dict(atol=5e-4, rtol=1e-4)
TIES = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _net():
    """JAX's init with the BN state set to a random batch's statistics, so
    the masks have both classes (``tests/test_torch_tiling.py``)."""
    params, state = jax.jit(j_init, static_argnums=1)(jax.random.PRNGKey(0), JCFG)
    x = jnp.asarray(np.random.default_rng(9).random((1, 64, 64, 3), dtype=np.float32))
    _, stepped = j_apply(params, state, x, config=JCFG, train=True)
    state = jax.tree.map(lambda new, old: (new - 0.9 * old) / 0.1, stepped, state)
    return _numpy(params), _numpy(state)


def _xs():
    rng = np.random.default_rng(1)
    return [rng.standard_normal((1, h, 64, 3), dtype=np.float32) for h in (512, 1024)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tile_sharded")
    params, state = _net()
    ckpt = tmp / "ckpt.npz"
    save_checkpoint(ckpt, tree_from_numpy(params), tree_from_numpy(state),
                    mask_values=[0, 1], extra={"config": CFG._asdict()})
    rng = np.random.default_rng(7)
    images = []
    for k in range(2):
        images.append(str(tmp / f"big{k}.png"))
        Image.fromarray(rng.integers(0, 255, (2048, 64, 3), np.uint8)).save(images[-1])
    jobs = [("tile_worker", (port_numpy(params), port_numpy(state), _xs(), str(ckpt), images,
                             str(tmp)))]
    return tmp, ckpt, images, [r[0] for r in run_ranks(jobs_worker, 2, tmp, jobs)]


def test_halo_sharded_forward_matches_jax(world):
    *_, ranks = world
    params, state = _net()
    fwd = j_halo_forward(make_mesh(n_devices=2, axis="spatial"), JCFG, halo=HALO)
    for k, x in enumerate(_xs()):
        ref = np.asarray(fwd(params, state, jnp.asarray(x)))
        with torch.inference_mode():
            full, _ = unet_apply(tree_from_numpy(params), tree_from_numpy(state),
                                 torch.from_numpy(x), config=CFG)
        for r in ranks:
            np.testing.assert_array_equal(r["logits"][k], ranks[0]["logits"][k])
            np.testing.assert_allclose(r["logits"][k], ref, **TOL)
            np.testing.assert_allclose(r["logits"][k], full.numpy(), **TOL)


def test_fallbacks_warn_and_equal_the_full_forward(world, caplog):
    *_, ranks = world
    for r in ranks:
        assert [(f["equal"], f["warned"]) for f in r["fallbacks"]] == [(True, True)] * 3
    params, state = (tree_from_numpy(t) for t in _net())
    img = Image.fromarray(np.random.default_rng(2).integers(0, 255, (512, 64, 3), np.uint8))
    with caplog.at_level(logging.WARNING, logger="tpu_unet_torch.predict"):
        got = t_predict.predict_img_halo_sharded(params, state, CFG, img, scale_factor=1.0,
                                                 device="cpu")
    assert "halo-sharded constraints not met (devices=1" in caplog.text
    np.testing.assert_array_equal(
        got, t_predict.predict_img(params, state, CFG, img, scale_factor=1.0, device="cpu"))


def test_forward_checks_its_shapes():
    record = DataParallel(group=None, host_group=None, rank=0, world_size=2,
                          device=torch.device("cpu"))
    fwd = make_halo_sharded_forward(record, CFG, halo=HALO)
    for shape, match in (((1, 264, 64, 3), "band=264 must be a multiple of 16"),
                         ((1, 256, 72, 3), "W=72 must be a multiple of 16"),
                         ((1, 160, 64, 3), "window 416 exceeds image height 320")):
        with pytest.raises(ValueError, match=match):
            fwd({}, {}, torch.zeros(shape))
    with pytest.raises(ValueError, match="halo=120 must be a multiple of 16"):
        make_halo_sharded_forward(record, CFG, halo=120)({}, {}, torch.zeros(1, 256, 64, 3))


def test_predict_cli_tile_sharded_writes_jax_mask(world, tmp_path, monkeypatch, caplog):
    tmp, ckpt, images, ranks = world
    params, state = _net()
    for r in ranks:
        assert r["written"] == [r is ranks[0]] * len(images)
    for k, path in enumerate(images):
        ref = j_predict_sharded(params, state, JCFG, Image.open(path), scale_factor=1.0)
        got = np.asarray(Image.open(tmp / f"rank0_{k}.png"))
        assert got.shape == ref.shape == (2048, 64) and 0 < ref.mean() < 1
        assert (got.astype(bool) != ref).mean() < TIES
    # One process: JAX's fallback, with its warning, and predict's mask.
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    one, plain = tmp_path / "one.png", tmp_path / "plain.png"
    with caplog.at_level(logging.WARNING, logger="tpu_unet_torch.predict"):
        t_predict.main(["-m", str(ckpt), "-i", images[0], "-o", str(one), "-s", "1.0",
                        "--tile-sharded", "--device", "cpu"])
    assert "falling back to single-device forward" in caplog.text
    t_predict.main(["-m", str(ckpt), "-i", images[0], "-o", str(plain), "-s", "1.0",
                    "--device", "cpu"])
    np.testing.assert_array_equal(np.asarray(Image.open(one)), np.asarray(Image.open(plain)))
    assert not torch.distributed.is_initialized()


def test_tta_views_ride_as_batch_rows(world):
    _, _, images, ranks = world
    params, state = _net()
    img = Image.open(images[0])
    ref = j_predict_sharded(params, state, JCFG, img, scale_factor=1.0, tta=True)
    plain = j_predict_sharded(params, state, JCFG, img, scale_factor=1.0)
    assert ref.shape == (2048, 64) and (ref != plain).any()  # the views change the mask
    for r in ranks:
        np.testing.assert_array_equal(r["tta"], ranks[0]["tta"])
    assert (ranks[0]["tta"] != ref).mean() < TIES
