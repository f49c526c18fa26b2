"""The port's device-side preprocess (``tpu_unet_torch.data.device_pipeline``)
against the JAX package's and against the host path, on the CPU, bitwise:
the int32 Pillow resample at the shapes of ``tests/test_device_pipeline.py``
(down, up, anisotropic, identity on one axis) in one and three channels,
the per-image /255 rule, NEAREST masks with scalar and RGB palettes, the
eligibility of modes; then ``predict --device-preprocess`` (one image,
batched, palette fallback) and ``serve`` (``--device-preprocess``, and
``--tile`` whose default turns it on) against JAX's and the host path.
"""

import logging

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

import tpu_unet.data.device_pipeline as J
import tpu_unet.predict as j_predict
from tpu_unet.checkpoint import load_checkpoint as j_load, save_checkpoint as j_save
from tpu_unet.models import UNetConfig as JConfig, init_unet as j_init, unet_apply as j_apply
from tpu_unet.serve import BatchedPredictor as JPredictor
import tpu_unet_torch.data.device_pipeline as T
import tpu_unet_torch.predict as t_predict
from tpu_unet_torch.checkpoint import load_checkpoint
from tpu_unet_torch.data import preprocess, preprocess_mask
from tpu_unet_torch.models import UNetConfig
from tpu_unet_torch.serve import BatchedPredictor

SHAPES = [((48, 64), (24, 32)), ((48, 64), (37, 53)), ((40, 56), (13, 47)),
          ((24, 32), (48, 64)), ((48, 64), (48, 32)), ((48, 64), (24, 64))]


@pytest.mark.parametrize("in_hw,out_hw", SHAPES)
@pytest.mark.parametrize("channels", [1, 3])
def test_resample_equals_jax_and_pillow(in_hw, out_hw, channels):
    img = np.random.default_rng(sum(in_hw + out_hw)).integers(
        0, 256, (2, *in_hw, channels)).astype(np.uint8)
    got = T.device_resample_u8(torch.from_numpy(img), out_h=out_hw[0], out_w=out_hw[1])
    assert got.dtype == torch.int32 and got.shape == (2, *out_hw, channels)
    got = got.numpy()
    np.testing.assert_array_equal(
        got, np.asarray(J.device_resample_u8(jnp.asarray(img), out_h=out_hw[0],
                                             out_w=out_hw[1])))
    for n in range(2):
        pil = Image.fromarray(img[n] if channels == 3 else img[n, :, :, 0])
        want = np.asarray(pil.resize(out_hw[::-1], resample=Image.BICUBIC))
        np.testing.assert_array_equal(got[n], want.reshape(got[n].shape))


@pytest.mark.parametrize("in_hw,out_hw", SHAPES)
def test_preprocess_images_equal_jax_and_host(in_hw, out_hw):
    img = np.random.default_rng(7 + sum(in_hw)).integers(0, 256, (2, *in_hw, 3)).astype(np.uint8)
    got = T.device_preprocess_images(torch.from_numpy(img), out_h=out_hw[0], out_w=out_hw[1])
    assert got.dtype == torch.float32
    got = got.numpy()
    ref = np.asarray(J.device_preprocess_images(jnp.asarray(img), out_h=out_hw[0],
                                                out_w=out_hw[1]))
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    if out_hw[0] * 2 == in_hw[0] and out_hw[1] * 2 == in_hw[1]:  # the host path's scale 0.5
        for n in range(2):
            host = preprocess(Image.fromarray(img[n]), 0.5)
            np.testing.assert_array_equal(got[n].view(np.uint32), host.view(np.uint32))


def test_division_rule_per_image_and_table():
    imgs = np.zeros((3, 8, 8, 1), np.uint8)
    imgs[1] += 200  # /255
    imgs[2] += 1  # max == 1: not divided
    got = T.device_preprocess_images(torch.from_numpy(imgs), out_h=8, out_w=8).numpy()
    assert got[0].max() == 0.0 and (got[2] == 1.0).all()
    np.testing.assert_array_equal(got[1], np.float32(200) / np.float32(255))
    # The table is numpy's division, byte for byte, and JAX's.
    np.testing.assert_array_equal(T.u8_table("cpu").numpy(),
                                  np.arange(256, dtype=np.float32) / 255.0)


@pytest.mark.parametrize("out_hw", [(24, 32), (17, 23), (123, 61), (40, 56)])
def test_nearest_masks_equal_jax_and_host(out_hw):
    mask = (np.random.default_rng(out_hw[0]).integers(0, 3, (2, 40, 56)) * 127).astype(np.uint8)
    values = [0, 127, 254]
    got = T.device_preprocess_masks(torch.from_numpy(mask), torch.tensor(values),
                                    out_h=out_hw[0], out_w=out_hw[1])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(J.device_preprocess_masks(
        jnp.asarray(mask), jnp.asarray(values), out_h=out_hw[0], out_w=out_hw[1])))
    scale = out_hw[1] / 56
    if int(scale * 56) == out_hw[1] and int(scale * 40) == out_hw[0]:
        for n in range(2):
            np.testing.assert_array_equal(
                got[n].numpy(), preprocess_mask(values, Image.fromarray(mask[n]), scale))


def test_rgb_palette_and_unmatched_values():
    mask = np.zeros((1, 8, 8, 3), np.uint8)
    mask[0, 4:, :] = [255, 0, 0]
    mask[0, :2, :2] = [9, 9, 9]  # in no palette entry: class 0, as on the host
    values = [[0, 0, 0], [255, 0, 0]]
    got = T.device_preprocess_masks(torch.from_numpy(mask), torch.tensor(values), out_h=8,
                                    out_w=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(J.device_preprocess_masks(
        jnp.asarray(mask), jnp.asarray(values), out_h=8, out_w=8)))
    np.testing.assert_array_equal(got[0].numpy(),
                                  preprocess_mask(values, Image.fromarray(mask[0]), 1.0))
    assert got[0, 7, 0] == 1 and got[0, 0, 0] == 0


def test_raw_u8_for_device_modes_equal_jax():
    rng = np.random.default_rng(0)
    rgb = Image.fromarray(rng.integers(0, 255, (8, 8, 3), dtype=np.uint8))
    gray = Image.fromarray(rng.integers(0, 255, (8, 8), dtype=np.uint8))
    i16 = Image.fromarray(rng.integers(0, 65535, (8, 8)).astype(np.int32), mode="I")
    for img in (rgb, gray, rgb.convert("P"), gray.convert("1"), i16, rgb.convert("RGBA"),
                gray.convert("LA")):
        got, ref = T.raw_u8_for_device(img), J.raw_u8_for_device(img)
        assert (got is None) == (ref is None) == (img.mode not in ("L", "RGB"))
        if got is not None:
            assert got.ndim == 3
            np.testing.assert_array_equal(got, ref)


# One input channel: L images take the device path, palette ('P') images,
# also one channel, the host fallback, so both kinds run on one model.
JCFG = JConfig(1, 1, bilinear=False, base_channels=8)
CFG = UNetConfig(*JCFG)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A JAX checkpoint with BN statistics of a random batch and the head's
    bias at that batch's median logit, so masks have both classes."""
    params, state = j_init(jax.random.PRNGKey(1), JCFG)
    x = jnp.asarray(np.random.default_rng(0).random((2, 32, 40, 1), dtype=np.float32))
    _, stepped = j_apply(params, state, x, config=JCFG, train=True)
    state = jax.tree.map(lambda new, old: (new - 0.9 * old) / 0.1, stepped, state)
    logits, _ = j_apply(params, state, x, config=JCFG)
    params["outc"]["b"] = params["outc"]["b"] - jnp.median(logits)
    path = tmp_path_factory.mktemp("ckpt") / "unet8.npz"
    j_save(path, params, state, mask_values=[0, 255], extra={"config": JCFG._asdict()})
    return path


def _jax_model(ckpt):
    jp, js = j_init(jax.random.PRNGKey(0), JCFG)
    return j_load(ckpt, jp, js)


def _img(seed, h, w, mode="L"):
    img = Image.fromarray(np.random.default_rng(seed).integers(0, 255, (h, w, 3), np.uint8))
    return img.convert(mode)


def test_predict_img_device_preprocess_equals_host_and_jax(ckpt, caplog):
    params, state, _, _ = load_checkpoint(ckpt, CFG)
    jp, js, _, _ = _jax_model(ckpt)
    for k, mode in enumerate(("L", "P")):  # P: the host fallback, with a warning
        img = _img(k, 64, 80, mode)
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            got = t_predict.predict_img(params, state, CFG, img, device_preprocess=True,
                                        device="cpu")
        assert ("not device-preprocessable" in caplog.text) == (mode == "P")
        assert 0 < got.mean() < 1
        np.testing.assert_array_equal(
            got, t_predict.predict_img(params, state, CFG, img, device="cpu"))
        np.testing.assert_array_equal(got, j_predict.predict_img(
            jp, js, JCFG, img, device_preprocess=True))


def test_iter_predicted_masks_device_preprocess_groups_equal_jax(ckpt, tmp_path, monkeypatch):
    """Raw and host-preprocessed inputs of one shape never share a batch
    (the group key carries the kind); each mask equals JAX's."""
    files = []
    for k, (size, mode) in enumerate([((48, 64), "L"), ((48, 64), "L"), ((48, 64), "P"),
                                      ((48, 64), "L"), ((40, 56), "L")]):
        files.append(str(tmp_path / f"in{k}.png"))
        _img(20 + k, *size, mode).save(files[-1])
    seen = {"port": [], "jax": []}
    for mod, tag in ((t_predict, "port"), (j_predict, "jax")):
        real = mod._forward_full

        def recording(params, state, x, *, _real=real, _tag=tag, **kw):
            seen[_tag].append(int(x.shape[0]))
            return _real(params, state, x, **kw)

        monkeypatch.setattr(mod, "_forward_full", recording)
    params, state, _, _ = load_checkpoint(ckpt, CFG)
    jp, js, _, _ = _jax_model(ckpt)
    got = list(t_predict.iter_predicted_masks(params, state, CFG, files, batch_size=4,
                                              device_preprocess=True, device="cpu"))
    ref = list(j_predict.iter_predicted_masks(jp, js, JCFG, files, batch_size=4,
                                              device_preprocess=True))
    assert seen["port"] == seen["jax"] == [2, 1, 1, 1]
    for (f, _, mask), (jf, _, jmask) in zip(got, ref):
        assert f == jf
        np.testing.assert_array_equal(mask, jmask)


def test_predict_cli_device_preprocess_equals_jax(ckpt, tmp_path):
    files = []
    for k in range(3):
        files.append(str(tmp_path / f"in{k}.png"))
        _img(30 + k, 48, 64).save(files[-1])
    for flags in ([], ["--batch-size", "2"]):
        for tag, run in (("jax", j_predict.main), ("port", t_predict.main)):
            outs = [str(tmp_path / f"{tag}{k}.png") for k in range(3)]
            run(["-m", str(ckpt), "-i", *files, "-o", *outs, "--device-preprocess", *flags]
                + (["--device", "cpu"] if tag == "port" else []))
        for k in range(3):
            ref = np.asarray(Image.open(tmp_path / f"jax{k}.png"))
            assert 0 < ref.mean() < 255
            np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / f"port{k}.png")), ref)


@pytest.mark.parametrize("kw", [{"tile": 128}, {"device_preprocess": True, "tta": True},
                                {"device_preprocess": True, "kernels": "torch"}])
def test_serve_device_preprocess_equals_jax_and_host(ckpt, kw):
    """Raw canvases resized on the device before whichever forward runs:
    the tiled sweep (its default), the TTA ensemble, the folded forward. A
    palette request takes the host path in a group of its own."""
    params, state, mv, _ = load_checkpoint(ckpt, CFG)
    jp, js, jmv, _ = _jax_model(ckpt)
    jkw = dict(kw, kernels="xla") if "kernels" in kw else kw
    scale = 1.0 if "tile" in kw else 0.5
    pred = BatchedPredictor(params, state, CFG, mv, device="cpu", amp=False, scale=scale, **kw)
    host = BatchedPredictor(params, state, CFG, mv, device="cpu", amp=False, scale=scale,
                            **dict(kw, device_preprocess=False))
    jpred = JPredictor(jp, js, JCFG, jmv, amp=False, scale=scale, **jkw)
    try:
        assert pred.device_preprocess and jpred.device_preprocess
        size = (384, 400) if "tile" in kw else (74, 96)
        for k, mode in enumerate(("L", "P", "L")):
            img = _img(40 + k, *size, mode)
            got = pred.predict_one(img)
            assert 0 < got.mean() < 1
            np.testing.assert_array_equal(got, jpred.predict_one(img))
            np.testing.assert_array_equal(got, host.predict_one(img))
        assert pred._dp_warned_modes == {"P"}
    finally:
        for p in (pred, host, jpred):
            p.stop()


def test_device_pipeline_moves_host_batches_and_accepts_device_batches():
    rng = np.random.default_rng(3)
    batch = {"image": rng.integers(0, 256, (2, 40, 56, 3)).astype(np.uint8),
             "mask": (rng.integers(0, 2, (2, 40, 56)) * 255).astype(np.uint8)}
    for loader in ([batch], [{k: torch.from_numpy(v) for k, v in batch.items()}]):
        pipe = T.DevicePipeline(loader, [0, 255], 0.5, 40, 56, device="cpu")
        assert len(pipe) == 1
        (out,) = list(pipe)
        ref_i = J.device_preprocess_images(jnp.asarray(batch["image"]), out_h=20, out_w=28)
        ref_m = J.device_preprocess_masks(jnp.asarray(batch["mask"]), jnp.asarray([0, 255]),
                                          out_h=20, out_w=28)
        np.testing.assert_array_equal(out["image"].numpy(), np.asarray(ref_i))
        np.testing.assert_array_equal(out["mask"].numpy(), np.asarray(ref_m))
    with pytest.raises(ValueError, match="Scale is too small"):
        T.DevicePipeline([], [0, 1], 0.01, 40, 56, device="cpu")
