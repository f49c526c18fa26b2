"""The port's Carvana RLE submission (``submit.py``) against the JAX
package's, fp32 on the CPU: the RLE strings, the whole CSV byte for byte on
5 images of two sizes in batches of 2 (the trailing groups zero-padded),
with and without TTA, and each row decoding to ``predict_img``'s mask. The
checkpoint is JAX's (base 8, one class), its BN state holding a random
batch's statistics."""

from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from tpu_unet.checkpoint import save_checkpoint as j_save
from tpu_unet.models import UNetConfig as JConfig
from tpu_unet.models import init_unet as j_init
from tpu_unet.models import unet_apply as j_apply
from tpu_unet.submit import rle_decode as j_rle_decode
from tpu_unet.submit import rle_encode as j_rle_encode
from tpu_unet.submit import submit as j_submit
from tpu_unet_torch.checkpoint import load_checkpoint
from tpu_unet_torch.models import UNetConfig
from tpu_unet_torch.predict import predict_img
from tpu_unet_torch.submit import main, rle_decode, rle_encode, submit

JCFG = JConfig(3, 1, bilinear=False, base_channels=8)
SIZES = [(40, 48)] * 3 + [(36, 52)] * 2  # (H, W): groups of 3 and 2 at batch 2


def _ckpt(path: Path, cfg: JConfig) -> Path:
    params, state = j_init(jax.random.PRNGKey(1), cfg)
    x = jnp.asarray(np.random.default_rng(0).random((2, 32, 40, 3), dtype=np.float32))
    _, stepped = j_apply(params, state, x, config=cfg, train=True)
    state = jax.tree.map(lambda new, old: (new - 0.9 * old) / 0.1, stepped, state)
    j_save(path, params, state, mask_values=[0, 1], extra={"config": cfg._asdict()})
    return path


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("submit")
    imgs = d / "imgs"
    imgs.mkdir()
    rng = np.random.default_rng(8)
    # Names out of size order, so the CSV's file order differs from the
    # groups' flush order; a hidden file is skipped.
    for k, (h, w) in enumerate(SIZES):
        img = Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8))
        img.save(imgs / f"car_{(k * 3) % 5}.png")
    (imgs / ".hidden").write_text("not an image")
    return _ckpt(d / "unet8.npz", JCFG), imgs


def test_rle_matches_jax():
    rng = np.random.default_rng(0)
    masks = [rng.random((h, w)) > p for h, w, p in ((7, 9, 0.5), (16, 12, 0.9), (5, 3, 0.1))]
    masks += [np.zeros((4, 6), bool), np.ones((4, 6), bool), np.eye(5, dtype=bool)]
    for mask in masks:
        rle = rle_encode(mask)
        assert rle == j_rle_encode(mask)
        np.testing.assert_array_equal(rle_decode(rle, mask.shape), mask.astype(np.uint8))
        np.testing.assert_array_equal(rle_decode(rle, mask.shape), j_rle_decode(rle, mask.shape))
    assert rle_encode(np.array([[1, 0], [1, 1]])) == "1 2 4 1"  # column-major, 1-indexed


@pytest.mark.parametrize("tta", [False, True])
def test_submit_csv_equals_jax(data, tta, tmp_path):
    ckpt, imgs = data
    j_csv, t_csv = tmp_path / "jax.csv", tmp_path / "port.csv"
    j_submit(ckpt, imgs, j_csv, scale=1.0, tta=tta, batch_size=2)
    submit(ckpt, imgs, t_csv, scale=1.0, tta=tta, batch_size=2, device="cpu")
    assert t_csv.read_bytes() == j_csv.read_bytes()
    rows = t_csv.read_text().splitlines()
    assert rows[0] == "img,rle_mask" and len(rows) == 1 + len(SIZES)
    names = sorted(p.name for p in imgs.iterdir() if not p.name.startswith("."))
    assert [r.split(",")[0] for r in rows[1:]] == names
    params, state, _, _ = load_checkpoint(ckpt, UNetConfig(*JCFG))
    fg = []
    for row in rows[1:]:
        name, rle = row.split(",")
        img = Image.open(imgs / name)
        mask = rle_decode(rle, (img.height, img.width))
        want = predict_img(params, state, UNetConfig(*JCFG), img, scale_factor=1.0, tta=tta,
                           device="cpu")
        np.testing.assert_array_equal(mask, want.astype(np.uint8))
        fg.append(mask.mean())
    assert 0 < np.mean(fg) < 1  # masks with both classes


def test_submit_cli_and_refusals(data, tmp_path):
    ckpt, imgs = data
    out = tmp_path / "cli.csv"
    main(["-m", str(ckpt), "-i", str(imgs), "-o", str(out), "-s", "1.0", "-b", "2",
          "--device", "cpu"])
    ref = tmp_path / "lib.csv"
    submit(ckpt, imgs, ref, scale=1.0, batch_size=2, device="cpu")
    assert out.read_bytes() == ref.read_bytes()
    two = _ckpt(tmp_path / "two.npz", JConfig(3, 2, bilinear=True, base_channels=8))
    for run in (j_submit, submit):
        kw = {} if run is j_submit else {"device": "cpu"}
        with pytest.raises(ValueError, match="binary; checkpoint has 2 classes"):
            run(two, imgs, tmp_path / "x.csv", **kw)
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            submit(ckpt, imgs, tmp_path / "y.csv")
