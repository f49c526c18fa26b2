"""The port's datasets and device-side batches against the host loader and
the JAX package, on the CPU, bitwise: ``RawDataset`` samples equal JAX's;
``DevicePipeline`` over a ``RawDataset`` gives the host ``DataLoader``'s
batches (Carvana's JPEG images and GIF masks, scale 0.5); the
device-resident corpus (``DeviceResidentData``) gives the host loader's
batches in its shuffled order over two epochs and JAX's, and can be
iterated again; its float32 fallback, its class limit and its refusal of a
sharded corpus; ``train_model``'s feeds and its mutual exclusion.
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from tpu_unet.data import CarvanaDataset as JCarvana
from tpu_unet.data.device_cache import DeviceResidentData as JResident
from tpu_unet.data.loading import RawCarvanaDataset as JRaw
from tpu_unet_torch.data import (
    BasicDataset,
    CarvanaDataset,
    DataLoader,
    RawCarvanaDataset,
    RawDataset,
    make_synthetic_carvana,
)
from tpu_unet_torch.data.device_cache import DeviceResidentData
from tpu_unet_torch.data.device_pipeline import DevicePipeline
from tpu_unet_torch.train import _build_loaders


@pytest.fixture(scope="module")
def carvana(tmp_path_factory):
    """10 Carvana-format pairs: JPEG images, GIF palette masks (indices 0, 1)."""
    root = tmp_path_factory.mktemp("carvana")
    png = root / "png"
    make_synthetic_carvana(png, n=10, h=40, w=58, seed=2)
    (root / "imgs").mkdir()
    (root / "masks").mkdir()
    for p in sorted((png / "imgs").iterdir()):
        Image.open(p).save(root / "imgs" / (p.stem + ".jpg"), quality=90)
    for p in sorted((png / "masks").iterdir()):
        Image.open(p).convert("P").save(root / "masks" / (p.stem + ".gif"))
    return root


def test_raw_dataset_equals_jax(carvana):
    ds = RawCarvanaDataset(carvana / "imgs", carvana / "masks", 0.5, num_workers=0)
    jds = JRaw(carvana / "imgs", carvana / "masks", 0.5, num_workers=0)
    assert (ds.raw_h, ds.raw_w) == (jds.raw_h, jds.raw_w) == (40, 58)
    assert ds.mask_values == jds.mask_values == [0, 1]  # GIF palette indices
    assert ds.ids == jds.ids
    for i in range(len(ds)):
        s, j = ds[i], jds[i]
        assert s["image"].dtype == np.uint8 and s["image"].shape == (40, 58, 3)
        for k in ("image", "mask"):
            np.testing.assert_array_equal(s[k], j[k])


def test_raw_dataset_requires_one_size(tmp_path):
    make_synthetic_carvana(tmp_path, n=3, h=24, w=32, seed=1)
    img = sorted((tmp_path / "imgs").iterdir())[-1]
    Image.open(img).resize((30, 24)).save(img)
    ds = RawCarvanaDataset(tmp_path / "imgs", tmp_path / "masks", 1.0, num_workers=0)
    with pytest.raises(ValueError, match="uniform image sizes"):
        ds[2]


@pytest.mark.parametrize("batch_size", [1, 4])
def test_device_pipeline_batches_equal_host_loader(carvana, batch_size):
    """The raw loader's batches, resized on the device, are the host
    loader's, shuffle order and all, over two epochs."""
    raw = RawCarvanaDataset(carvana / "imgs", carvana / "masks", 0.5)
    host = CarvanaDataset(carvana / "imgs", carvana / "masks", 0.5)
    idx = list(range(2, 10))
    pipe = DevicePipeline(DataLoader(raw, batch_size, shuffle=True, indices=idx, seed=3),
                          raw.mask_values, 0.5, raw.raw_h, raw.raw_w, device="cpu")
    ref = DataLoader(host, batch_size, shuffle=True, indices=idx, seed=3)
    assert len(pipe) == len(ref)
    for _ in range(2):
        for got, want in zip(pipe, ref, strict=True):
            assert got["image"].dtype == torch.float32 and got["mask"].dtype == torch.int32
            assert want["mask"].dtype == np.int32
            np.testing.assert_array_equal(got["image"].numpy().view(np.uint32),
                                          want["image"].view(np.uint32))
            np.testing.assert_array_equal(got["mask"].numpy(), want["mask"])


@pytest.fixture(scope="module")
def host_ds(tmp_path_factory):
    root = tmp_path_factory.mktemp("ddata")
    make_synthetic_carvana(root, n=10, h=24, w=32)
    return (CarvanaDataset(root / "imgs", root / "masks", scale=1.0),
            JCarvana(root / "imgs", root / "masks", scale=1.0))


def test_resident_batches_equal_host_loader_and_jax(host_ds):
    ds, jds = host_ds
    idx = list(range(len(ds)))
    dd = DeviceResidentData(ds, device="cpu")
    jdd = JResident(jds)
    assert dd.exact and dd.staged_bytes == 10 * 24 * 32 * 4
    host = DataLoader(ds, 4, shuffle=True, indices=idx, seed=3)
    dev = dd.batches(idx, 4, shuffle=True, seed=3)
    jdev = jdd.batches(idx, 4, shuffle=True, seed=3)
    for _ in range(2):  # two epochs, two orders
        for hb, db, jb in zip(host, dev, jdev, strict=True):
            assert db["image"].dtype == torch.float32 and db["mask"].dtype == torch.int32
            for k in ("image", "mask"):
                np.testing.assert_array_equal(db[k].numpy(), hb[k])
                np.testing.assert_array_equal(db[k].numpy(), np.asarray(jb[k]))


def test_resident_val_batches_iterate_again(host_ds):
    dd = DeviceResidentData(host_ds[0], device="cpu")
    val = dd.batches([0, 1, 2], 2)
    assert len(val) == 2 and len(dd.batches([0, 1, 2], 2, drop_last=True)) == 1
    first = [b["image"].clone() for b in val]
    second = [b["image"] for b in val]
    assert len(first) == 2
    for x, y in zip(first, second, strict=True):
        assert torch.equal(x, y)


class _Samples:
    def __init__(self, images, masks):
        self.images, self.masks = images, masks

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return {"image": self.images[i], "mask": self.masks[i]}


def test_resident_float_fallback_and_class_limit():
    rng = np.random.default_rng(0)
    imgs = rng.random((3, 8, 8, 3), dtype=np.float32)  # not k / 255: staged as float32
    masks = rng.integers(0, 3, (3, 8, 8))
    dd = DeviceResidentData(_Samples(imgs, masks), device="cpu", num_workers=2)
    assert not dd.exact and dd._images.dtype == torch.float32
    b = dd.gather([2, 0])
    np.testing.assert_array_equal(b["image"].numpy(), imgs[[2, 0]])
    np.testing.assert_array_equal(b["mask"].numpy(), masks[[2, 0]])
    with pytest.raises(ValueError, match="<256 classes"):
        DeviceResidentData(_Samples(imgs, masks + 254), device="cpu")
    # Data parallelism: each rank gathers its contiguous rows of each batch.
    rows = [b["mask"].numpy() for b in dd.batches([0, 1, 2], 2, drop_last=True, shard=(1, 2))]
    assert len(rows) == 1 and np.array_equal(rows[0], masks[[1]])
    with pytest.raises(ValueError, match="does not divide over 2"):
        list(dd.batches([0, 1, 2], 3, shard=(0, 2)))


def test_build_loaders_feeds_and_exclusion(carvana):
    raw = RawCarvanaDataset(carvana / "imgs", carvana / "masks", 0.5)
    host = CarvanaDataset(carvana / "imgs", carvana / "masks", 0.5)
    kw = dict(batch_size=2, seed=0, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="mutually exclusive with --device-preprocess"):
        _build_loaders(raw, [0, 1], [2], device_dataset=True, device_preprocess=True, **kw)
    train, val = _build_loaders(raw, [0, 1, 2], [3], device_dataset=False,
                                device_preprocess=True, **kw)
    assert isinstance(train, DevicePipeline) and isinstance(val, DevicePipeline)
    assert isinstance(train.loader, DataLoader) and train.loader.shuffle
    train, val = _build_loaders(host, [0, 1, 2], [3], device_dataset=True,
                                device_preprocess=False, **kw)
    assert train.shuffle and not val.shuffle and train.parent is val.parent
    ((b,),) = [list(val)]
    np.testing.assert_array_equal(b["image"].numpy(), host[3]["image"][None])
    # A RawDataset is a BasicDataset: its palette scan is the host dataset's.
    assert isinstance(raw, RawDataset) and isinstance(raw, BasicDataset)
    assert raw.mask_values == host.mask_values
    assert jax.device_count() >= 1  # JAX stays on the CPU beside the port
