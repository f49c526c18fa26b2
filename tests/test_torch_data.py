"""The port's dataset layer and loader against the JAX package's, on the
CPU: ``CarvanaDataset`` samples (image and mask arrays), ``mask_values``,
``BasicDataset``'s mask branch for grey and RGB palettes, ``load_image``'s
``.npy`` and ``.pt`` branches, ``random_split_indices`` and the
``DataLoader``'s batches in order over two shuffled epochs, on a
``make_synthetic_carvana`` set. Everything is compared bit for bit: both
packages resample with Pillow's arithmetic and shuffle with the same numpy
generator.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from tpu_unet.data import (
    BasicDataset as JBasic,
    CarvanaDataset as JCarvana,
    DataLoader as JLoader,
    random_split_indices as j_split,
)
from tpu_unet.data.loading import load_image as j_load_image, unique_mask_values as j_unique
from tpu_unet_torch.data import (
    BasicDataset,
    CarvanaDataset,
    DataLoader,
    collate,
    load_image,
    make_synthetic_carvana,
    prefetch_to_device,
    random_split_indices,
    unique_mask_values,
)


@pytest.fixture(scope="module")
def carvana(tmp_path_factory):
    root = tmp_path_factory.mktemp("carvana")
    return make_synthetic_carvana(root, n=7, h=30, w=41, seed=3)


@pytest.mark.parametrize("scale", [1.0, 0.5, 0.3])
def test_carvana_samples_equal_jax(carvana, scale):
    imgs, masks = carvana
    ours = CarvanaDataset(imgs, masks, scale)
    ref = JCarvana(imgs, masks, scale)
    assert ours.ids == ref.ids and ours.mask_values == ref.mask_values == [0, 255]
    for i in range(len(ref)):
        a, b = ours[i], ref[i]
        assert a["image"].dtype == b["image"].dtype == np.float32
        assert a["mask"].dtype == b["mask"].dtype == np.int64
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["mask"], b["mask"])


def _write_palette_set(root, rgb: bool):
    rng = np.random.default_rng(1)
    (root / "imgs").mkdir(parents=True)
    (root / "masks").mkdir()
    palette = ([(0, 0, 0), (255, 0, 0), (0, 128, 255)] if rgb else [0, 128, 255])
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (20, 26, 3), dtype=np.uint8)).save(
            root / "imgs" / f"x{i}.png")
        idx = rng.integers(0, 3, (20, 26))
        mask = np.asarray(palette, dtype=np.uint8)[idx]
        Image.fromarray(mask).save(root / "masks" / f"x{i}.png")
    return root / "imgs", root / "masks"


@pytest.mark.parametrize("rgb", [False, True])
def test_basic_dataset_mask_palette_equal_jax(tmp_path, rgb):
    imgs, masks = _write_palette_set(tmp_path, rgb)
    ours = BasicDataset(imgs, masks, 0.5, num_workers=2)
    ref = JBasic(imgs, masks, 0.5)
    assert ours.mask_values == ref.mask_values
    assert len(ours.mask_values) == 3
    for i in range(len(ref)):
        np.testing.assert_array_equal(ours[i]["mask"], ref[i]["mask"])
        np.testing.assert_array_equal(ours[i]["image"], ref[i]["image"])
    assert set(np.unique(ours[0]["mask"]).tolist()) <= {0, 1, 2}
    np.testing.assert_array_equal(unique_mask_values(ours.ids[0], masks, ""),
                                  j_unique(ours.ids[0], masks, ""))


def test_load_image_branches_equal_jax(tmp_path):
    arr = np.random.default_rng(2).integers(0, 256, (5, 7), dtype=np.uint8)
    np.save(tmp_path / "a.npy", arr)
    torch.save(torch.from_numpy(arr), tmp_path / "a.pt")
    Image.fromarray(arr).save(tmp_path / "a.png")
    for name in ("a.npy", "a.pt", "a.png"):
        got = np.asarray(load_image(tmp_path / name))
        np.testing.assert_array_equal(got, np.asarray(j_load_image(tmp_path / name)))
        np.testing.assert_array_equal(got, arr)


def test_dataset_errors_and_cache(tmp_path, carvana):
    (tmp_path / "empty").mkdir()
    with pytest.raises(RuntimeError, match="No input file"):
        BasicDataset(tmp_path / "empty", tmp_path / "empty")
    with pytest.raises(ValueError, match="Scale"):
        CarvanaDataset(*carvana, scale=1.5)
    with pytest.raises(IndexError):  # masks without the _mask suffix
        BasicDataset(carvana[0], carvana[0], 1.0, mask_suffix="_nope")
    ds = CarvanaDataset(*carvana, 0.5, cache=True)
    assert ds[2] is ds[2]
    assert CarvanaDataset(*carvana, 0.5)[2] is not CarvanaDataset(*carvana, 0.5)[2]


@pytest.mark.parametrize("n,frac,seed", [(10, 0.2, 0), (7, 0.1, 0), (25, 0.3, 5)])
def test_random_split_equal_jax(n, frac, seed):
    tr, va = random_split_indices(n, frac, seed=seed)
    assert (tr, va) == j_split(n, frac, seed=seed)
    assert sorted(tr + va) == list(range(n)) and len(va) == int(n * frac)


@pytest.mark.parametrize("shuffle,drop_last,workers", [(True, False, 4), (True, True, 1),
                                                        (False, False, 2)])
def test_loader_batches_equal_jax(carvana, shuffle, drop_last, workers):
    ds, jds = CarvanaDataset(*carvana, 0.5), JCarvana(*carvana, 0.5)
    idx, _ = random_split_indices(len(ds), 0.2, seed=0)
    ours = DataLoader(ds, 2, shuffle=shuffle, drop_last=drop_last, num_workers=workers, seed=4,
                      indices=idx)
    ref = JLoader(jds, 2, shuffle=shuffle, drop_last=drop_last, num_workers=workers, seed=4,
                  indices=idx)
    assert len(ours) == len(ref)
    for _ in range(2):  # two epochs: the shuffle is default_rng(seed + epoch)
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == len(ours)
        for a, b in zip(got, want):
            for k in ("image", "mask"):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
    assert got[0]["mask"].dtype == np.int32 and got[0]["image"].dtype == np.float32


def test_collate_keeps_uint8_and_prefetch_on_cpu():
    samples = [{"image": np.full((2, 3, 3), i, np.uint8), "mask": np.full((2, 3), i, np.int64)}
               for i in range(3)]
    batch = collate(samples)
    assert batch["image"].dtype == np.uint8 and batch["mask"].dtype == np.int32
    out = list(prefetch_to_device([batch, batch, batch], buffer_size=2, device="cpu"))
    assert len(out) == 3
    assert torch.equal(out[2]["mask"], torch.from_numpy(batch["mask"]))
    assert list(prefetch_to_device([], device="cpu")) == []
