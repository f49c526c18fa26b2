"""The port's native host tier (``tpu_unet_torch.native``) against the JAX
package's (``tpu_unet.native``) and the installed Pillow: resize for every
filter and channel count of the self-check, PNG, JPEG and GIF decode, the
lazy-file decode of ``asarray_fast``, all bitwise; the thread count, the
kill switch, the self-check's PIL fallback, and the library's own name and
git-ignored build directory. Then the port's loader through the tier: equal
to its PIL route and to the JAX package's loader.
"""

import io
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from tpu_unet import native as jnative
from tpu_unet.data.loading import BasicDataset as JBasic
from tpu_unet_torch import native
from tpu_unet_torch.data import loading
from tpu_unet_torch.data.loading import BasicDataset, preprocess, preprocess_mask

ROOT = Path(__file__).resolve().parent.parent
PIL_FILTERS = [(Image.NEAREST, native.NEAREST), (Image.BILINEAR, native.BILINEAR),
               (Image.BICUBIC, native.BICUBIC)]


def test_builds_into_its_own_ignored_directory():
    assert native.available()
    so = native.build()
    assert so.parent == ROOT / "tpu_unet_torch" / "_build"
    assert so.name.startswith("libtuk_native-") and so.suffix == ".so"
    assert "tpu_unet_torch/_build/" in (ROOT / ".gitignore").read_text().splitlines()
    assert so.name != jnative.build().name  # the two packages' builds never collide
    for name in ("decode.cc", "gif.cc", "jpeg.cc", "preproc.cc"):
        assert ((ROOT / "tpu_unet_torch" / "native" / name).read_bytes()
                == (ROOT / "tpu_unet" / "native" / name).read_bytes())


@pytest.mark.parametrize("pil_f,nat_f", PIL_FILTERS)
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("new_w,new_h", [(21, 17), (96, 64), (53, 37), (1, 1)])
def test_resize_equals_jax_and_pillow(pil_f, nat_f, c, new_w, new_h):
    rng = np.random.default_rng(c * 100 + new_w)
    src = rng.integers(0, 256, size=(37, 53) if c == 1 else (37, 53, c), dtype=np.uint8)
    want = np.asarray(Image.fromarray(src).resize((new_w, new_h), resample=pil_f))
    got = native.resize_u8(src, new_h, new_w, nat_f)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jnative.resize_u8(src, new_h, new_w, nat_f))


def test_threads_do_not_change_results_and_fused_scale():
    rng = np.random.default_rng(7)
    src = rng.integers(0, 256, size=(161, 229, 3), dtype=np.uint8)
    one = native.resize_u8(src, 100, 150, native.BICUBIC, n_threads=1)
    np.testing.assert_array_equal(native.resize_u8(src, 100, 150, native.BICUBIC, n_threads=8),
                                  one)
    fused = native.resize_scale_f32(src, 100, 150, native.BICUBIC, 1 / 255.0, n_threads=4)
    assert fused.dtype == np.float32
    np.testing.assert_array_equal(fused, one.astype(np.float32) * np.float32(1 / 255.0))
    np.testing.assert_array_equal(
        fused, jnative.resize_scale_f32(src, 100, 150, jnative.BICUBIC, 1 / 255.0))
    with pytest.raises(TypeError):
        native.resize_u8(src.astype(np.float32), 10, 10, native.BICUBIC)


def _encoded(img: Image.Image, **kw) -> bytes:
    bio = io.BytesIO()
    img.save(bio, **kw)
    return bio.getvalue()


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


@pytest.mark.parametrize("mode,shape", [("L", (23, 31)), ("RGB", (23, 31, 3)),
                                        ("RGBA", (23, 31, 4)), ("LA", (23, 31, 2)),
                                        ("P", (19, 27))])
def test_decode_png_equals_jax_and_pillow(mode, shape):
    rng = np.random.default_rng(sum(shape))
    if mode == "P":
        img = Image.fromarray(rng.integers(0, 5, size=shape, dtype=np.uint8)).convert("P")
    else:
        img = Image.fromarray(rng.integers(0, 256, size=shape, dtype=np.uint8), mode=mode)
    data = _encoded(img, format="PNG")
    got = native.decode_png(data)
    np.testing.assert_array_equal(got, _pil(data))
    np.testing.assert_array_equal(got, jnative.decode_png(data))


@pytest.mark.parametrize("mode", ["L", "RGB"])
@pytest.mark.parametrize("quality", [75, 95])
@pytest.mark.parametrize("subsampling", [0, 2])
@pytest.mark.parametrize("progressive", [False, True])
def test_decode_jpeg_equals_jax_and_pillow(mode, quality, subsampling, progressive):
    assert native._load().tu_has_jpeg  # libjpeg is present here
    rng = np.random.default_rng(quality + subsampling)
    base = rng.integers(0, 256, size=(9, 11) if mode == "L" else (9, 11, 3), dtype=np.uint8)
    img = Image.fromarray(base, mode=mode).resize((88, 72), Image.BICUBIC)
    data = _encoded(img, format="JPEG", quality=quality, subsampling=subsampling,
                    progressive=progressive)
    got = native.decode_jpeg(data)
    np.testing.assert_array_equal(got, _pil(data))
    np.testing.assert_array_equal(got, jnative.decode_jpeg(data))


@pytest.mark.parametrize("hi", [2, 5, 256])
def test_decode_gif_equals_jax_and_pillow(hi):
    rng = np.random.default_rng(hi)
    data = _encoded(Image.fromarray(rng.integers(0, hi, size=(23, 31), dtype=np.uint8),
                                    mode="P"), format="GIF")
    got = native.decode_gif(data)
    np.testing.assert_array_equal(got, _pil(data))
    np.testing.assert_array_equal(got, jnative.decode_gif(data))


def test_decoders_decline_what_they_cannot_read():
    for fn in (native.decode_png, native.decode_jpeg, native.decode_gif):
        assert fn(b"not an image at all") is None
    png = _encoded(Image.fromarray(np.zeros((8, 8), np.uint16)), format="PNG")  # 16-bit
    assert native.decode_png(png) is None and jnative.decode_png(png) is None


def test_asarray_fast_files_equal_jax_and_pillow(tmp_path):
    rng = np.random.default_rng(8)
    rgb = rng.integers(0, 256, size=(50, 70, 3), dtype=np.uint8)
    Image.fromarray(rgb).save(tmp_path / "a.png")
    Image.fromarray(rgb).resize((70, 50), Image.BICUBIC).save(tmp_path / "a.jpg", quality=90)
    Image.fromarray(rng.integers(0, 2, size=(50, 70), dtype=np.uint8) * 255, mode="L"
                    ).convert("P").save(tmp_path / "a.gif")
    for name in ("a.png", "a.jpg", "a.gif"):
        want = np.asarray(Image.open(tmp_path / name))
        assert native._maybe_decode_file(Image.open(tmp_path / name)) is not None
        np.testing.assert_array_equal(native.asarray_fast(Image.open(tmp_path / name)), want)
        np.testing.assert_array_equal(jnative.asarray_fast(Image.open(tmp_path / name)), want)
        loaded = Image.open(tmp_path / name)
        loaded.load()  # already decoded: the PIL route, not a second decode
        assert native._maybe_decode_file(loaded) is None
        np.testing.assert_array_equal(native.asarray_fast(loaded), want)
    np.testing.assert_array_equal(native.asarray_fast(Image.fromarray(rgb)), rgb)


def test_pil_resize_native_palette_and_declines():
    rng = np.random.default_rng(3)
    pil = Image.fromarray(rng.integers(0, 4, size=(60, 80), dtype=np.uint8)).convert("P")
    np.testing.assert_array_equal(native.pil_resize_native(pil, 37, 23, Image.NEAREST),
                                  np.asarray(pil.resize((37, 23), resample=Image.NEAREST)))
    assert native.pil_resize_native(pil, 4, 4, Image.BICUBIC) is None
    assert native.pil_resize_native(Image.fromarray(np.zeros((8, 8), np.int32), mode="I"),
                                    4, 4, Image.NEAREST) is None
    assert native.pil_resize_native(pil, 4, 4, Image.LANCZOS) is None


def _set_state(monkeypatch, state):
    monkeypatch.setattr(native, "_state", state)
    monkeypatch.setattr(native, "_lib", None)


def test_kill_switch_and_failed_self_check_fall_back_to_pil(monkeypatch):
    rng = np.random.default_rng(11)
    img = Image.fromarray(rng.integers(0, 256, size=(100, 144, 3), dtype=np.uint8))
    mask = Image.fromarray((rng.integers(0, 2, size=(100, 144)) * 255).astype(np.uint8))
    on = preprocess(img, 0.61), preprocess_mask([0, 255], mask, 0.61)
    assert native.pil_resize_native(img, 87, 61, Image.BICUBIC) is not None
    _set_state(monkeypatch, "unknown")
    monkeypatch.setenv("TPU_UNET_NATIVE", "0")
    assert not native.available() and native._state == "disabled"
    assert native.pil_resize_native(img, 87, 61, Image.BICUBIC) is None
    off = preprocess(img, 0.61), preprocess_mask([0, 255], mask, 0.61)
    monkeypatch.delenv("TPU_UNET_NATIVE")
    native.set_enabled(True)  # a disabled tier loads again at its next use
    assert native._state == "unknown" and native.available()
    native.set_enabled(False)
    assert not native.available()
    _set_state(monkeypatch, "unknown")
    monkeypatch.setattr(native, "_self_check", lambda lib: False)
    assert not native.available() and native._state == "failed"
    failed = preprocess(img, 0.61), preprocess_mask([0, 255], mask, 0.61)
    for a, b, c in zip(on, off, failed):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert on[0].dtype == np.float32 and on[1].dtype == np.int64


def test_loader_through_the_tier_equals_jax_and_pil(tmp_path, monkeypatch):
    """The port's dataset samples (native decode and resize) equal its PIL
    route and the JAX package's, on PNG images and GIF masks."""
    rng = np.random.default_rng(13)
    (tmp_path / "imgs").mkdir()
    (tmp_path / "masks").mkdir()
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, size=(48, 64, 3), dtype=np.uint8)).save(
            tmp_path / "imgs" / f"s_{i}.png")
        Image.fromarray((rng.integers(0, 2, size=(48, 64)) * 255).astype(np.uint8)).convert(
            "P").save(tmp_path / "masks" / f"s_{i}.gif")
    args = (tmp_path / "imgs", tmp_path / "masks", 0.7)
    ds = BasicDataset(*args, num_workers=0)
    jds = JBasic(str(args[0]), str(args[1]), 0.7, num_workers=0)
    assert ds.mask_values == jds.mask_values
    calls = []
    real = native.pil_resize_native
    monkeypatch.setattr(loading.native, "pil_resize_native",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = [ds[i] for i in range(3)]
    assert len(calls) == 6  # image and mask of each sample
    monkeypatch.setattr(native, "_state", "disabled")
    for i, s in enumerate(got):
        pil = ds[i]
        j = jds[i]
        for k in ("image", "mask"):
            np.testing.assert_array_equal(s[k], pil[k])
            np.testing.assert_array_equal(s[k], j[k])
