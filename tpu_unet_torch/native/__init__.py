"""The native host tier (``tpu_unet/native``): C++ decode and resize, bound
with ctypes.

``preproc.cc`` is Pillow's fixed-point convolution resampling (NEAREST,
BILINEAR, BICUBIC on uint8 HW/HWC arrays), bit-exact, threaded across rows,
with a fused resize -> float32 scale; ``decode.cc`` decodes 8-bit PNGs
(zlib inflate and unfilter), ``jpeg.cc`` JPEGs (the system libjpeg) and
``gif.cc`` the first frame of a GIF as its palette index band (LZW). Those
are the formats of the Carvana data: JPEG images, GIF masks. The four
sources are the JAX package's, byte for byte; this package keeps its own
copy and its own library, so the two builds never meet.

Policy, the JAX package's:
  * The library is built at first use with ``g++`` (-O3) into
    ``tpu_unet_torch/_build/libtuk_native-<source hash>.so`` (git-ignored),
    written to a temporary name and renamed, so concurrent builds (test
    workers) never load a half-written file. A host without libjpeg builds
    the library without ``jpeg.cc``: JPEG files then decode through PIL.
  * Before first use, a self-check holds resize and decode bit for bit
    against the installed Pillow for every filter and channel count the
    loader uses; on a mismatch the tier turns itself off with a warning and
    every caller takes the PIL route, which gives the same arrays.
  * ``TPU_UNET_NATIVE=0`` (or ``set_enabled(False)``) turns it off;
    ``TPU_UNET_NATIVE_THREADS`` sets the default row threads of a resize.

ctypes releases the interpreter lock for each call, so the loader's threads
decode and resize images in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import io
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

_SRC_DIR = Path(__file__).resolve().parent
_BUILD_DIR = _SRC_DIR.parent / "_build"
_LIB_PREFIX = "libtuk_native-"

# Pillow filter ids -> native filter ids (preproc.cc FilterId).
NEAREST, BILINEAR, BICUBIC = 0, 1, 2
_PIL_TO_NATIVE = {0: NEAREST, 2: BILINEAR, 3: BICUBIC}  # PIL.Image constants

_U8P = ctypes.POINTER(ctypes.c_uint8)

_lock = threading.Lock()
_lib = None  # the ctypes.CDLL once loaded and checked
_state = "unknown"  # unknown | ok | disabled | failed


def _sources() -> list[Path]:
    return sorted(_SRC_DIR.glob("*.cc"))


def _source_hash() -> str:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _so_path() -> Path:
    return _BUILD_DIR / f"{_LIB_PREFIX}{_source_hash()}.so"


def _compile(sources: list[Path], out: Path, libs: list[str]) -> None:
    subprocess.run(["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
                    *map(str, sources), "-o", str(out), *libs],
                   check=True, capture_output=True, text=True, timeout=120)


def build(force: bool = False) -> Path:
    """Compile the sources into the cached shared library; return its path."""
    so = _so_path()
    if so.exists() and not force:
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".tmp{os.getpid()}.so")
    try:
        _compile(_sources(), tmp, ["-lz", "-ljpeg"])
    except subprocess.CalledProcessError as e:
        # libjpeg is the one dependency beyond zlib: without it, PNG, GIF and
        # resize stay native and JPEG declines at bind time.
        try:
            _compile([s for s in _sources() if s.name != "jpeg.cc"], tmp, ["-lz"])
        except (subprocess.CalledProcessError, subprocess.TimeoutExpired,
                FileNotFoundError) as e2:
            detail = getattr(e2, "stderr", "") or str(e2)
            raise RuntimeError(f"native preproc build failed: {detail}") from e2
        logger.warning("native jpeg decode unavailable (%s); JPEG files use PIL",
                       (e.stderr or "")[-200:])
    except (subprocess.TimeoutExpired, FileNotFoundError) as e:
        detail = getattr(e, "stderr", "") or str(e)
        raise RuntimeError(f"native preproc build failed: {detail}") from e
    tmp.replace(so)  # atomic against concurrent builds
    for old in _BUILD_DIR.glob(f"{_LIB_PREFIX}*.so"):
        if old != so and ".tmp" not in old.name:
            old.unlink(missing_ok=True)
    logger.info("built native preproc: %s", so.name)
    return so


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare every export's argtypes and restype; ``lib.tu_has_jpeg`` says
    whether the JPEG decoder was linked."""
    f32p = ctypes.POINTER(ctypes.c_float)
    intp = ctypes.POINTER(ctypes.c_int)
    i, i64 = ctypes.c_int, ctypes.c_int64
    signatures = {
        "tu_resize_u8": [_U8P, i, i, i, _U8P, i, i, i, i],
        "tu_resize_scale_f32": [_U8P, i, i, i, f32p, i, i, i, ctypes.c_float, i],
        "tu_u8_to_f32": [_U8P, i64, f32p, ctypes.c_float, i],
        "tu_png_probe": [_U8P, i64, intp, intp, intp, intp],
        "tu_png_decode": [_U8P, i64, _U8P],
        "tu_gif_probe": [_U8P, i64, intp, intp],
        "tu_gif_decode": [_U8P, i64, _U8P],
    }
    jpeg = {"tu_jpeg_probe": [_U8P, i64, intp, intp, intp],
            "tu_jpeg_decode": [_U8P, i64, _U8P]}
    lib.tu_has_jpeg = hasattr(lib, "tu_jpeg_probe")  # absent in the no-libjpeg build
    if lib.tu_has_jpeg:
        signatures.update(jpeg)
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _load() -> ctypes.CDLL | None:
    """The checked library, or None when the tier is off or failed."""
    global _lib, _state
    with _lock:
        if _state == "ok":
            return _lib
        if _state in ("disabled", "failed"):
            return None
        if os.environ.get("TPU_UNET_NATIVE", "1") in ("0", "false", "off"):
            _state = "disabled"
            logger.info("native preproc disabled via TPU_UNET_NATIVE")
            return None
        try:
            lib = _bind(ctypes.CDLL(str(build())))
        except (RuntimeError, OSError) as e:
            _state = "failed"
            logger.warning("native preproc unavailable (%s); using PIL", e)
            return None
        if not _self_check(lib):
            _state = "failed"
            logger.warning("native preproc failed the Pillow bit-parity self-check "
                           "(Pillow convention change?); using PIL")
            return None
        _lib, _state = lib, "ok"
        return _lib


def _u8(arr: np.ndarray):
    return arr.ctypes.data_as(_U8P)


def _as_hwc(arr: np.ndarray) -> tuple[np.ndarray, int, bool]:
    """(contiguous HWC array, channels, was 2-D)."""
    was_2d = arr.ndim == 2
    if was_2d:
        arr = arr[:, :, None]
    return np.ascontiguousarray(arr), arr.shape[2], was_2d


def _default_threads() -> int:
    """Row threads of a resize: ``TPU_UNET_NATIVE_THREADS``, else 1. The
    count never changes a result."""
    try:
        return max(1, int(os.environ.get("TPU_UNET_NATIVE_THREADS", "1")))
    except ValueError:
        return 1


def _resize(arr, new_h, new_w, n_threads, dtype, call):
    lib = _load()
    if lib is None:
        raise RuntimeError("native preproc not available")
    src, c, was_2d = _as_hwc(arr)
    if src.dtype != np.uint8:
        raise TypeError(f"native resize needs uint8, got {src.dtype}")
    h, w = src.shape[:2]
    dst = np.empty((new_h, new_w, c), dtype=dtype)
    rc = call(lib, src, h, w, c, dst,
              _default_threads() if n_threads is None else n_threads)
    if rc != 0:
        raise RuntimeError(f"native resize rc={rc}")
    return dst[:, :, 0] if was_2d else dst


def resize_u8(arr: np.ndarray, new_h: int, new_w: int, filter: int,
              n_threads: int | None = None) -> np.ndarray:
    """Resize a uint8 HW / HWC array, bit-exact with Pillow's ``resize``."""
    return _resize(arr, new_h, new_w, n_threads, np.uint8,
                   lambda lib, src, h, w, c, dst, t: lib.tu_resize_u8(
                       _u8(src), h, w, c, _u8(dst), new_h, new_w, filter, t))


def resize_scale_f32(arr: np.ndarray, new_h: int, new_w: int, filter: int,
                     scale: float, n_threads: int | None = None) -> np.ndarray:
    """Fused resize -> float32 * scale; equals
    ``resize_u8(...).astype(np.float32) * np.float32(scale)``."""
    f32p = ctypes.POINTER(ctypes.c_float)
    return _resize(arr, new_h, new_w, n_threads, np.float32,
                   lambda lib, src, h, w, c, dst, t: lib.tu_resize_scale_f32(
                       _u8(src), h, w, c, dst.ctypes.data_as(f32p), new_h, new_w, filter,
                       scale, t))


def _bytes(data: bytes) -> np.ndarray:
    """A read-only uint8 view of ``data`` (no copy: the C side reads it as
    ``const``); the caller keeps it alive across the call."""
    return np.frombuffer(data, dtype=np.uint8)


def _decode_png_raw(lib: ctypes.CDLL, data: bytes) -> np.ndarray | None:
    h, w, c, pal = (ctypes.c_int() for _ in range(4))
    src = _bytes(data)
    if lib.tu_png_probe(_u8(src), len(data), ctypes.byref(h), ctypes.byref(w),
                        ctypes.byref(c), ctypes.byref(pal)) != 0:
        return None
    dst = np.empty((h.value, w.value, c.value), dtype=np.uint8)
    if lib.tu_png_decode(_u8(src), len(data), _u8(dst)) != 0:
        return None
    return dst[:, :, 0] if c.value == 1 else dst


def _decode_jpeg_raw(lib: ctypes.CDLL, data: bytes) -> np.ndarray | None:
    h, w, c = (ctypes.c_int() for _ in range(3))
    src = _bytes(data)
    if lib.tu_jpeg_probe(_u8(src), len(data), ctypes.byref(h), ctypes.byref(w),
                         ctypes.byref(c)) != 0:
        return None
    dst = np.empty((h.value, w.value, c.value), dtype=np.uint8)
    if lib.tu_jpeg_decode(_u8(src), len(data), _u8(dst)) != 0:
        return None
    return dst[:, :, 0] if c.value == 1 else dst


def _decode_gif_raw(lib: ctypes.CDLL, data: bytes) -> np.ndarray | None:
    h, w = ctypes.c_int(), ctypes.c_int()
    src = _bytes(data)
    if lib.tu_gif_probe(_u8(src), len(data), ctypes.byref(h), ctypes.byref(w)) != 0:
        return None
    dst = np.empty((h.value, w.value), dtype=np.uint8)
    if lib.tu_gif_decode(_u8(src), len(data), _u8(dst)) != 0:
        return None
    return dst


def decode_png(data: bytes) -> np.ndarray | None:
    """Decode PNG bytes: HW (grey, or a palette's index band) or HWC uint8,
    exactly ``np.asarray(PIL.Image.open(...))``. None out of scope (16-bit,
    interlaced, 1-bit, not a PNG) or when the tier is off: use PIL."""
    lib = _load()
    return None if lib is None else _decode_png_raw(lib, data)


def decode_jpeg(data: bytes) -> np.ndarray | None:
    """Decode JPEG bytes: HW (grey) or HW3 uint8, bit-identical to Pillow's
    decoder (the self-check holds it so). Baseline and progressive grey and
    RGB; None otherwise, or without libjpeg."""
    lib = _load()
    if lib is None or not lib.tu_has_jpeg:
        return None
    return _decode_jpeg_raw(lib, data)


def decode_gif(data: bytes) -> np.ndarray | None:
    """Decode a GIF's first frame: its HW uint8 palette index band, exactly
    ``np.asarray(PIL.Image.open(...))`` for a one-frame 'P' GIF. A first
    frame smaller than the logical screen gives None (PIL composites it)."""
    lib = _load()
    return None if lib is None else _decode_gif_raw(lib, data)


_MODE_CHANNELS = {"L": 1, "P": 1, "LA": 2, "RGB": 3, "RGBA": 4}

# Decoders by the format PIL reports; JPEG also needs ``lib.tu_has_jpeg``.
_FORMAT_DECODERS = {"PNG": _decode_png_raw, "JPEG": _decode_jpeg_raw, "GIF": _decode_gif_raw}


def asarray_fast(pil_img) -> np.ndarray:
    """``np.asarray(pil_img)``, decoded natively where it can be: a lazy
    (not yet loaded) ``Image.open`` of a PNG, JPEG or GIF file whose decoded
    shape matches PIL's mode and size. Everything else, and any failure,
    goes through PIL. The array is the same either way."""
    arr = _maybe_decode_file(pil_img)
    return np.asarray(pil_img) if arr is None else arr


def _maybe_decode_file(pil_img) -> np.ndarray | None:
    try:
        filename = getattr(pil_img, "filename", "")
        decoder = _FORMAT_DECODERS.get(getattr(pil_img, "format", None))
        if not filename or decoder is None or pil_img.mode not in _MODE_CHANNELS:
            return None
        # An image PIL has already decoded is not decoded again. Pillow >= 11
        # keeps its core image in ``_im`` (``im`` asserts while lazy); older
        # Pillow has a plain ``im`` attribute.
        loaded = pil_img._im if hasattr(pil_img, "_im") else pil_img.__dict__.get("im")
        if loaded is not None:
            return None
        lib = _load()
        if lib is None or (decoder is _decode_jpeg_raw and not lib.tu_has_jpeg):
            return None
        arr = decoder(lib, Path(filename).read_bytes())
        if arr is None:
            return None
        channels = arr.shape[2] if arr.ndim == 3 else 1
        w, h = pil_img.size
        if arr.shape[:2] != (h, w) or channels != _MODE_CHANNELS[pil_img.mode]:
            return None  # the file changed underfoot, or probe and mode disagree
        return arr
    except (OSError, ValueError):
        return None


def _self_check(lib: ctypes.CDLL) -> bool:
    """Bit parity with the installed Pillow: resize for every filter, one and
    three channels, down, up and identity; then each decoder."""
    try:
        from PIL import Image
    except ImportError:
        return False
    rng = np.random.default_rng(0)
    for c in (1, 3):
        src = rng.integers(0, 256, size=(37, 53, c), dtype=np.uint8)
        pil = Image.fromarray(src[:, :, 0] if c == 1 else src)
        for pil_filter, native_filter in _PIL_TO_NATIVE.items():
            for new_w, new_h in ((21, 17), (96, 64), (53, 37)):
                want = np.asarray(pil.resize((new_w, new_h), resample=pil_filter))
                got = np.empty((new_h, new_w, c), dtype=np.uint8)
                if lib.tu_resize_u8(_u8(src), 37, 53, c, _u8(got), new_h, new_w,
                                    native_filter, 1) != 0:
                    return False
                if not np.array_equal(want.reshape(new_h, new_w, c), got):
                    return False
    return _self_check_png(lib) and _self_check_gif(lib) and _self_check_jpeg(lib)


def _encoded(img, **save_kw) -> bytes:
    bio = io.BytesIO()
    img.save(bio, **save_kw)
    return bio.getvalue()


def _same_as_pil(decoder, lib, data: bytes) -> bool:
    from PIL import Image

    got = decoder(lib, data)
    return got is not None and np.array_equal(np.asarray(Image.open(io.BytesIO(data))), got)


def _self_check_png(lib: ctypes.CDLL) -> bool:
    """PNG decode against Pillow in L, RGB, RGBA, LA and palette mode (the
    index band); a non-PNG must decline."""
    from PIL import Image

    rng = np.random.default_rng(1)
    for mode, shape in (("L", (23, 31)), ("RGB", (23, 31, 3)), ("RGBA", (23, 31, 4)),
                        ("LA", (23, 31, 2))):
        src = rng.integers(0, 256, size=shape, dtype=np.uint8)
        if not _same_as_pil(_decode_png_raw, lib,
                            _encoded(Image.fromarray(src, mode=mode), format="PNG")):
            return False
    idx = rng.integers(0, 5, size=(19, 27), dtype=np.uint8)
    if not _same_as_pil(_decode_png_raw, lib,
                        _encoded(Image.fromarray(idx).convert("P"), format="PNG")):
        return False
    return _decode_png_raw(lib, b"not a png at all") is None


def _self_check_jpeg(lib: ctypes.CDLL) -> bool:
    """JPEG decode against Pillow for grey and RGB, two qualities, 4:4:4 and
    4:2:0, baseline and progressive. JPEG decode is exact only by convention
    (islow IDCT, fancy upsampling in both libraries), so this check is the
    gate: any mismatch keeps JPEG on PIL."""
    if not lib.tu_has_jpeg:
        return True  # the no-libjpeg build already declines JPEG
    from PIL import Image

    rng = np.random.default_rng(2)
    for mode, shape in (("L", (9, 11)), ("RGB", (9, 11, 3))):
        # Upscaled noise: smooth, as photographs are.
        base = rng.integers(0, 256, size=shape, dtype=np.uint8)
        img = Image.fromarray(base, mode=mode).resize((88, 72), Image.BICUBIC)
        for quality in (75, 95):
            for subsampling in (0, 2):
                for progressive in (False, True):
                    data = _encoded(img, format="JPEG", quality=quality,
                                    subsampling=subsampling, progressive=progressive)
                    if not _same_as_pil(_decode_jpeg_raw, lib, data):
                        return False
    return _decode_jpeg_raw(lib, b"definitely not a jpeg") is None


def _self_check_gif(lib: ctypes.CDLL) -> bool:
    """GIF first-frame index band against Pillow: binary, small and full
    palettes; a corrupt GIF must decline."""
    from PIL import Image

    rng = np.random.default_rng(3)
    for hi in (2, 5, 256):
        idx = rng.integers(0, hi, size=(23, 31), dtype=np.uint8)
        if not _same_as_pil(_decode_gif_raw, lib,
                            _encoded(Image.fromarray(idx, mode="P"), format="GIF")):
            return False
    return _decode_gif_raw(lib, b"GIF89a but corrupt") is None


def available() -> bool:
    """True iff the library is built, loaded and has passed the self-check."""
    return _load() is not None


def set_enabled(enabled: bool) -> None:
    """Turn the tier off (``False``), or let a turned-off tier load again at
    its next use (``True``)."""
    global _state, _lib
    with _lock:
        if not enabled:
            _state, _lib = "disabled", None
        elif _state == "disabled":
            _state = "unknown"


def pil_resize_native(pil_img, new_w: int, new_h: int, pil_filter: int,
                      n_threads: int | None = None):
    """``np.asarray(pil_img.resize((new_w, new_h), resample=pil_filter))``
    through the native tier (decoding the file natively too, where it can);
    None where the tier cannot serve the image (a mode other than L, P, RGB
    or RGBA, a P image under a convolution filter, which PIL converts first,
    another filter, or the tier off): the caller then uses PIL."""
    native_filter = _PIL_TO_NATIVE.get(pil_filter)
    if native_filter is None or pil_img.mode not in ("L", "P", "RGB", "RGBA"):
        return None
    if pil_img.mode == "P" and native_filter != NEAREST:
        return None
    if not available():
        return None
    arr = _maybe_decode_file(pil_img)
    if arr is None:
        arr = np.asarray(pil_img)
    if arr.dtype != np.uint8:
        return None
    return resize_u8(arr, new_h, new_w, native_filter, n_threads=n_threads)
