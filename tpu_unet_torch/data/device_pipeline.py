"""Device-side preprocessing (``tpu_unet/data/device_pipeline.py``): the host
only decodes (uint8); resize, the /255 rule and the mask's palette indexing
run on the device, bit for bit as the host path gives them.

  * Images: Pillow's convolution resampling (BICUBIC) exactly, as the native
    tier's ``preproc.cc`` does it: per output pixel a window of taps from
    ``_pil_coeffs`` (float64 on the host, with C's truncations), weights in
    int32 fixed point at 2^22, a horizontal pass then a vertical pass with
    Pillow's clip8 between them, widened support (antialiasing) when
    shrinking. The passes run in int32: the fixed-point sums need about
    2^30, which fp32 cannot hold exactly. Integer sums do not depend on their
    order, so each pass is one gather of all taps, one product and one sum.
  * /255 iff the image's max > 1, per image, through a 256-entry fp32 table
    that numpy divides: on the card ``x / 255.0`` may run as a multiply by
    the reciprocal, one ulp off numpy's division.
  * Masks: NEAREST with Pillow's accumulated source coordinate (``xo +=
    scale`` per output pixel, not a product), Pillow's fill value 0 where
    that walk leaves the image, then exact matching against the palette.

The ops are plain torch (gathers and int32 arithmetic): the JAX package runs
them as XLA ops, not a Pallas kernel. On a CPU tensor they run on the CPU.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_unet_torch.data.prefetch import to_device

# Pillow's fixed-point precision for 8-bit channels (Resample.c).
_PRECISION_BITS = 32 - 8 - 2  # 22


def _bicubic_filter(x: np.ndarray) -> np.ndarray:
    # Keys cubic, a = -0.5 (Pillow's BICUBIC), float64.
    a = -0.5
    x = np.abs(x)
    return np.where(
        x < 1.0,
        ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
        np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * a, 0.0),
    )


def _bilinear_filter(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


_FILTERS = {"bicubic": (_bicubic_filter, 2.0), "bilinear": (_bilinear_filter, 1.0)}


@functools.lru_cache(maxsize=64)
def _pil_coeffs(in_size: int, out_size: int, filter: str = "bicubic"):
    """Pillow's precompute_coeffs + normalize_coeffs_8bpc, float64 on the
    host: (idx [out, ksize] int32 gather indices, clipped into the image;
    kk [out, ksize] int32 weights in fixed point at 2^22). Taps outside an
    output pixel's [xmin, xmin + xmax) window weigh exactly 0, so clipping
    their indices changes nothing. The C int truncations are kept."""
    f, support0 = _FILTERS[filter]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale

    idx = np.zeros((out_size, ksize), np.int64)
    kk = np.zeros((out_size, ksize), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = int(center - support + 0.5)  # C truncation toward zero, then clamp
        if xmin < 0:
            xmin = 0
        xmax = int(center + support + 0.5)
        if xmax > in_size:
            xmax = in_size
        xmax -= xmin
        taps = np.arange(xmax, dtype=np.float64)
        w = f((taps + xmin - center + 0.5) * ss)
        total = w.sum()
        if total != 0.0:
            w = w / total
        kk[xx, :xmax] = w
        idx[xx] = np.minimum(xmin + np.arange(ksize), in_size - 1)
    # int32 fixed point with Pillow's round half away from zero.
    v = kk * (1 << _PRECISION_BITS)
    kk_i32 = np.where(v < 0, v - 0.5, v + 0.5).astype(np.int32)
    return idx.astype(np.int32), kk_i32


def _clip8(acc: torch.Tensor) -> torch.Tensor:
    """Pillow's clip8: >= 2^30 -> 255, <= 0 -> 0, else acc >> 22. An
    arithmetic shift then a clamp to [0, 255] is the same map."""
    return (acc >> _PRECISION_BITS).clamp_(0, 255)


def _resample_axis_pil(x: torch.Tensor, out_size: int, axis: int,
                       filter: str = "bicubic") -> torch.Tensor:
    """One Pillow pass along ``axis`` of an integer tensor with values in
    0..255: uint8 out. An identity size skips the pass, as Pillow does (no
    quantisation happens)."""
    in_size = x.shape[axis]
    if out_size == in_size:
        return x
    idx, kk = _pil_coeffs(in_size, out_size, filter)
    ksize = idx.shape[1]
    idx_t = torch.from_numpy(idx.reshape(-1).astype(np.int64)).to(x.device)
    taps = x.index_select(axis, idx_t)  # [..., out * ksize, ...] along axis
    shape = list(x.shape)
    shape[axis:axis + 1] = [out_size, ksize]
    wshape = [1] * len(shape)
    wshape[axis:axis + 2] = [out_size, ksize]
    w = torch.from_numpy(kk).to(x.device).view(wshape)
    acc = (taps.view(shape).to(torch.int32) * w).sum(axis + 1, dtype=torch.int32)
    return _clip8(acc.add_(1 << (_PRECISION_BITS - 1))).to(torch.uint8)


def device_resample_u8(x: torch.Tensor, *, out_h: int, out_w: int,
                       filter: str = "bicubic") -> torch.Tensor:
    """Pillow-bit-exact resize of uint8 [N,H,W,C] -> int32 0..255
    [N,out_h,out_w,C]: the horizontal pass, then the vertical pass, clip8
    between them (Pillow's ImagingResample order)."""
    x = _resample_axis_pil(x, out_w, axis=2, filter=filter)
    x = _resample_axis_pil(x, out_h, axis=1, filter=filter)
    return x.to(torch.int32)


@functools.lru_cache(maxsize=64)
def _pil_nearest_indices(in_size: int, out_size: int):
    """Pillow NEAREST source indices from the accumulated coordinate
    (ImagingScaleAffine walks ``xo += scale``; float64 drift lands other than
    a product on boundary columns): (indices clipped into the image [out]
    int32, out of range [out] bool). Out-of-range pixels, reachable only
    through the drift, take Pillow's fill value 0."""
    scale = in_size / out_size
    xo = scale * 0.5
    idx = np.zeros(out_size, np.int64)
    for i in range(out_size):
        idx[i] = -1 if xo < 0 else int(xo)
        xo += scale
    oob = (idx < 0) | (idx >= in_size)
    return np.clip(idx, 0, in_size - 1).astype(np.int32), oob


def raw_u8_for_device(img) -> np.ndarray | None:
    """The decoded uint8 HWC array of ``img`` if the device path may take it,
    else None (the caller preprocesses on the host). Only modes 'L' and 'RGB'
    qualify: Pillow resamples palette ('P') and bilevel ('1') images as
    indices under NEAREST, premultiplies alpha modes ('LA', 'RGBA') before
    the convolution, and 16/32-bit modes break the uint8 fixed point."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8 or getattr(img, "mode", None) not in ("L", "RGB"):
        return None
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr


# The host pipeline's exact float32 value of k / 255 for each byte k.
_U8_TABLE = np.arange(256, dtype=np.float32) / np.float32(255.0)


def u8_table(device) -> torch.Tensor:
    return torch.from_numpy(_U8_TABLE).to(device)


def device_preprocess_images(images_u8: torch.Tensor, *, out_h: int, out_w: int) -> torch.Tensor:
    """uint8 [N,H,W,C] -> float32 [N,out_h,out_w,C], bitwise the host
    ``preprocess``: the resampled pixels, then per image ``/255 iff max >
    1`` through the table."""
    x = device_resample_u8(images_u8, out_h=out_h, out_w=out_w)
    maxes = x.amax(dim=(1, 2, 3), keepdim=True)
    return torch.where(maxes > 1, u8_table(x.device)[x.long()], x.float())


def device_preprocess_masks(masks_raw: torch.Tensor, mask_values: torch.Tensor, *,
                            out_h: int, out_w: int) -> torch.Tensor:
    """Raw masks [N,H,W] (or [N,H,W,3]) -> int32 class indices
    [N,out_h,out_w]: NEAREST (Pillow's accumulated coordinate, fill 0), then
    the index of the pixel's value in ``mask_values`` ([K] values or [K,3]
    RGB rows; 0 where none matches, as on the host)."""
    dev = masks_raw.device
    ry, oob_y = _pil_nearest_indices(masks_raw.shape[1], out_h)
    rx, oob_x = _pil_nearest_indices(masks_raw.shape[2], out_w)
    m = masks_raw.index_select(1, torch.from_numpy(ry.astype(np.int64)).to(dev))
    m = m.index_select(2, torch.from_numpy(rx.astype(np.int64)).to(dev))
    oob = torch.from_numpy(oob_y[:, None] | oob_x[None, :]).to(dev)
    mask_values = mask_values.to(dev)
    if masks_raw.ndim == 4:  # RGB triples
        m = torch.where(oob[None, :, :, None], 0, m)
        eq = (m[..., None, :] == mask_values[None, None, None]).all(-1)  # [N,h,w,K]
    else:
        m = torch.where(oob[None], 0, m)
        eq = m[..., None] == mask_values[None, None, None]
    return eq.to(torch.uint8).argmax(-1).to(torch.int32)


class DevicePipeline:
    """Batches of a raw-decode loader (``RawDataset`` samples), preprocessed
    on ``device``: each raw uint8 batch goes to the device from pinned
    memory without blocking, then is resized and normalised there. Yields
    ``{"image": float32 NHWC, "mask": int32 NHW}`` on ``device``."""

    def __init__(self, loader, mask_values, scale: float, raw_h: int, raw_w: int,
                 device: str | torch.device = "cuda"):
        self.loader = loader
        self.device = torch.device(device)
        self.mask_values = torch.as_tensor(mask_values).to(self.device)
        self.out_h, self.out_w = int(raw_h * scale), int(raw_w * scale)
        if self.out_h <= 0 or self.out_w <= 0:
            raise ValueError("Scale is too small, resized images would have no pixel")

    def __iter__(self):
        for batch in self.loader:
            b = to_device(batch, self.device)
            yield {"image": device_preprocess_images(b["image"], out_h=self.out_h,
                                                     out_w=self.out_w),
                   "mask": device_preprocess_masks(b["mask"], self.mask_values,
                                                   out_h=self.out_h, out_w=self.out_w)}

    def __len__(self):
        return len(self.loader)
