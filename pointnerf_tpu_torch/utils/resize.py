"""Pillow's `Image.resize` in numpy, equal to it uint8 for uint8.

The JAX package resizes the datasets' images with Pillow
(`pointnerf_tpu/data/{dtu,dtu_ft}.py`: BILINEAR; `tt_ft.py`,
`nerf_synth360_ft.py`: LANCZOS), and the GPU machine has no Pillow. This
module follows Pillow's `src/libImaging/Resample.c` for 8-bit images:

- per output pixel, a window of source taps around the center
  `(x + 0.5) · scale`, with the filter's support widened by the scale when
  the image shrinks (`precompute_coeffs`);
- the window's weights normalised to sum 1 in float64, then turned into
  fixed-point integers with PRECISION_BITS = 32 - 8 - 2 fractional bits,
  rounded half away from zero (`normalize_coeffs_8bpc`);
- the horizontal pass first, over the source rows the vertical pass reads,
  then the vertical pass; each runs only where its axis changes size;
- each pass sums in integers from `1 << (PRECISION_BITS - 1)` and takes
  the top bits, clipped to 0-255 (`clip8`).

`Image.resize` turns LA and RGBA into premultiplied La and RGBa before it
resamples and back after (`PIL.Image.Image.resize`); `_premultiply` and
`_unpremultiply` are Pillow's integer conversions (`Convert.c`: rgbA2rgba
with MULDIV255, rgba2rgbA with a truncating divide). `reducing_gap` is
None in every call the datasets make, so there is no `reduce()` step.
Palette images, which Pillow resizes with NEAREST whatever the filter, do
not arise: the port's PNG codec reads none.
"""

from __future__ import annotations

import math

import numpy as np

PRECISION_BITS = 32 - 8 - 2


def _bilinear(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _sinc(x: np.ndarray) -> np.ndarray:
    px = x * math.pi
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(x == 0.0, 1.0, np.sin(px) / px)


def _lanczos(x: np.ndarray) -> np.ndarray:
    return np.where((-3.0 <= x) & (x < 3.0), _sinc(x) * _sinc(x / 3), 0.0)


FILTERS = {"bilinear": (_bilinear, 1.0), "lanczos": (_lanczos, 3.0)}


def precompute_coeffs(in_size: int, out_size: int, name: str):
    """(bounds [out, 2] = (first tap, tap count), fixed-point weights
    [out, ksize]) of one axis (Resample.c precompute_coeffs +
    normalize_coeffs_8bpc, box = the whole axis)."""
    fn, support = FILTERS[name]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    # C's (int) cast truncates toward zero
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64),
                      in_size) - xmin
    taps = np.arange(ksize, dtype=np.int64)
    live = taps[None, :] < xmax[:, None]
    w = fn((taps[None, :] + xmin[:, None] - center[:, None] + 0.5)
           * (1.0 / filterscale))
    w = np.where(live, w, 0.0)
    # Pillow sums the taps in order (np.sum would pair them)
    ww = np.zeros((out_size, 1))
    for t in range(ksize):
        ww[:, 0] += w[:, t]
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    w = np.where(live, w, 0.0)
    scaled = w * float(1 << PRECISION_BITS)
    kk = np.where(w < 0, np.trunc(-0.5 + scaled),
                  np.trunc(0.5 + scaled)).astype(np.int64)
    return np.stack([xmin, xmax], axis=1), kk


def _clip8(ss: np.ndarray) -> np.ndarray:
    return np.clip(ss >> PRECISION_BITS, 0, 255).astype(np.uint8)


def _pass(img: np.ndarray, axis: int, bounds: np.ndarray,
          kk: np.ndarray) -> np.ndarray:
    """One resampling pass of a uint8 [H, W, C] image along `axis`, in
    int32 as Pillow sums (INT32 ss and k: 255 times the weights' absolute
    sum stays below 2^31 at PRECISION_BITS)."""
    n_in = img.shape[axis]
    src = np.ascontiguousarray(np.moveaxis(img, axis, 0)).astype(np.int32)
    ss = np.full((len(bounds),) + src.shape[1:], 1 << (PRECISION_BITS - 1),
                 np.int32)
    kk = kk.astype(np.int32)
    for t in range(kk.shape[1]):
        idx = np.minimum(bounds[:, 0] + t, n_in - 1)
        k = kk[:, t].reshape((-1,) + (1,) * (src.ndim - 1))
        ss += src[idx] * k
    return np.moveaxis(_clip8(ss), 0, axis)


def _premultiply(img: np.ndarray) -> np.ndarray:
    """RGBA → RGBa (LA → La): colour · alpha / 255 with MULDIV255's
    rounding, alpha kept."""
    a = img[..., -1:].astype(np.int64)
    tmp = img[..., :-1].astype(np.int64) * a + 128
    col = ((tmp >> 8) + tmp) >> 8
    return np.concatenate([col, a], axis=-1).astype(np.uint8)


def _unpremultiply(img: np.ndarray) -> np.ndarray:
    """RGBa → RGBA (La → LA): colour · 255 / alpha, truncated and clipped;
    colours of alpha 0 and 255 pass as they are."""
    a = img[..., -1:].astype(np.int64)
    col = img[..., :-1].astype(np.int64)
    div = np.minimum(255 * col // np.maximum(a, 1), 255)
    col = np.where((a == 0) | (a == 255), col, div)
    return np.concatenate([col, a], axis=-1).astype(np.uint8)


def resize(img: np.ndarray, size, resample: str = "bilinear") -> np.ndarray:
    """`Image.fromarray(img).resize(size, resample)` as a uint8 array.

    img: uint8 [H, W] (L), [H, W, 2] (LA), [H, W, 3] (RGB) or [H, W, 4]
    (RGBA). size: (width, height), Pillow's order. resample: "bilinear" or
    "lanczos"."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"resize takes uint8 images, not {img.dtype}")
    if resample not in FILTERS:
        raise ValueError(f"resample {resample!r}: the port has "
                         f"{sorted(FILTERS)}")
    gray = img.ndim == 2
    if gray:
        img = img[..., None]
    if img.ndim != 3 or img.shape[-1] not in (1, 2, 3, 4):
        raise ValueError(f"resize takes [H, W] or [H, W, 1-4], not "
                         f"{img.shape}")
    W, H = int(size[0]), int(size[1])
    if W < 1 or H < 1:
        raise ValueError(f"size {size}: width and height must be >= 1")
    h_in, w_in = img.shape[:2]
    if (w_in, h_in) == (W, H):
        return img[..., 0].copy() if gray else img.copy()
    alpha = img.shape[-1] in (2, 4)
    out = _premultiply(img) if alpha else img
    bx, kx = precompute_coeffs(w_in, W, resample)
    by, ky = precompute_coeffs(h_in, H, resample)
    if W != w_in:
        # only the source rows the vertical pass reads
        first, last = by[0, 0], by[-1, 0] + by[-1, 1]
        out = _pass(out[first:last], 1, bx, kx)
        by = by - np.asarray([first, 0])
    if H != h_in:
        out = _pass(out, 0, by, ky)
    if alpha:
        out = _unpremultiply(out)
    return out[..., 0] if gray else out
