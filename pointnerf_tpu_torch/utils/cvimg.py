"""The port's copies of the three cv2 operations the JAX package calls.

`pointnerf_tpu/data/scannet_ft.py` nearest-resizes its depth maps with
`cv2.resize(..., INTER_NEAREST)` and ranks blur through
`cv2.cvtColor(BGR2GRAY)` and the variance of `cv2.Laplacian(gray,
CV_64F)`. The GPU machine has no cv2, so these are numpy, equal to cv2
5.0.0's results:

- `resize_nearest`: source index min(floor(x · ifx), size - 1) with
  ifx = 1 / (dst / src) in float64, per axis (imgproc resize.cpp
  resizeNN);
- `bgr2gray`: (3735·B + 19235·G + 9798·R + 2^14) >> 15, the 15-bit
  coefficients of 0.114, 0.587 and 0.299 (color_rgb RGB2Gray<uchar>),
  equal to cv2 on all 2^24 colours;
- `laplacian`: the ksize-1 stencil [[0, 1, 0], [1, -4, 1], [0, 1, 0]] in
  float64 over BORDER_REFLECT_101 borders, and `laplacian_var` its
  `np.var`, as the JAX package takes it.
"""

from __future__ import annotations

import numpy as np


def _nearest_index(dst: int, src: int, inv: float = None) -> np.ndarray:
    inv = 1.0 / (float(dst) / float(src)) if inv is None else inv
    return np.minimum(np.floor(np.arange(dst) * inv).astype(np.int64),
                      src - 1)


def resize_nearest(img: np.ndarray, wh, inv_scale=None) -> np.ndarray:
    """cv2.resize(img, (W, H), interpolation=cv2.INTER_NEAREST) on the
    first two axes; `inv_scale` = (1/fx, 1/fy) where cv2 was given scale
    factors."""
    W, H = int(wh[0]), int(wh[1])
    img = np.asarray(img)
    ifx, ify = (None, None) if inv_scale is None else inv_scale
    return img[_nearest_index(H, img.shape[0], ify)][
        :, _nearest_index(W, img.shape[1], ifx)]


def bgr2gray(bgr: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY) of a uint8 [H, W, 3] image."""
    bgr = np.asarray(bgr)
    if bgr.dtype != np.uint8 or bgr.ndim != 3 or bgr.shape[2] != 3:
        raise ValueError("bgr2gray takes uint8 [H, W, 3]")
    b, g, r = (bgr[..., i].astype(np.int32) for i in range(3))
    return ((3735 * b + 19235 * g + 9798 * r + (1 << 14)) >> 15).astype(
        np.uint8)


def _reflect101(n: int) -> np.ndarray:
    """Indices -1..n of an axis of n samples under BORDER_REFLECT_101
    (borderInterpolate; an axis of one sample repeats it)."""
    if n == 1:
        return np.zeros(3, np.int64)
    i = np.arange(-1, n + 1)
    return np.where(i < 0, -i, np.where(i >= n, 2 * n - 2 - i, i))


def laplacian(gray: np.ndarray) -> np.ndarray:
    """cv2.Laplacian(gray, cv2.CV_64F) (ksize 1) of a [H, W] image."""
    g = np.asarray(gray).astype(np.float64)
    p = g[_reflect101(g.shape[0])][:, _reflect101(g.shape[1])]
    return (p[:-2, 1:-1] + p[2:, 1:-1]) + (p[1:-1, :-2] + p[1:-1, 2:]) \
        - 4.0 * g


def laplacian_var(gray: np.ndarray) -> float:
    """float(cv2.Laplacian(gray, cv2.CV_64F).var()), the blur score."""
    return float(laplacian(gray).var())
