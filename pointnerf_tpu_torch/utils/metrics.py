"""Image quality metrics: PSNR / SSIM / RMSE, LPIPS gated on local weights
(copy of `pointnerf_tpu/utils/metrics.py`, numpy and scipy only).

Reference: run/evaluate.py:34-97 (skimage compare_psnr, compare_ssim with
an 11-pixel window per channel, mean_squared_error; lpips alex + vgg).
SSIM follows Wang et al. 2004 as skimage computes it: uniform 11×11
window, K1 = 0.01, K2 = 0.03, per channel then averaged. LPIPS needs
pretrained weights: without a local weights file it is skipped and
recorded as skipped, as in the JAX package; with one it raises, since the
LPIPS network is not ported (ROADMAP §1 item 3).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
from scipy.ndimage import uniform_filter

from .png import read_png


def psnr(gt: np.ndarray, img: np.ndarray, data_range: float = 1.0) -> float:
    """Peak signal-to-noise ratio (reference: compare_psnr, evaluate.py:60)."""
    gt = np.asarray(gt, np.float64)
    img = np.asarray(img, np.float64)
    mse = np.mean((gt - img) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range ** 2 / mse))


def rmse(gt: np.ndarray, img: np.ndarray) -> float:
    """Root mean squared error (reference: evaluate.py:79)."""
    return float(np.sqrt(np.mean((np.asarray(gt, np.float64)
                                  - np.asarray(img, np.float64)) ** 2)))


def _ssim_single(gt, img, win_size, data_range):
    """SSIM of one 2-D channel as skimage computes it (uniform filter,
    sample covariance, edges cropped)."""
    K1, K2 = 0.01, 0.03
    gt = np.asarray(gt, np.float64)
    img = np.asarray(img, np.float64)
    NP = win_size ** gt.ndim
    cov_norm = NP / (NP - 1)

    filt = lambda a: uniform_filter(a, size=win_size)
    ux, uy = filt(gt), filt(img)
    uxx, uyy, uxy = filt(gt * gt), filt(img * img), filt(gt * img)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    C1, C2 = (K1 * data_range) ** 2, (K2 * data_range) ** 2
    A1, A2 = 2 * ux * uy + C1, 2 * vxy + C2
    B1, B2 = ux ** 2 + uy ** 2 + C1, vx + vy + C2
    S = (A1 * A2) / (B1 * B2)
    pad = (win_size - 1) // 2
    return float(S[pad:-pad or None, pad:-pad or None].mean())


def ssim(gt: np.ndarray, img: np.ndarray, win_size: int = 11,
         data_range: float = 1.0) -> float:
    """Multichannel SSIM (reference: compare_ssim(gt, img, 11,
    multichannel=True), evaluate.py:62)."""
    gt = np.asarray(gt)
    img = np.asarray(img)
    if gt.ndim == 2:
        return _ssim_single(gt, img, win_size, data_range)
    return float(np.mean([_ssim_single(gt[..., c], img[..., c], win_size,
                                       data_range)
                          for c in range(gt.shape[-1])]))


def report_metrics(gt_dir: str, img_dir: str, out_dir: str,
                   metrics: Sequence[str] = ("psnr", "ssim", "rmse"),
                   img_str: str = "step-%04d-coarse_raycolor.png",
                   gt_str: str = "step-%04d-gt_image.png",
                   id_list: Optional[Sequence[int]] = None,
                   lpips_weights: Optional[Dict[str, str]] = None
                   ) -> Dict[str, float]:
    """Directory-level evaluation (reference: run/evaluate.py:34-97):
    per-metric txt files and scores.txt in out_dir; returns the means."""
    if id_list is None:
        id_list = range(999)
    lpips_weights = lpips_weights or {}
    for k in metrics:
        path = lpips_weights.get(k)
        if k in ("lpips", "vgglpips") and path and os.path.exists(path):
            raise NotImplementedError(f"{k}: the LPIPS network is not ported "
                                      f"(ROADMAP §1 item 3)")

    total: Dict[str, List[float]] = {}
    for i in id_list:
        ip = os.path.join(img_dir, img_str % i)
        gp = os.path.join(gt_dir, gt_str % i)
        if not (os.path.exists(ip) and os.path.exists(gp)):
            break
        img = read_png(ip).astype(np.float32) / 255.0
        gt = read_png(gp).astype(np.float32) / 255.0
        img, gt = img[..., :3], gt[..., :3]
        for key in metrics:
            if key == "psnr":
                val = psnr(gt, img)
            elif key == "ssim":
                val = ssim(gt, img, 11)
            elif key == "rmse":
                val = rmse(gt, img)
            elif key in ("lpips", "vgglpips"):
                continue
            else:
                raise NotImplementedError(key)
            total.setdefault(key, []).append(val)

    os.makedirs(out_dir, exist_ok=True)
    out_str = ""
    means = {}
    for key, vals in total.items():
        arr = np.asarray(vals).reshape(-1)
        np.savetxt(os.path.join(out_dir, key + ".txt"), arr)
        means[key] = float(arr.mean())
        out_str += key + ": %.6f\n" % means[key]
    # requested but skipped metrics are recorded, so a quality table is
    # never silently incomplete
    for k in metrics:
        if k not in total:
            reason = "no weights file" if k in ("lpips", "vgglpips") \
                else "no images"
            out_str += f"{k}: SKIPPED ({reason})\n"
    with open(os.path.join(out_dir, "scores.txt"), "w") as f:
        f.write(out_str)
    return means
