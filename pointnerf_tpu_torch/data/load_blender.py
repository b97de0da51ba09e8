"""Pickled surface-cloud loading and point-noise jitter (copy of
`pointnerf_tpu/data/load_blender.py`, numpy only).

Reference: data/load_blender.py:116-130 `load_blender_cloud` (a pickle with
`point_xyz` and an optional `point_face_normal`, subsampled with
replacement to `num_point`) and models/neural_points/neural_points.py:
676-695, the `--point_noise func_std` jitter applied right after loading.
Both draw from the RandomState the caller passes, in the JAX package's
order, so one seed gives the same cloud bit for bit in both packages.
"""

from __future__ import annotations

import pickle
from typing import Optional, Tuple

import numpy as np


def load_blender_cloud(point_path: str, point_num: int,
                       rng: Optional[np.random.RandomState] = None
                       ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Load {point_xyz, point_face_normal?} and subsample to point_num,
    with replacement (reference data/load_blender.py:116-130). A pickle
    without `point_xyz` raises KeyError."""
    with open(point_path, "rb") as f:
        infos = pickle.load(f)
    xyz = np.asarray(infos["point_xyz"], np.float32)
    norms = infos.get("point_face_normal")
    norms = None if norms is None else np.asarray(norms, np.float32)
    if point_num < len(xyz):
        rng = rng or np.random.RandomState(0)
        inds = rng.randint(0, len(xyz), size=point_num)
        return xyz[inds], None if norms is None else norms[inds]
    return xyz, norms


def apply_point_noise(xyz: np.ndarray, noise: str,
                      rng: Optional[np.random.RandomState] = None
                      ) -> np.ndarray:
    """--point_noise "func_std" (reference neural_points.py:249-253,
    :676-695); std <= 0 changes nothing."""
    if not noise:
        return xyz
    func, std = noise.split("_")
    std = float(std)
    if std <= 0.0:
        return xyz
    rng = rng or np.random.RandomState(0)
    xyz = np.asarray(xyz, np.float32)

    def uniform(p):
        return p + (rng.rand(*p.shape).astype(np.float32) - 0.5) * std * 2

    if func == "pointgaussian":
        return xyz + rng.randn(*xyz.shape).astype(np.float32) * std
    if func == "pointuniform":
        return uniform(xyz)
    if func == "pointuniformadd":
        return np.concatenate([xyz, uniform(xyz)], 0)
    if func == "pointuniformdouble":
        return uniform(np.concatenate([xyz, xyz], 0))
    raise ValueError(f"unknown point_noise function {func!r} (pointgaussian"
                     "|pointuniform|pointuniformadd|pointuniformdouble)")
