"""Plane fitting and plane point generation for the background models
(copy of `pointnerf_tpu/data/fitplane.py`, numpy only).

Reference: data/fitplane.py (skspatial best-fit over a sampled ply, offline)
and dtu_ft_dataset.get_plane_param_points (:902-924). skspatial is replaced by
a least-squares SVD fit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def best_fit_plane(points: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Least-squares plane through points [N,3] → (point_on_plane, unit normal)."""
    pts = np.asarray(points, np.float64)
    center = pts.mean(axis=0)
    _, _, vt = np.linalg.svd(pts - center, full_matrices=False)
    normal = vt[-1]
    normal = normal / np.linalg.norm(normal)
    if normal[2] < 0:  # orient +z-ish like the reference's DTU planes
        normal = -normal
    return center.astype(np.float32), normal.astype(np.float32)


def generate_plane_points(plane_pnt, plane_normal, r: float = 10.0,
                          amount: int = 8000,
                          rng: Optional[np.random.RandomState] = None
                          ) -> np.ndarray:
    """Sample points on the plane (reference: dtu_ft_dataset.py:903-911)."""
    rng = rng or np.random.RandomState(0)
    a, b, c = plane_normal
    x0, y0, z0 = plane_pnt
    x = r * (rng.rand(amount) - 0.7)
    y = r * (rng.rand(amount) - 0.6)
    z = (a * (x - x0) + b * (y - y0)) / (-c) + z0
    return np.stack([x, y, z], axis=-1).astype(np.float32)


def plane_distance(xyz: np.ndarray, plane_pnt, plane_normal) -> np.ndarray:
    """|signed distance| of points to the plane (reference filter_plane :927-934)."""
    a, b, c = plane_normal
    x0, y0, z0 = plane_pnt
    d = -a * x0 - b * y0 - c * z0
    return np.abs(xyz[..., 0] * a + xyz[..., 1] * b + xyz[..., 2] * c + d)


def get_rayplane_cross(campos: np.ndarray, raydir: np.ndarray, plane_pnt,
                       plane_normal, epsilon: float = 1e-3) -> np.ndarray:
    """Ray-plane intersections (reference: mvs_utils.get_rayplane_cross
    :387-404). campos [3]; raydir [R,3]. Returns [R,3] (0 where parallel)."""
    p_no = np.asarray(plane_normal, np.float32)
    p_co = np.asarray(plane_pnt, np.float32)
    dot = raydir @ p_no
    ok = dot >= epsilon
    w = campos - p_co
    fac = np.where(ok, -(w @ p_no) / np.where(ok, dot, 1.0), 0.0)
    return raydir * fac[..., None] + campos
