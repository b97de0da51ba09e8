"""Geometry helpers (port of `pointnerf_tpu/ops/geometry.py`; reference:
models/helpers/geometrics.py)."""

from __future__ import annotations

import torch


def roll_pitch_yaw_to_rotation_matrices(rpy: torch.Tensor) -> torch.Tensor:
    """[..., 3] roll/pitch/yaw (radians) → [..., 3, 3] rotation matrices:
    roll about x, then pitch about y, then yaw about z (reference
    geometrics.py:45-70)."""
    c, s = torch.cos(rpy), torch.sin(rpy)
    cx, cy, cz = c[..., 0], c[..., 1], c[..., 2]
    sx, sy, sz = s[..., 0], s[..., 1], s[..., 2]
    rot = torch.stack([
        cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx,
        sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx,
        -sy, cy * sx, cy * cx,
    ], dim=-1)
    return rot.reshape(rpy.shape[:-1] + (3, 3))


def compute_world2local_dist(dists: torch.Tensor, radii: torch.Tensor,
                             rotations: torch.Tensor) -> torch.Tensor:
    """Offsets in anisotropic-gaussian local frames (reference
    geometrics.py:15-42): diag(1 / (radii + 1e-8)) · R(rotations) · d.
    dists, radii, rotations [..., 3] → [..., 3, 1]. The 3×3 by 3×1 product
    is summed elementwise, so no device takes it into TF32."""
    rotation = roll_pitch_yaw_to_rotation_matrices(rotations)
    tx = rotation * (1.0 / (radii + 1e-8))[..., None]
    return torch.sum(tx * dists[..., None, :], dim=-1, keepdim=True)


def vect2euler(xyz: torch.Tensor) -> torch.Tensor:
    """Direction vector → euler angles (reference
    neural_points.py:613-619)."""
    yz_norm = torch.linalg.norm(xyz[..., 1:3], dim=-1)
    e_x = torch.atan2(-xyz[..., 1], xyz[..., 2])
    e_y = torch.atan2(xyz[..., 0], yz_norm)
    return torch.stack([e_x, e_y, torch.zeros_like(e_y)], dim=-1)
