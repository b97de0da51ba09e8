"""Camera / ray utilities (port of `pointnerf_tpu/ops/camera.py`).

`w2pers` works on tensors; `get_blender_raydir` and `get_dtu_raydir` are
the numpy host-side ray generators of the data pipeline.
"""

from __future__ import annotations

import numpy as np
import torch


def w2pers(point_xyz_w: torch.Tensor, camrotc2w: torch.Tensor,
           campos: torch.Tensor) -> torch.Tensor:
    """World → perspective camera coords (x/z, y/z, z).

    point_xyz_w [B, ..., 3]; camrotc2w [B,3,3] camera-to-world rotation;
    campos [B,3]. xyz_c = R^T (x - c) (reference point_query.py:101-108).
    """
    lead = point_xyz_w.dim() - 2
    B = campos.shape[0]
    shift = point_xyz_w - campos.reshape((B,) + (1,) * lead + (3,))
    rot_t = camrotc2w.transpose(-1, -2).reshape((B,) + (1,) * lead + (3, 3))
    xyz_c = torch.sum(shift[..., None, :] * rot_t, dim=-1)
    x = xyz_c[..., 0] / xyz_c[..., 2]
    y = xyz_c[..., 1] / xyz_c[..., 2]
    return torch.stack([x, y, xyz_c[..., 2]], dim=-1)


def get_blender_raydir(pixelcoords, height, width, focal, rot_c2w,
                       dir_norm: bool = True) -> np.ndarray:
    """Blender convention (y up, -z forward). Reference data_utils.py:41-53."""
    x = (pixelcoords[..., 0] + 0.5 - width / 2.0) / focal
    y = (pixelcoords[..., 1] + 0.5 - height / 2.0) / focal
    z = np.ones_like(x)
    dirs = np.stack([x, -y, -z], axis=-1)
    dirs = np.sum(dirs[..., None, :] * rot_c2w[:, :], axis=-1)
    if dir_norm:
        dirs = dirs / (np.linalg.norm(dirs, axis=-1, keepdims=True) + 1e-5)
    return dirs.astype(np.float32)


def get_dtu_raydir(pixelcoords, intrinsic, rot_c2w,
                   dir_norm: bool = True) -> np.ndarray:
    """Pixel coords → world ray dirs, OpenCV convention with the +0.5 pixel
    center (reference data_utils.py:55-69). pixelcoords [..., 2] (x, y),
    intrinsic [3,3], rot_c2w [3,3]; numpy, for the host data pipeline."""
    x = (pixelcoords[..., 0] + 0.5 - intrinsic[0, 2]) / intrinsic[0, 0]
    y = (pixelcoords[..., 1] + 0.5 - intrinsic[1, 2]) / intrinsic[1, 1]
    z = np.ones_like(x)
    dirs = np.stack([x, y, z], axis=-1)
    dirs = dirs @ rot_c2w.T
    if dir_norm:
        dirs = dirs / (np.linalg.norm(dirs, axis=-1, keepdims=True) + 1e-5)
    return dirs.astype(np.float32)
