"""Plane background: per-ray background colours from the MVS init views
(port of `pointnerf_tpu/models/mvs/bg.py`).

Reference:
* ``gen_bg_points`` / ``get_rayplane_cross``  — models/mvs/mvs_utils.py:380-404
* ``set_bg``                                  — models/mvs_points_volumetric_model.py:272-310
* ``homo_warp_fg_mask`` / ``id2mask``         — models/mvs/mvs_utils.py:317-330, 372-377
* driver wiring / ``create_all_bg``           — run/train_ft.py:206-215, 548-576, 788-798

Each camera ray's crossing with the scene's background plane is projected
into every init view. Where that pixel is not covered by the foreground
cloud and its colour lies within a threshold of the plane's colour, the
view contributes the colour; the ray's background is the maximum over the
views. The driver precomputes one [H, W, 3] map per train and test frame
and indexes it per ray batch (`bg_ray`).

As in the JAX package, the projections, the `ceil` cells and the masks are
float32 numpy on the host (preprocessing, once per frame), so masks and
cells are JAX's exactly. The colours are sampled on the views' device with
the port's `ops/interp.grid_sample_2d` (align_corners=True), JAX's
four-tap form op by op; the colour tests and the maximum run on the host.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...ops.interp import grid_sample_2d


def get_rayplane_cross(campos: np.ndarray, raydir: np.ndarray, plane_pnt,
                       plane_normal, epsilon: float = 1e-3) -> np.ndarray:
    """Ray/plane crossings in world space (reference mvs_utils.py:387-404).

    campos [B,3], raydir [B,R,3] -> [B,R,3]; rays more parallel than epsilon
    (or pointing away) give zeros, as in the reference.
    """
    p_no = np.asarray(plane_normal, np.float32).reshape(1, 1, 3)
    p_co = np.asarray(plane_pnt, np.float32).reshape(1, 1, 3)
    dot = np.sum(p_no * raydir, axis=-1)                      # [B,R]
    ok = dot >= epsilon
    w = campos[:, None, :] - p_co                             # [B,1,3]
    fac = -np.sum(p_no * w, axis=-1) / np.where(ok, dot, 1.0)  # [B,R]
    cross = campos[:, None, :] + raydir * fac[..., None]
    return np.where(ok[..., None], cross, 0.0).astype(np.float32)


def _project(xyz_w: np.ndarray, w2c: np.ndarray, intrinsic: np.ndarray
             ) -> Tuple[np.ndarray, np.ndarray]:
    """World points -> (pixel xy [N,2], camera z [N])."""
    hom = np.concatenate([xyz_w, np.ones_like(xyz_w[:, :1])], axis=-1)
    cam = (hom @ w2c.T)[:, :3]
    z = cam[:, 2]
    pix = (cam / np.where(np.abs(z[:, None]) > 1e-9, z[:, None], 1e-9)) \
        @ intrinsic.T
    return pix[:, :2], z


def _in_bounds(xy: np.ndarray, hard: np.ndarray, z: np.ndarray, H: int,
               W: int) -> np.ndarray:
    return (xy[:, 0] >= 0) & (hard[:, 0] <= W - 1) & \
        (xy[:, 1] >= 0) & (hard[:, 1] <= H - 1) & (z > 1e-9)


def fg_mask_from_points(xyz_w: np.ndarray, w2c: np.ndarray,
                        intrinsic: np.ndarray, H: int, W: int) -> np.ndarray:
    """[H,W] uint8: the pixels whose ceil cell a foreground point projects
    into (reference homo_warp_fg_mask + id2mask, mvs_utils.py:317-330,
    372-377)."""
    xy, z = _project(xyz_w, w2c, intrinsic)
    hard = np.ceil(xy)
    inb = _in_bounds(xy, hard, z, H, W)
    mask = np.zeros((H, W), np.uint8)
    h = hard[inb].astype(np.int64)
    mask[h[:, 1], h[:, 0]] = 1
    return mask


def set_bg(xyz_sect_plane: np.ndarray, views: Sequence[Dict],
           plane_color, fg_xyz: Optional[np.ndarray] = None,
           fg_masks: Optional[List[np.ndarray]] = None,
           thresh: float = 0.03) -> Tuple[np.ndarray, List[np.ndarray]]:
    """The background colour of each ray from the init views (reference
    mvs_points_volumetric_model.set_bg :272-310).

    xyz_sect_plane: [R,3] ray/plane crossings (world). views: dicts with
    ``img`` [3,H,W] (a float tensor on the device that samples it),
    ``w2c`` [4,4] and ``intrinsic`` [3,3] (numpy). Pixels the foreground
    cloud covers are left out; colours outside plane_color ± thresh are
    zeroed; the result is the maximum over the views. Returns (bg_ray
    [R,3] numpy, fg_masks), the masks made once from fg_xyz and reusable.
    """
    plane_color = np.asarray(plane_color, np.float32)
    R = xyz_sect_plane.shape[0]
    if fg_masks is None:
        if fg_xyz is None:
            raise ValueError("set_bg needs fg_xyz to build the foreground "
                             "masks")
        fg_masks = []
        for v in views:
            H, W = v["img"].shape[-2:]
            fg_masks.append(fg_mask_from_points(fg_xyz, v["w2c"],
                                                v["intrinsic"], H, W))
    per_view = []
    for v, fg in zip(views, fg_masks):
        H, W = v["img"].shape[-2:]
        xy, z = _project(xyz_sect_plane, v["w2c"], v["intrinsic"])
        hard = np.ceil(xy)
        inb = _in_bounds(xy, hard, z, H, W)
        h = hard.astype(np.int64)
        not_fg = np.zeros(R, bool)
        not_fg[inb] = fg[h[inb, 1], h[inb, 0]] < 1
        keep = inb & not_fg
        grid = np.stack([xy[:, 0] / ((W - 1) / 2.0) - 1.0,
                         xy[:, 1] / ((H - 1) / 2.0) - 1.0], axis=-1)
        col = grid_sample_2d(v["img"], torch.as_tensor(
            grid.astype(np.float32), device=v["img"].device),
            align_corners=True).cpu().numpy()
        col = col * keep[:, None].astype(np.float32)
        fit = np.all((col >= plane_color - thresh) &
                     (col <= plane_color + thresh), axis=-1)
        per_view.append(col * fit[:, None])
    bg = np.max(np.stack(per_view, axis=1), axis=1)       # [R,3]
    return bg.astype(np.float32), fg_masks


def collect_bg_views(dataset, init_view_num: int = 3,
                     device="cuda") -> List[Dict]:
    """The reference view of each MVS init bundle, as set_bg takes it: the
    image on `device`, the cameras as numpy (reference: the views
    gen_points_filter_embeddings collects, train_ft.py:70-90)."""
    dev = torch.device(device)
    views = []
    for ti in range(len(dataset.view_id_list)):
        s = dataset.get_init_item(ti)
        views.append({"img": torch.as_tensor(
            np.asarray(s["images"][0], np.float32), device=dev),
            "w2c": np.asarray(s["w2cs"][0], np.float32),
            "intrinsic": np.asarray(s["intrinsics"][0], np.float32)})
    return views


def create_all_bg(dataset, views: Sequence[Dict], fg_xyz: np.ndarray,
                  plane_params, dummy: bool = False) -> List[np.ndarray]:
    """Per-frame [H,W,3] background maps (reference run/train_ft.py:
    548-576). plane_params: (plane_pnt, plane_normal, plane_color);
    dummy=True walks the render poses through get_dummyrot_item."""
    plane_pnt, plane_normal, plane_color = plane_params
    fg_masks = None
    out = []
    for i in range(len(dataset)):
        item = dataset.get_dummyrot_item(i) if dummy else \
            dataset.get_item(i, full_img=True)
        H, W = int(item["h"]), int(item["w"])
        cross = get_rayplane_cross(item["campos"], item["raydir"],
                                   plane_pnt, plane_normal)[0]
        bg, fg_masks = set_bg(cross, views, plane_color, fg_xyz=fg_xyz,
                              fg_masks=fg_masks)
        # items raster their rays row-major over the image (pixel_idx)
        pix = item["pixel_idx"][0].astype(np.int64)
        img = np.zeros((H, W, 3), np.float32)
        img[pix[:, 1], pix[:, 0]] = bg
        out.append(img)
    return out
