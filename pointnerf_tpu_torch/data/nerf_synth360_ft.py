"""NeRF-Synthetic 360° per-scene finetune dataset (copy of
`pointnerf_tpu/data/nerf_synth360_ft.py`, numpy only).

Reference: data/nerf_synth360_ft_dataset.py — transforms_{split}.json
cameras, the blender→opencv pose flip, alpha-composited GT over the
configured bg color, the spherical render path, COLMAP init point
loading, the MVS init's view triplets and bundles. Images are read with
the port's own PNG codec (`utils/png.py`).

View triplets are the triangles of the camera positions' convex hull
(scipy) where the reference runs open3d's ball pivoting (data_utils.py:
83-120): on the NeRF-Synthetic camera sphere the hull is that surface.

Not ported: resizing images whose size differs from img_wh (ROADMAP §1
item 7).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from ..utils.png import read_png
from . import register_dataset
from .base import BaseDataset, parse_bg_color
from .ply import read_ply_points

BLENDER2OPENCV = np.array([[1, 0, 0, 0], [0, -1, 0, 0],
                           [0, 0, -1, 0], [0, 0, 0, 1]], dtype=np.float64)


def pose_spherical(theta_deg: float, phi_deg: float, radius: float
                   ) -> np.ndarray:
    """Blender-convention spherical camera pose
    (reference: nerf_synth360_ft_dataset.py:42-69)."""
    t, p = np.deg2rad(theta_deg), np.deg2rad(phi_deg)
    trans = np.eye(4)
    trans[2, 3] = radius
    rphi = np.eye(4)
    rphi[1, 1], rphi[1, 2] = np.cos(p), -np.sin(p)
    rphi[2, 1], rphi[2, 2] = np.sin(p), np.cos(p)
    rth = np.eye(4)
    rth[0, 0], rth[0, 2] = np.cos(t), -np.sin(t)
    rth[2, 0], rth[2, 2] = np.sin(t), np.cos(t)
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0],
                     [0, 0, 0, 1]], dtype=np.float64)
    return flip @ rth @ rphi @ trans


def hull_view_triplets(cam_xyz: np.ndarray, full_comb: bool = False
                       ) -> List[List[int]]:
    """Init view triplets: the triangles of the camera positions' convex
    hull; without full_comb, a triangle is dropped when an earlier one
    holds the same three views."""
    from scipy.spatial import ConvexHull
    if len(cam_xyz) < 4:
        return [list(range(len(cam_xyz)))]
    hull = ConvexHull(np.asarray(cam_xyz, np.float64))
    tris = [list(map(int, s)) for s in hull.simplices]
    if full_comb:
        return tris
    seen, out = set(), []
    for t in tris:
        key = frozenset(t)
        if any(len(key & s) >= 3 for s in seen):
            continue
        seen.add(key)
        out.append(t)
    return out


@register_dataset("nerf_synth360_ft")
class NerfSynth360FtDataset(BaseDataset):

    def initialize(self, opt, split: str = "train"):
        """split train, test, val, or render: the spherical path's 20 poses
        with the train split's cameras and no images."""
        if split not in ("train", "test", "val", "render"):
            raise ValueError(f"split {split}: train, test, val or render")
        self.opt = opt
        self.data_dir = opt.data_root
        self.scan = opt.scan
        self.split = split
        w, h = int(opt.img_wh[0]), int(opt.img_wh[1])
        self.img_wh = (w, h)
        self.width, self.height = w, h
        self.bg_color = parse_bg_color(opt.bg_color)

        meta_split = "train" if split == "render" else split
        with open(os.path.join(self.data_dir, self.scan,
                               f"transforms_{meta_split}.json")) as f:
            self.meta = json.load(f)
        skip = max(1, opt.trainskip if meta_split == "train"
                   else opt.testskip)
        self.id_list = list(range(len(self.meta["frames"])))[::skip]

        # focal from camera_angle_x at the native 800 px, scaled to img_wh
        # (reference: :381-383)
        focal = 0.5 * 800 / np.tan(0.5 * self.meta["camera_angle_x"])
        self.focal = focal * w / 800.0
        self.near_far = np.array([opt.near_plane, opt.far_plane], np.float32)
        self.intrinsics, self.cam2worlds, self.world2cams = self._build_mats()
        if split == "render":
            self._build_render_poses()
            self.total = len(self.render_poses)
            return
        # reference: build_init_metas (:337-353)
        self.view_id_list = [] if split != "train" else hull_view_triplets(
            self.cam2worlds[:, :3, 3], full_comb=opt.full_comb > 0)
        self._read_images()
        self.total = len(self.id_list)

    def _build_mats(self):
        K = np.array([[self.focal, 0, self.width / 2],
                      [0, self.focal, self.height / 2],
                      [0, 0, 1]], dtype=np.float32)
        intrinsics, c2ws, w2cs = [], [], []
        for vid in self.id_list:
            c2w = np.array(self.meta["frames"][vid]["transform_matrix"],
                           np.float64) @ BLENDER2OPENCV
            c2ws.append(c2w.astype(np.float32))
            w2cs.append(np.linalg.inv(c2w).astype(np.float32))
            intrinsics.append(K.copy())
        return np.stack(intrinsics), np.stack(c2ws), np.stack(w2cs)

    def _build_render_poses(self, stride: int = 20, radius: float = 4.0):
        """reference: get_render_poses (:169-174)."""
        self.render_poses = np.stack(
            [pose_spherical(a, -30.0, radius) @ BLENDER2OPENCV
             for a in np.linspace(-180, 180, stride + 1)[:-1]], 0
        ).astype(np.float32)

    def _read_images(self):
        """RGBA composited onto the background (reference read_meta
        :414-447): render_gtimgs = rgb·a + (1 − a); mvsimgs = rgb·a; alphas
        (with bg_filtering, the pixels whose rgb·a is not black); depth
        masks (alpha > 0.1)."""
        self.image_paths, self.render_gtimgs, self.mvsimgs = [], [], []
        self.alphas, self.depths = [], []
        for vid in self.id_list:
            frame = self.meta["frames"][vid]
            path = os.path.join(self.data_dir, self.scan,
                                frame["file_path"] + ".png")
            self.image_paths.append(path)
            arr = read_png(path).astype(np.float32) / 255.0
            if arr.shape[:2] != (self.height, self.width):
                raise NotImplementedError(
                    f"{path} is {arr.shape[1]}x{arr.shape[0]}, img_wh is "
                    f"{self.width}x{self.height}: resizing is not ported")
            if arr.ndim == 2:
                arr = np.repeat(arr[..., None], 4, axis=-1)
            if arr.shape[-1] == 3:
                arr = np.concatenate([arr, np.ones_like(arr[..., :1])], -1)
            rgb, a = arr[..., :3], arr[..., 3:4]
            self.mvsimgs.append(rgb * a)
            self.render_gtimgs.append(rgb * a + (1.0 - a))
            self.depths.append((a[..., 0] > 0.1).astype(np.float32))
            if self.opt.bg_filtering:
                self.alphas.append(
                    (np.linalg.norm(rgb * a, axis=-1) > 1e-6).astype(
                        np.float32))
            else:
                self.alphas.append(a[..., 0])

    def get_init_item(self, idx: int) -> Dict:
        """MVS init bundle of view triplet `idx` (reference: :479-553).

        Un-batched arrays: images/mvs_images [V,3,H,W], proj_mats
        [V,V,3,4] (proj_mats[i][j] maps ref view i onto view j at the H/4
        feature scale; the identity where i == j), intrinsics [V,3,3],
        w2cs/c2ws [V,4,4], near_fars [V,2], near_fars_depth [2],
        depths_h/alphas [V,H,W], view_ids [V]."""
        view_ids = self.view_id_list[idx][: self.opt.init_view_num]
        K4 = self.intrinsics[0].copy()
        K4[:2] /= 4.0  # features are at H/4 (reference: :398-400)
        affine = []
        for vid in view_ids:
            a = np.eye(4, dtype=np.float64)
            a[:3, :4] = K4 @ self.world2cams[vid][:3, :4]
            affine.append(a)
        V = len(view_ids)
        proj_mats = np.stack([
            np.stack([np.eye(4) if i == j else
                      affine[j] @ np.linalg.inv(affine[i])
                      for j in range(V)])[:, :3]
            for i in range(V)])
        pick = lambda arrs: np.stack([arrs[v] for v in view_ids]).astype(
            np.float32)
        chw = lambda arrs: np.stack([np.transpose(arrs[v], (2, 0, 1))
                                     for v in view_ids]).astype(np.float32)
        return {
            "images": chw(self.render_gtimgs),
            "mvs_images": chw(self.mvsimgs),
            "depths_h": pick(self.depths),
            "alphas": pick(self.alphas),
            "w2cs": pick(self.world2cams),
            "c2ws": pick(self.cam2worlds),
            "near_fars_depth": np.asarray(self.near_far, np.float32),
            "near_fars": np.stack([self.near_far] * V).astype(np.float32),
            "proj_mats": proj_mats.astype(np.float32),
            "intrinsics": pick(self.intrinsics),
            "view_ids": np.asarray(view_ids),
        }

    def get_dummyrot_item(self, idx: int,
                          rng: Optional[np.random.RandomState] = None
                          ) -> Dict:
        """Render-path item without GT (reference: :662-743)."""
        rng = rng or np.random.RandomState()
        return self.make_item(None, self.intrinsics[0], self.render_poses[idx],
                              self.opt.near_plane, self.opt.far_plane, rng,
                              idx, full_img=True)

    def load_init_points(self) -> np.ndarray:
        """COLMAP dense points (reference: :356-373)."""
        path = os.path.join(self.data_dir, self.scan,
                            "colmap_results/dense/fused.ply")
        xyz, _ = read_ply_points(path)
        return xyz

    def get_campos_ray(self):
        """Per-train-view camera centers and center-pixel view dirs
        (reference: :320-334), for the nearest-view direction init."""
        from ..ops.camera import get_dtu_raydir
        center = np.asarray(self.img_wh, np.float32)[None] // 2
        pos, dirs = [], []
        for i in range(len(self.id_list)):
            c2w = self.cam2worlds[i]
            pos.append(c2w[:3, 3])
            dirs.append(np.asarray(get_dtu_raydir(
                center, self.intrinsics[0], c2w[:3, :3], True))[0])
        return np.stack(pos), np.stack(dirs)
