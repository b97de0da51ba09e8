"""NeRF-Synthetic 360° per-scene finetune dataset (copy of
`pointnerf_tpu/data/nerf_synth360_ft.py`, numpy only).

Reference: data/nerf_synth360_ft_dataset.py — transforms_{split}.json
cameras, the blender→opencv pose flip, alpha-composited GT over the
configured bg color, COLMAP init point loading. Images are read with the
port's own PNG codec (`utils/png.py`).

Not ported: the render split (spherical video path, `gen_vid`), the MVS
init view triplets and bundles (`get_init_item`, MVS point init, ROADMAP
§1 item 9), and resizing images whose size differs from img_wh.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..utils.png import read_png
from . import register_dataset
from .base import BaseDataset, parse_bg_color
from .ply import read_ply_points

BLENDER2OPENCV = np.array([[1, 0, 0, 0], [0, -1, 0, 0],
                           [0, 0, -1, 0], [0, 0, 0, 1]], dtype=np.float64)


@register_dataset("nerf_synth360_ft")
class NerfSynth360FtDataset(BaseDataset):

    def initialize(self, opt, split: str = "train"):
        if split not in ("train", "test", "val"):
            raise NotImplementedError(f"split {split} is not ported (the "
                                      f"render path waits for gen_vid)")
        self.opt = opt
        self.data_dir = opt.data_root
        self.scan = opt.scan
        self.split = split
        w, h = int(opt.img_wh[0]), int(opt.img_wh[1])
        self.img_wh = (w, h)
        self.width, self.height = w, h
        self.bg_color = parse_bg_color(opt.bg_color)

        with open(os.path.join(self.data_dir, self.scan,
                               f"transforms_{split}.json")) as f:
            self.meta = json.load(f)
        skip = max(1, opt.trainskip if split == "train" else opt.testskip)
        self.id_list = list(range(len(self.meta["frames"])))[::skip]

        # focal from camera_angle_x at the native 800 px, scaled to img_wh
        # (reference: :381-383)
        focal = 0.5 * 800 / np.tan(0.5 * self.meta["camera_angle_x"])
        self.focal = focal * w / 800.0
        self.near_far = np.array([opt.near_plane, opt.far_plane], np.float32)
        self.intrinsics, self.cam2worlds, self.world2cams = self._build_mats()
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

    def _read_images(self):
        """RGBA composited onto the background (reference read_meta
        :414-447): render_gtimgs = rgb·a + (1 − a); alphas; depth masks."""
        self.image_paths, self.render_gtimgs = [], []
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
            self.render_gtimgs.append(rgb * a + (1.0 - a))
            self.depths.append((a[..., 0] > 0.1).astype(np.float32))
            if self.opt.bg_filtering:
                self.alphas.append(
                    (np.linalg.norm(rgb * a, axis=-1) > 1e-6).astype(
                        np.float32))
            else:
                self.alphas.append(a[..., 0])

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
