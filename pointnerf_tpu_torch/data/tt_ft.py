"""Tanks & Temples per-scene finetune dataset in the NSVF layout (copy of
`pointnerf_tpu/data/tt_ft.py`, numpy only).

Reference: data/tt_ft_dataset.py — rgb/{0_,1_}*.png train/test split by
filename prefix, pose/*.txt 4×4 c2w (OpenCV convention), intrinsics.txt,
bbox.txt scene bounds (:342-367), the elliptical render path (:175-196).
Images are read with the port's PNG codec (`utils/png.py`). An image whose
size differs from img_wh is resized with Pillow's LANCZOS filter, as the
JAX package resizes it (`utils/resize.py`).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from ..utils.png import read_png
from ..utils.resize import resize
from . import register_dataset
from .base import BaseDataset, parse_bg_color
from .nerf_synth360_ft import BLENDER2OPENCV, pose_spherical
from .ply import read_ply_points

# per-scene elliptical render-path params (reference: :181-185)
RENDER_PARAMS = {"Ignatius": (1.7, 1.7, -87.0), "Truck": (2.5, 1.5, 91.0),
                 "Caterpillar": (2.2, 2.2, -89.0), "Family": (0.9, 0.9, -91.0),
                 "Barn": (2.5, 2.5, 88.0)}


def read_intrinsics(path: str) -> np.ndarray:
    """intrinsics.txt: a 4×4 / 3×4 matrix, or the DeepVoxels form, whose
    first line is 'f cx cy _' and whose other lines differ in length
    (reference: :197-215). A file of that one line alone raises IndexError,
    as in the JAX package (ROADMAP §3)."""
    try:
        K = np.loadtxt(path).astype(np.float32)
        return K[:3, :3]
    except ValueError:
        with open(path) as f:
            f_, cx, cy, _ = map(float, f.readline().split())
        return np.array([[f_, 0, cx], [0, f_, cy], [0, 0, 1]], np.float32)


@register_dataset("tt_ft")
class TtFtDataset(BaseDataset):

    def initialize(self, opt, split: str = "train"):
        """split train (rgb/0*), render (the 100-pose elliptical path with
        the train cameras and no images) or any other: test (rgb/1*)."""
        self.opt = opt
        self.data_dir = opt.data_root
        self.scan = opt.scan
        self.split = split
        self.img_wh = (int(opt.img_wh[0]), int(opt.img_wh[1]))
        self.width, self.height = self.img_wh
        self.bg_color = parse_bg_color(opt.bg_color)

        scene = os.path.join(self.data_dir, self.scan)
        K = read_intrinsics(os.path.join(scene, "intrinsics.txt"))
        self.focal = float(K[0, 0])

        names = sorted(os.listdir(os.path.join(scene, "rgb")))
        use = [n for n in names
               if n.startswith("0" if split in ("train", "render") else "1")]
        self.image_paths = [os.path.join(scene, "rgb", n) for n in use]
        self.pose_paths = [os.path.join(scene, "pose",
                                        n.rsplit(".", 1)[0] + ".txt")
                           for n in use]
        self.id_list = list(range(len(use)))

        # bbox ranges (reference: :365-367)
        if opt.ranges[0] > -90.0:
            self.spacemin = np.asarray(opt.ranges[:3], np.float32)
            self.spacemax = np.asarray(opt.ranges[3:6], np.float32)
        else:
            mm = np.loadtxt(os.path.join(scene, "bbox.txt")).astype(
                np.float32)[:6]
            self.spacemin, self.spacemax = mm[:3], mm[3:6]

        self.cam2worlds = np.stack(
            [np.loadtxt(p).astype(np.float32).reshape(4, 4)
             for p in self.pose_paths]) if use else \
            np.zeros((0, 4, 4), np.float32)
        self.world2cams = np.stack([np.linalg.inv(c)
                                    for c in self.cam2worlds]) \
            if len(self.cam2worlds) else self.cam2worlds
        self.intrinsics = np.tile(K[None], (max(1, len(use)), 1, 1))
        self.near_far = np.array([opt.near_plane, opt.far_plane], np.float32)

        if split == "render":
            self._build_render_poses()
            self.total = len(self.render_poses)
            return
        self._read_images()
        # the MVS init has no view triplets here (reference: the dataset
        # defines none); load_points 0 fails on it, as in the JAX package
        self.view_id_list = []
        self.total = len(self.id_list)

    def _radius(self, angle_deg, a, b):
        th = (angle_deg - (36 - 180)) * np.pi / 180
        return a * b / np.sqrt(a * a * np.sin(th) ** 2
                               + b * b * np.cos(th) ** 2)

    def _build_render_poses(self, stride: int = 100):
        a, b, phi = RENDER_PARAMS.get(self.scan, (2.0, 2.0, -90.0))
        self.render_poses = np.stack(
            [pose_spherical(ang, phi, self._radius(ang, a, b))
             @ BLENDER2OPENCV
             for ang in np.linspace(-180, 180, stride + 1)[:-1]], 0
        ).astype(np.float32)

    def _read_images(self):
        """RGBA images composite as nerf-synth's; RGB images take an alpha
        from their non-white pixels (reference read_img_path :480-498)."""
        self.render_gtimgs, self.mvsimgs, self.alphas, self.depths = \
            [], [], [], []
        for p in self.image_paths:
            img = read_png(p)
            if img.shape[:2] != (self.height, self.width):
                img = resize(img, self.img_wh, "lanczos")
            arr = img.astype(np.float32) / 255.0
            if arr.ndim == 3 and arr.shape[-1] == 4:
                rgb, a = arr[..., :3], arr[..., 3:4]
            else:
                rgb = arr[..., :3] if arr.ndim == 3 else \
                    np.repeat(arr[..., None], 3, -1)
                a = (np.linalg.norm(1.0 - rgb, axis=-1, keepdims=True)
                     > 1e-4).astype(np.float32)
            self.mvsimgs.append(rgb * a)
            self.render_gtimgs.append(rgb * a + (1.0 - a))
            self.alphas.append(a[..., 0])
            self.depths.append((a[..., 0] > 0.1).astype(np.float32))

    def get_dummyrot_item(self, idx: int,
                          rng: Optional[np.random.RandomState] = None
                          ) -> Dict:
        """Render-path item without GT."""
        rng = rng or np.random.RandomState()
        return self.make_item(None, self.intrinsics[0], self.render_poses[idx],
                              self.opt.near_plane, self.opt.far_plane, rng,
                              idx, full_img=True)

    def get_campos_ray(self):
        """Per-train-view camera centers and center-pixel view dirs."""
        from ..ops.camera import get_dtu_raydir
        center = np.asarray(self.img_wh, np.float32)[None] // 2
        pos, dirs = [], []
        for i in self.id_list:
            c2w = self.cam2worlds[i]
            pos.append(c2w[:3, 3])
            dirs.append(np.asarray(get_dtu_raydir(
                center, self.intrinsics[0], c2w[:3, :3], True))[0])
        return np.stack(pos), np.stack(dirs)

    def load_init_points(self) -> np.ndarray:
        """COLMAP dense points."""
        xyz, _ = read_ply_points(os.path.join(
            self.data_dir, self.scan, "colmap_results/dense/fused.ply"))
        return xyz
