"""ScanNet indoor per-scene finetune dataset (copy of
`pointnerf_tpu/data/scannet_ft.py`, numpy only).

Reference: data/scannet_ft_dataset.py — exported/{color,pose,intrinsic,
depth} layout, pose-validity filtering (:315-321), blur-list removal
(:277-291), NSVF/NPBG train-test splits (:294-313), mesh/pcd init points
(:375-410), sensor-depth back-projected init points (:420-451).

The JAX package reads the files through Pillow and cv2, which the GPU
machine lacks. The port reads the colour JPEGs with its own decoder
(`utils/jpeg.py`, equal to Pillow's decode), resizes them with Pillow's
LANCZOS (`utils/resize.py`) where their size differs from img_wh, reads the
16-bit depth PNGs with its PNG codec (`utils/png.py`, as
`cv2.imread(path, -1)`), and takes cv2's nearest resize, grey conversion
and Laplacian from `utils/cvimg.py`. A grey JPEG raises ValueError, where
the JAX package would keep the first three columns of its one channel
(ROADMAP §3).
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from ..utils.cvimg import bgr2gray, laplacian_var, resize_nearest
from ..utils.jpeg import read_jpeg
from ..utils.png import read_png
from ..utils.resize import resize
from . import register_dataset
from .base import BaseDataset, parse_bg_color
from .ply import read_ply_points


@register_dataset("scannet_ft")
class ScannetFtDataset(BaseDataset):

    def initialize(self, opt, split: str = "train", max_len: int = -1):
        """split train, render (every valid frame, the recorded trajectory)
        or any other: test."""
        self.opt = opt
        self.data_dir = opt.data_root
        self.scan = opt.scan
        self.split = split
        self.img_wh = (int(opt.img_wh[0]), int(opt.img_wh[1]))
        self.width, self.height = self.img_wh
        self.max_len = max_len
        self.bg_color = parse_bg_color(opt.bg_color)
        scene = os.path.join(self.data_dir, self.scan, "exported")
        self.exported = scene

        K = np.loadtxt(os.path.join(scene, "intrinsic",
                                    "intrinsic_color.txt")).astype(np.float32)
        self.base_intrinsic = K[:3, :3]
        dpath = os.path.join(scene, "intrinsic", "intrinsic_depth.txt")
        self.depth_intrinsic = (np.loadtxt(dpath).astype(np.float32)[:3, :3]
                                if os.path.exists(dpath) else
                                self.base_intrinsic)

        colordir = os.path.join(scene, "color")
        n_imgs = len([f for f in os.listdir(colordir)
                      if os.path.isfile(os.path.join(colordir, f))])
        self.all_id_list = self._filter_valid_id(list(range(n_imgs)))

        # split (reference: :300-313)
        if len(self.all_id_list) > 2900:  # neural point-based graphics
            self.test_id_list = self.all_id_list[::100]
            self.train_id_list = [
                self.all_id_list[i] for i in range(len(self.all_id_list))
                if ((i % 100) > 19) and
                ((i % 100) < 81
                 or (i // 100 + 1) * 100 >= len(self.all_id_list))]
        else:  # nsvf
            step = 5
            self.train_id_list = self.all_id_list[::step]
            self.test_id_list = [self.all_id_list[i]
                                 for i in range(len(self.all_id_list))
                                 if (i % step) != 0] \
                if opt.test_num_step != 1 else self.all_id_list
        self.train_id_list = self._remove_blurry(self.train_id_list)
        self.id_list = {"train": self.train_id_list,
                        "render": self.all_id_list}.get(split,
                                                        self.test_id_list)
        self.view_id_list = []

        self.cam2worlds = np.stack([self._load_pose(i)
                                    for i in self.id_list]) \
            if self.id_list else np.zeros((0, 4, 4), np.float32)
        self.world2cams = np.stack([np.linalg.inv(c)
                                    for c in self.cam2worlds]) \
            if len(self.cam2worlds) else self.cam2worlds
        self.intrinsics = np.tile(self.base_intrinsic.copy()[None],
                                  (max(1, len(self.id_list)), 1, 1))
        self.near_far = np.array([opt.near_plane, opt.far_plane], np.float32)
        self._read_images()
        self.total = len(self.id_list)

    def _load_pose(self, idx: int) -> np.ndarray:
        return np.loadtxt(os.path.join(
            self.exported, "pose", f"{idx}.txt")).astype(
                np.float32).reshape(4, 4)

    def _filter_valid_id(self, ids: List[int]) -> List[int]:
        """Drop frames with invalid (inf/huge) poses (reference: :315-321)."""
        out = []
        for i in ids:
            path = os.path.join(self.exported, "pose", f"{i}.txt")
            if not os.path.exists(path):
                continue
            c2w = np.loadtxt(path).astype(np.float32)
            if np.isfinite(c2w).all() and np.max(np.abs(c2w)) < 30:
                out.append(i)
        return out

    def _remove_blurry(self, ids: List[int]) -> List[int]:
        """Drop ids listed in exported/blur_list.txt (reference: :277-291)."""
        path = os.path.join(self.exported, "blur_list.txt")
        if not os.path.exists(path):
            return ids
        with open(path) as f:
            blur = {int(line.strip()) for line in f if line.strip()}
        return [i for i in ids if i not in blur]

    @staticmethod
    def variance_of_laplacian(gray: np.ndarray) -> float:
        """Blur score (reference: :260-263)."""
        return laplacian_var(gray)

    def detect_blurry(self, ids: List[int], worst: int = 150) -> List[int]:
        """The `worst` blurriest frames by Laplacian variance of their grey
        images (reference: :265-276), for authoring blur_list.txt."""
        scores = []
        for i in ids:
            bgr = self._read_color(i)[..., ::-1]
            scores.append(self.variance_of_laplacian(bgr2gray(bgr)))
        order = np.argsort(np.asarray(scores))[:worst]
        return [ids[i] for i in order]

    def _read_color(self, idx: int) -> np.ndarray:
        """color/{idx}.jpg as uint8 RGB [H, W, 3]; a grey JPEG raises."""
        path = os.path.join(self.exported, "color", f"{idx}.jpg")
        img = read_jpeg(path)
        if img.ndim != 3:
            raise ValueError(f"{path}: a grey JPEG; ScanNet colour frames "
                             f"are RGB")
        return img

    def _read_images(self):
        self.render_gtimgs, self.alphas, self.depths = [], [], []
        first = True
        for i in self.id_list:
            img = self._read_color(i)
            if first:
                sh, sw = img.shape[:2]
                K = self.base_intrinsic.copy()
                K[0] *= self.img_wh[0] / sw
                K[1] *= self.img_wh[1] / sh
                self.intrinsics = np.tile(K[None], (len(self.id_list), 1, 1))
                first = False
            if img.shape[1::-1] != self.img_wh:
                img = resize(img, self.img_wh, "lanczos")
            arr = np.asarray(img, np.float32)[..., :3] / 255.0
            self.render_gtimgs.append(arr)
            self.alphas.append(np.ones(arr.shape[:2], np.float32))
            if self.opt.depth_loss_items:
                # sensor depth for supervision: uint16 mm at the depth
                # camera's size, nearest-resized to img_wh; camera-space z
                d = self.read_depth(
                    os.path.join(self.exported, "depth", f"{i}.png"))
                self.depths.append(resize_nearest(d, self.img_wh))
            else:
                self.depths.append(np.ones(arr.shape[:2], np.float32))
        self.has_metric_depth = bool(self.opt.depth_loss_items)

    def read_depth(self, path: str) -> np.ndarray:
        """uint16 mm png -> meters, clipped to [0.3, 8] (reference:
        :412-417)."""
        d = read_png(path).astype(np.float32) / 1000.0
        d[(d > 8.0) | (d < 0.3)] = 0.0
        return d

    def load_init_points(self) -> np.ndarray:
        """Scene mesh/pcd vertices (reference: :394-410)."""
        for cand in (os.path.join(self.exported, "pcd.ply"),
                     os.path.join(self.data_dir, self.scan,
                                  self.scan + "_vh_clean.ply")):
            if os.path.exists(cand):
                xyz, _ = read_ply_points(cand)
                break
        else:
            raise FileNotFoundError("no pcd.ply / _vh_clean.ply found")
        if self.opt.ranges[0] > -99.0:
            r = np.asarray(self.opt.ranges, np.float32)
            keep = np.all((xyz >= r[:3]) & (xyz <= r[3:]), axis=-1)
            xyz = xyz[keep]
        return xyz

    def load_init_depth_points(self, vox_res: int = 0,
                               stats: Dict = None) -> np.ndarray:
        """Every valid frame's sensor depth back-projected to world points,
        per frame centroid-downsampled at `vox_res` when it is > 0, then
        cropped to ranges (reference: :420-451). `stats`, if given,
        receives the frames, the points per frame after the downsample
        (n_frame) and the total before the crop (n_points)."""
        from ..run.common import construct_vox_points_xyz
        inv_K = np.linalg.inv(self.depth_intrinsic)
        pieces = []
        for i in self.all_id_list:
            dpath = os.path.join(self.exported, "depth", f"{i}.png")
            if not os.path.exists(dpath):
                continue
            depth = self.read_depth(dpath)
            H, W = depth.shape
            py, px = np.mgrid[0:H, 0:W].astype(np.float32)
            cam = np.stack([px * depth, py * depth, depth], -1) @ inv_K.T
            cam = cam[depth > 0]
            c2w = self._load_pose(i)
            world = cam @ c2w[:3, :3].T + c2w[:3, 3]
            if vox_res > 0:
                world = construct_vox_points_xyz(world, vox_res)
            pieces.append(world.astype(np.float32))
        xyz = np.concatenate(pieces, axis=0) if pieces else \
            np.zeros((0, 3), np.float32)
        if stats is not None:
            stats.update(frames=len(pieces), n_points=len(xyz),
                         n_frame=[len(p) for p in pieces])
        if self.opt.ranges[0] > -99.0:
            r = np.asarray(self.opt.ranges, np.float32)
            xyz = xyz[np.all((xyz >= r[:3]) & (xyz <= r[3:]), axis=-1)]
        return xyz

    def get_campos_ray(self):
        """Per-frame camera centres and centre-pixel view directions."""
        from ..ops.camera import get_dtu_raydir
        center = np.asarray(self.img_wh, np.float32)[None] // 2
        pos, dirs = [], []
        for i in range(len(self.id_list)):
            c2w = self.cam2worlds[i]
            pos.append(c2w[:3, 3])
            dirs.append(np.asarray(get_dtu_raydir(
                center, self.intrinsics[0], c2w[:3, :3], True))[0])
        return np.stack(pos), np.stack(dirs)

    def get_dummyrot_item(self, idx: int, rng=None) -> Dict:
        """Render-split item along the recorded trajectory (no GT)."""
        rng = rng or np.random.RandomState()
        return self.make_item(None, self.intrinsics[
            min(idx, len(self.intrinsics) - 1)], self.cam2worlds[idx],
            self.opt.near_plane, self.opt.far_plane, rng, idx,
            full_img=True)
