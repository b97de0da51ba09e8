"""LLFF forward-facing dataset (copy of `pointnerf_tpu/data/llff_ft.py`,
numpy only).

Reference: data/llff_ft_dataset.py — poses_bounds.npy rows (a 3x5 pose
with height, width and focal, then the depth bounds), the LLFF → OpenGL
axis fix, pose centering and the near·0.75 scale normalisation
(:321-360), images from images_4/ (else images/), every holdoff-th view
held out for test (holdoff = max(2, testskip)).

Images are read with the port's own codecs, PNG (`utils/png.py`) and
baseline JPEG (`utils/jpeg.py`), and converted as Pillow's
`.convert("RGB")` converts them: grey is replicated, an alpha channel is
dropped without compositing. An image whose size differs from img_wh is
resampled with Pillow's LANCZOS (`utils/resize.py`), as the JAX package
resamples it. Any other file raises ValueError.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from ..ops.camera import get_dtu_raydir
from ..utils.jpeg import read_jpeg
from ..utils.png import read_png
from ..utils.resize import resize
from . import register_dataset
from .base import BaseDataset, parse_bg_color
from .nerf_synth360_ft import BLENDER2OPENCV
from .ply import read_ply_points


def normalize(v):
    return v / np.linalg.norm(v)


def average_pose(poses: np.ndarray) -> np.ndarray:
    """[N,3,4] c2w → the average 3x4 (centre, forward, up; LLFF's)."""
    center = poses[..., 3].mean(0)
    z = normalize(poses[..., 2].sum(0))
    y_ = poses[..., 1].sum(0)
    x = normalize(np.cross(y_, z))
    y = np.cross(z, x)
    return np.stack([x, y, z, center], 1)


def center_poses(poses: np.ndarray):
    """Recenter so that the average pose is the identity; returns
    ([N,3,4], the average as 4x4)."""
    avg = average_pose(poses)
    avg_h = np.eye(4)
    avg_h[:3] = avg
    last = np.tile(np.array([0, 0, 0, 1.0]), (len(poses), 1, 1))
    poses_h = np.concatenate([poses, last], 1)
    centered = np.linalg.inv(avg_h) @ poses_h
    return centered[:, :3], avg_h


def gen_render_path(c2ws: np.ndarray, n_views: int = 30) -> np.ndarray:
    """Euler-interpolated fly-through over the given poses (reference
    utils/util.py:34-64): per segment, xyz Euler angles and positions
    interpolated linearly, angles unwrapped by 360° against the first
    pose, the loop closed back to pose 0. [N,4,4] → [N·(n_views//3),4,4]
    float32."""
    from scipy.spatial.transform import Rotation as R
    N = len(c2ws)
    weight = np.linspace(1.0, 0.0, n_views // 3, endpoint=False).reshape(-1, 1)
    rotvec, positions = [], []
    rot_interp, pos_interp = [], []
    for i in range(N):
        euler = R.from_matrix(
            c2ws[i, :3, :3]).as_euler("xyz", degrees=True).reshape(1, 3)
        if i:
            mask = np.abs(euler - rotvec[0]) > 180
            euler[mask] += 360.0
        rotvec.append(euler)
        positions.append(c2ws[i, :3, 3:].reshape(1, 3))
        if i:
            rot_interp.append(weight * rotvec[i - 1] + (1 - weight) * rotvec[i])
            pos_interp.append(
                weight * positions[i - 1] + (1 - weight) * positions[i])
    rot_interp.append(weight * rotvec[-1] + (1 - weight) * rotvec[0])
    pos_interp.append(weight * positions[-1] + (1 - weight) * positions[0])
    out = []
    for ang, pos in zip(np.concatenate(rot_interp), np.concatenate(pos_interp)):
        c2w = np.eye(4)
        c2w[:3, :3] = R.from_euler("xyz", ang, degrees=True).as_matrix()
        c2w[:3, 3] = pos
        out.append(c2w)
    return np.stack(out).astype(np.float32)


def read_rgb(path: str) -> np.ndarray:
    """An 8-bit PNG or a baseline JPEG as uint8 [H, W, 3], as Pillow's
    `Image.open(path).convert("RGB")` gives it: grey (and grey + alpha)
    replicated, alpha dropped. Other files raise ValueError."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head[:2] == b"\xff\xd8":
        img = read_jpeg(path)
    elif head == b"\x89PNG\r\n\x1a\n":
        img = read_png(path)
        if img.dtype != np.uint8:
            raise ValueError(f"{path}: a 16-bit PNG is not an RGB image")
    else:
        raise ValueError(f"{path}: neither PNG nor JPEG")
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] in (1, 2):
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


@register_dataset("llff_ft")
class LlffFtDataset(BaseDataset):

    def initialize(self, opt, split: str = "train"):
        """split train, test or render (the fly-through over the train
        cameras, no images)."""
        self.opt = opt
        self.data_dir = opt.data_root
        self.scan = opt.scan
        self.split = split
        self.img_wh = (int(opt.img_wh[0]), int(opt.img_wh[1]))
        self.width, self.height = self.img_wh
        self.bg_color = parse_bg_color(opt.bg_color)

        pb = np.load(os.path.join(self.data_dir, self.scan, "poses_bounds.npy"))
        poses = pb[:, :15].reshape(-1, 3, 5)
        bounds = pb[:, -2:]
        H, W, focal = poses[0, :, -1]
        self.focal = [focal * self.img_wh[0] / W, focal * self.img_wh[1] / H]

        # LLFF [down right back] → [right up back], centre, scale by
        # near·0.75, then blender → opencv (reference :328-339)
        poses = np.concatenate(
            [poses[..., 1:2], -poses[..., :1], poses[..., 2:4]], -1)
        poses, _ = center_poses(poses)
        scale = bounds.min() * 0.75
        bounds = bounds / scale
        poses[..., 3] /= scale

        self.all_id_list = list(range(len(poses)))
        self.near_far = np.array([bounds.min() * 0.8, bounds.max() * 1.2],
                                 np.float32)
        K = np.array([[self.focal[0], 0, self.width / 2],
                      [0, self.focal[1], self.height / 2],
                      [0, 0, 1]], np.float32)
        c2ws = []
        for vid in self.all_id_list:
            c2w = np.eye(4)
            c2w[:3] = poses[vid]
            c2ws.append((c2w @ BLENDER2OPENCV).astype(np.float32))
        self.all_c2ws = np.stack(c2ws)

        holdoff = max(2, getattr(opt, "testskip", 8))
        test_ids = self.all_id_list[::holdoff]
        train_ids = [i for i in self.all_id_list if i not in test_ids]
        self.id_list = train_ids if split in ("train", "render") else test_ids
        self.cam2worlds = self.all_c2ws[self.id_list]
        self.world2cams = np.stack([np.linalg.inv(c) for c in self.cam2worlds])
        self.intrinsics = np.tile(K[None], (len(self.id_list), 1, 1))
        self.view_id_list = []

        if split == "render":
            self.render_poses = gen_render_path(self.cam2worlds, n_views=30)
            self.total = len(self.render_poses)
            return
        self._read_images()
        self.total = len(self.id_list)

    def get_dummyrot_item(self, idx: int, rng=None):
        """Render-path item without GT, for run/render_vid."""
        rng = rng or np.random.RandomState()
        return self.make_item(None, self.intrinsics[0], self.render_poses[idx],
                              float(self.near_far[0]), float(self.near_far[1]),
                              rng, idx, full_img=True)

    def _read_images(self):
        scene = os.path.join(self.data_dir, self.scan)
        paths = sorted(glob.glob(os.path.join(scene, "images_4/*")))
        if not paths:
            paths = sorted(glob.glob(os.path.join(scene, "images/*")))
        self.render_gtimgs, self.alphas = [], []
        for i in self.id_list:
            img = read_rgb(paths[i])
            if img.shape[:2] != (self.height, self.width):
                img = resize(img, self.img_wh, "lanczos")
            arr = img.astype(np.float32) / 255.0
            self.render_gtimgs.append(arr)
            self.alphas.append(np.ones(arr.shape[:2], np.float32))

    def get_campos_ray(self):
        """Train camera centres and centre-pixel view directions, for the
        nearest-view direction init."""
        center = np.asarray(self.img_wh, np.float32)[None] // 2
        pos, dirs = [], []
        for i in range(len(self.id_list)):
            c2w = self.cam2worlds[i]
            pos.append(c2w[:3, 3])
            dirs.append(np.asarray(get_dtu_raydir(
                center, self.intrinsics[0], c2w[:3, :3], True))[0])
        return np.stack(pos), np.stack(dirs)

    def load_init_points(self) -> np.ndarray:
        """COLMAP's dense points, colmap_results/dense/fused.ply."""
        xyz, _ = read_ply_points(os.path.join(
            self.data_dir, self.scan, "colmap_results/dense/fused.ply"))
        return xyz
