"""DTU multi-view dataset for generalizable training and feed-forward
inference (port of `pointnerf_tpu/data/dtu.py`, numpy only).

Reference: data/dtu_dataset.py — pair-file metas (scan, light, ref, srcs)
(:190-213), MVSNet cam files (:240-254: extrinsic rows 1-4, intrinsic rows
7-9 at 1/4 scale, depth min and interval on row 11), the 1/200 world scale,
PFM depths (:269-280), the per-item MVS bundle and target-view rays
(:299-488).

The GPU machine has neither cv2 nor Pillow. The depth chain's two
`cv2.resize(INTER_NEAREST)` calls become numpy indexing with cv2's source
index (`utils/cvimg.resize_nearest`), and the images are read with the
port's PNG codec. An image whose size differs from img_wh is resized with
Pillow's BILINEAR filter, as the JAX package resizes it
(`utils/resize.py`, equal to Pillow uint8 for uint8).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from . import register_dataset
from .base import BaseDataset, parse_bg_color
from .pfm import read_pfm
from ..utils.cvimg import resize_nearest as resize_nearest_cv2
from ..utils.png import read_png
from ..utils.resize import resize


def read_rgb(path: str) -> np.ndarray:
    """An 8-bit PNG as uint8 RGB [H, W, 3]: gray is repeated, alpha dropped
    (Pillow's convert("RGB"))."""
    img = read_png(path)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] in (1, 2):
        img = np.repeat(img[..., :1], 3, axis=-1)
    return img[..., :3]


@register_dataset("dtu")
class DtuDataset(BaseDataset):

    def initialize(self, opt, split: str = "train", max_len: int = -1,
                   n_views: int = 3):
        self.opt = opt
        self.data_dir = opt.data_root
        self.split = split
        self.n_views = n_views
        self.max_len = max_len
        self.scale_factor = 1.0 / 200
        self.img_wh = (int(opt.img_wh[0]), int(opt.img_wh[1]))
        self.width, self.height = self.img_wh
        if self.img_wh[0] % 32 or self.img_wh[1] % 32:
            raise ValueError("img_wh must be multiples of 32 (MVSNet's "
                             "U-Net)")
        self.bg_color = parse_bg_color(opt.bg_color)
        self.near_far = np.asarray([2.125, 4.525], np.float32)
        self._rng = np.random.RandomState(opt.seed)
        self._build_metas()
        self._build_proj_mats()
        self.total = len(self.metas) if max_len <= 0 else max_len

    # ------------------------------------------------------------------ metas
    def _build_metas(self):
        """reference :190-213. Config files live in data_root/dtu_configs."""
        cfg = os.path.join(self.data_dir, "dtu_configs")
        list_path = os.path.join(cfg, "lists", f"dtu_{self.split}_all.txt")
        with open(list_path) as f:
            self.scans = [line.rstrip() for line in f if line.strip()]
        light_idxs = range(7) if self.split == "train" else [3]
        self.metas, id_list = [], []
        with open(os.path.join(cfg, "dtu_pairs.txt")) as f:
            lines = [line.rstrip() for line in f]
        pairs = []
        for i in range(int(lines[0])):
            ref = int(lines[1 + 2 * i])
            srcs = [int(x) for x in lines[2 + 2 * i].split()[1::2]]
            pairs.append((ref, srcs))
        for scan in self.scans:
            for ref, srcs in pairs:
                for light in light_idxs:
                    self.metas.append((scan, light, ref, srcs))
                    id_list.append([ref] + srcs)
        self.id_list = np.unique(np.asarray(id_list))
        self.remap = np.zeros(self.id_list.max() + 1, dtype=np.int64)
        for i, v in enumerate(self.id_list):
            self.remap[v] = i

    def read_cam_file(self, path: str):
        """MVSNet cam txt (reference :240-254)."""
        with open(path) as f:
            lines = [line.rstrip() for line in f.readlines()]
        extrinsic = np.array(" ".join(lines[1:5]).split(),
                             np.float32).reshape(4, 4)
        intrinsic = np.array(" ".join(lines[7:10]).split(),
                             np.float32).reshape(3, 3)
        depth_min = float(lines[11].split()[0]) * self.scale_factor
        depth_interval = float(lines[11].split()[1])
        depth_max = depth_min + depth_interval * 192 * self.scale_factor * 1.06
        return intrinsic, extrinsic, [depth_min, depth_max]

    def _build_proj_mats(self):
        """reference :215-237: cam intrinsics are stored at 1/4 scale."""
        affines, intrinsics, w2cs, c2ws = [], [], [], []
        for vid in self.id_list:
            path = os.path.join(self.data_dir,
                                f"Cameras/train/{vid:08d}_cam.txt")
            intrinsic, extrinsic, near_far = self.read_cam_file(path)
            intrinsic = intrinsic.copy()
            intrinsic[:2] *= 4
            extrinsic = extrinsic.copy()
            extrinsic[:3, 3] *= self.scale_factor
            intrinsics.append(intrinsic.copy())
            a = np.eye(4)
            k4 = intrinsic.copy()
            k4[:2] /= 4
            a[:3, :4] = k4 @ extrinsic[:3, :4]
            affines.append((a, near_far))
            w2cs.append(extrinsic)
            c2ws.append(np.linalg.inv(extrinsic))
        self.affines = affines
        self.intrinsics = np.stack(intrinsics)
        self.world2cams = np.stack(w2cs)
        self.cam2worlds = np.stack(c2ws)

    def read_depth(self, path: str):
        """PFM → depth at img_wh in world units (reference :269-280): a
        nearest halving, the crop [44:556, 80:720], then a nearest resize
        to img_wh where the crop differs from it."""
        depth = np.asarray(read_pfm(path)[0], np.float32)
        H, W = depth.shape
        depth = resize_nearest_cv2(depth, (int(round(W * 0.5)),
                                           int(round(H * 0.5))), (2.0, 2.0))
        depth = depth[44:556, 80:720]
        if depth.shape[::-1] != self.img_wh:
            depth = resize_nearest_cv2(depth, self.img_wh)
        return depth * self.scale_factor

    def read_image(self, path: str) -> np.ndarray:
        """[3, H, W] float32 in [0, 1] at img_wh (Pillow's BILINEAR resize
        of the RGB image where its size differs)."""
        img = read_rgb(path)
        if img.shape[1::-1] != self.img_wh:
            img = resize(img, self.img_wh, "bilinear")
        return np.transpose(np.asarray(img, np.float32) / 255.0, (2, 0, 1))

    # ------------------------------------------------------------------ items
    def get_init_item(self, idx: int) -> Dict:
        """MVS bundle: src views + target (reference __getitem__ :299-390).
        Train items pick their source views with the dataset's own
        RandomState, as the JAX package does."""
        scan, light, target, srcs = self.metas[idx]
        if self.split == "train":
            picks = self._rng.permutation(min(5, len(srcs)))[: self.n_views]
            view_ids = [srcs[i] for i in picks] + [target]
        else:
            view_ids = srcs[: self.n_views] + [target]

        imgs, depths_h, affs, intr, w2cs, c2ws, nfs = ([] for _ in range(7))
        for vid in view_ids:
            imgs.append(self.read_image(os.path.join(
                self.data_dir, f"Rectified/{scan}_train/"
                f"rect_{vid + 1:03d}_{light}_r5000.png")))
            dpath = os.path.join(self.data_dir,
                                 f"Depths_raw/{scan}/depth_map_{vid:04d}.pfm")
            depths_h.append(self.read_depth(dpath) if os.path.exists(dpath)
                            else np.zeros(self.img_wh[::-1], np.float32))
            ri = self.remap[vid]
            a, nf = self.affines[ri]
            affs.append(a)
            intr.append(self.intrinsics[ri])
            w2cs.append(self.world2cams[ri])
            c2ws.append(self.cam2worlds[ri])
            nfs.append(nf)

        V = len(view_ids)
        inv = [np.linalg.inv(a) for a in affs]
        proj_mats = np.stack([
            np.stack([np.eye(4) if i == j else affs[j] @ inv[i]
                      for j in range(V)])[:, :3] for i in range(V)])
        return {
            "images": np.stack(imgs).astype(np.float32),
            "mvs_images": np.stack(imgs).astype(np.float32),
            "depths_h": np.stack(depths_h).astype(np.float32),
            "w2cs": np.stack(w2cs).astype(np.float32),
            "c2ws": np.stack(c2ws).astype(np.float32),
            "near_fars_depth": np.asarray(nfs[0], np.float32),
            "near_fars": np.tile(self.near_far[None], (V, 1)),
            "proj_mats": proj_mats.astype(np.float32),
            "intrinsics": np.stack(intr).astype(np.float32),
            "view_ids": np.asarray(view_ids),
            "scan": scan,
        }

    def get_item(self, idx: int, rng: Optional[np.random.RandomState] = None,
                 full_img: bool = False) -> Dict:
        """MVS bundle (under "mvs_sample") + the target view's ray item, in
        the world frame (reference :398-405 re-bases on the ref camera, a
        rigid transform of the same scene)."""
        rng = rng or self._rng
        sample = self.get_init_item(idx)
        trgt = self.opt.trgt_id
        gt = np.transpose(sample["images"][trgt], (1, 2, 0))
        nf = sample["near_fars_depth"]
        item = self.make_item(gt, sample["intrinsics"][trgt],
                              sample["c2ws"][trgt], nf[0], nf[1], rng, idx,
                              full_img=full_img)
        item["mvs_sample"] = sample
        return item

    def __len__(self):
        return self.total
