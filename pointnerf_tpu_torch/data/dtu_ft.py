"""DTU per-scene finetune dataset (port of `pointnerf_tpu/data/dtu_ft.py`,
numpy only).

Reference: data/dtu_ft_dataset.py — one scan's MVSNet cam files and
Rectified images (light 3 for the finetune), its PFM depths, the spherical
render poses (:149-190) and the plane-background helpers (:894-934). The
camera and PFM parsing is the port's `dtu.DtuDataset`; images are read
with the port's PNG codec and, where their size differs from img_wh,
resized with `utils/resize.py` (Pillow's BILINEAR, as the JAX package
resizes them).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from . import register_dataset
from .base import BaseDataset, parse_bg_color
from .dtu import DtuDataset
from .fitplane import generate_plane_points, plane_distance
from .nerf_synth360_ft import BLENDER2OPENCV, pose_spherical

# reference get_plane_param (:894-899): the DTU back planes by plane_ind
PLANE_PARAMS = [
    ([-0.49666997, 0.52160616, 3.6239593],
     [-0.11364093, 0.38778102, 0.91471942], [1.0, 1.0, 1.0]),
    ([0.20770223, -0.74818161, 3.98697683],
     [-0.11165793, 0.3806543, 0.91795142],
     [150.72447808 / 255, 99.68367002 / 255, 63.40976961 / 255]),
    ([-0.04889537, -0.84123057, 4.03164617],
     [-0.11154823, 0.3783277, 0.91892608],
     [80.28243032 / 255, 54.3915082 / 255, 35.07029825 / 255]),
]


@register_dataset("dtu_ft")
class DtuFtDataset(BaseDataset):

    def initialize(self, opt, split: str = "train", max_len: int = -1):
        self.opt = opt
        self.data_dir = opt.data_root
        self.scan = opt.scan
        self.split = split
        self.img_wh = (int(opt.img_wh[0]), int(opt.img_wh[1]))
        self.width, self.height = self.img_wh
        self.max_len = max_len
        self.bg_color = parse_bg_color(opt.bg_color)
        self.plane_ind = getattr(opt, "plane_ind", 0)

        # the cameras and PFMs through the generalizable dataset
        self._mvs = DtuDataset()
        self._mvs.initialize(opt, split="train")
        # every test_num_step-th view is held out
        all_ids = list(range(len(self._mvs.id_list)))
        step = max(2, opt.test_num_step)
        test_ids = all_ids[::step]
        train_ids = [i for i in all_ids if i not in test_ids]
        self.ids = train_ids if split in ("train", "render") else test_ids
        self.near_far = self._mvs.near_far

        self.intrinsics = self._mvs.intrinsics[self.ids]
        self.cam2worlds = self._mvs.cam2worlds[self.ids]
        self.world2cams = self._mvs.world2cams[self.ids]
        self._build_init_metas()

        if split == "render":
            self._build_render_poses()
            self.total = len(self.render_poses)
            return
        self._read_images()
        self.total = len(self.ids)

    def _build_init_metas(self):
        """The MVS init's view bundles and the plane index (reference
        build_init_metas :399-436): dtu_configs/dtu_finetune_init_pairs.txt
        ("<num>\\n<ref>\\n<src,src,..>" blocks), else nearest-camera groups
        over the scan's views; plane_ind from
        dtu_configs/lists/dtu_test_ground.txt, else opt.plane_ind."""
        self.view_id_list = []
        pair_path = os.path.join(self.data_dir, "dtu_configs",
                                 "dtu_finetune_init_pairs.txt")
        if os.path.exists(pair_path):
            with open(pair_path) as f:
                num = int(f.readline())
                for _ in range(num):
                    ref = int(f.readline().rstrip())
                    srcs = [int(x) for x in f.readline().rstrip().split(",")]
                    self.view_id_list.append([ref] + srcs)
        else:
            cam_pos = self._mvs.cam2worlds[:, :3, 3]
            n = len(self._mvs.id_list)
            for r in range(0, n, max(1, n // 16)):
                d = np.linalg.norm(cam_pos - cam_pos[r], axis=-1)
                near = [int(self._mvs.id_list[j])
                        for j in np.argsort(d)[1:5]]
                self.view_id_list.append([int(self._mvs.id_list[r])] + near)

        ground = os.path.join(self.data_dir, "dtu_configs", "lists",
                              "dtu_test_ground.txt")
        if os.path.exists(ground):
            with open(ground) as f:
                for line in f:
                    info = line.strip().split()
                    if len(info) >= 2 and info[0] == self.scan:
                        self.plane_ind = int(info[1])
                        break

    def _rect_image(self, vid: int, light: int = 3) -> np.ndarray:
        """The scan's Rectified image of view `vid` as float32 [H, W, 3] in
        [0, 1], at img_wh (reference :213, light 3 for the finetune)."""
        return self._mvs.read_image(os.path.join(
            self.data_dir, f"Rectified/{self.scan}_train/"
            f"rect_{vid + 1:03d}_{light}_r5000.png")).transpose(1, 2, 0)

    def get_init_item(self, idx: int) -> Dict:
        """The MVS bundle of init view group `idx` (reference get_init_item
        :619-679); the generalizable dataset's layout, from this scan's
        light-3 images."""
        view_ids = self.view_id_list[idx][: self.opt.init_view_num]
        m = self._mvs
        imgs, depths_h, affs, intr, w2cs, c2ws, nfs = ([] for _ in range(7))
        for vid in view_ids:
            imgs.append(np.transpose(self._rect_image(vid), (2, 0, 1)))
            dpath = os.path.join(self.data_dir, f"Depths_raw/{self.scan}/"
                                 f"depth_map_{vid:04d}.pfm")
            depths_h.append(m.read_depth(dpath) if os.path.exists(dpath)
                            else np.zeros(self.img_wh[::-1], np.float32))
            ri = m.remap[vid]
            a, nf = m.affines[ri]
            affs.append(a)
            intr.append(m.intrinsics[ri])
            w2cs.append(m.world2cams[ri])
            c2ws.append(m.cam2worlds[ri])
            nfs.append(nf)
        V = len(view_ids)
        inv = [np.linalg.inv(a) for a in affs]
        proj_mats = np.stack([
            np.stack([np.eye(4) if i == j else affs[j] @ inv[i]
                      for j in range(V)])[:, :3] for i in range(V)])
        imgs = np.stack(imgs).astype(np.float32)
        return {
            "images": imgs,
            "mvs_images": imgs,
            "depths_h": np.stack(depths_h).astype(np.float32),
            "w2cs": np.stack(w2cs).astype(np.float32),
            "c2ws": np.stack(c2ws).astype(np.float32),
            "near_fars_depth": np.asarray(nfs[0], np.float32),
            "near_fars": np.tile(np.asarray(nfs[0], np.float32)[None],
                                 (V, 1)),
            "proj_mats": proj_mats.astype(np.float32),
            "intrinsics": np.stack(intr).astype(np.float32),
            "view_ids": np.asarray(view_ids),
            "alphas": np.ones((V,) + self.img_wh[::-1], np.float32),
            "scan": self.scan,
        }

    def _build_render_poses(self, stride: int = 60):
        """The spherical render path around the scan (reference :149-190)."""
        center = self.cam2worlds[:, :3, 3].mean(0)
        radius = float(np.linalg.norm(
            self.cam2worlds[:, :3, 3] - center, axis=-1).mean())
        self.render_poses = np.stack(
            [pose_spherical(a, -30.0, radius) @ BLENDER2OPENCV
             for a in np.linspace(-180, 180, stride + 1)[:-1]], 0
        ).astype(np.float32)

    def _read_images(self):
        self.render_gtimgs, self.alphas = [], []
        for i in self.ids:
            arr = self._rect_image(int(self._mvs.id_list[i]))
            self.render_gtimgs.append(arr)
            self.alphas.append(np.ones(arr.shape[:2], np.float32))

    def _attach_plane(self, item: Dict) -> Dict:
        """The plane's point, normal and colour ride with every item
        (reference :732-735)."""
        pnt, normal, color = self.get_plane_param()
        item["plane_pnt"] = np.asarray(pnt, np.float32)
        item["plane_normal"] = np.asarray(normal, np.float32)
        item["plane_color"] = np.asarray(color, np.float32)
        return item

    def get_item(self, idx: int, rng=None, full_img: bool = False) -> Dict:
        rng = rng or np.random.RandomState()
        nf = self._mvs.affines[self.ids[idx]][1]
        return self._attach_plane(
            self.make_item(self.render_gtimgs[idx], self.intrinsics[idx],
                           self.cam2worlds[idx], nf[0], nf[1], rng, idx,
                           full_img=full_img))

    def get_dummyrot_item(self, idx: int, rng=None) -> Dict:
        rng = rng or np.random.RandomState()
        nf = self._mvs.affines[self.ids[0]][1]
        return self._attach_plane(
            self.make_item(None, self.intrinsics[0], self.render_poses[idx],
                           nf[0], nf[1], rng, idx, full_img=True))

    def get_campos_ray(self):
        """Per-view camera centers and center-pixel ray directions, for the
        nearest-view direction init."""
        from ..ops.camera import get_dtu_raydir
        center = np.asarray(self.img_wh, np.float32)[None] // 2
        pos, dirs = [], []
        for i in range(len(self.ids)):
            c2w = self.cam2worlds[i]
            pos.append(c2w[:3, 3])
            dirs.append(np.asarray(get_dtu_raydir(
                center, self.intrinsics[0], c2w[:3, :3], True))[0])
        return np.stack(pos), np.stack(dirs)

    def load_init_points(self) -> np.ndarray:
        """The split's PFM depths back-projected to world points."""
        pieces = []
        for i in self.ids:
            vid = int(self._mvs.id_list[i])
            dpath = os.path.join(self.data_dir, f"Depths_raw/{self.scan}/"
                                 f"depth_map_{vid:04d}.pfm")
            if not os.path.exists(dpath):
                continue
            depth = self._mvs.read_depth(dpath)
            H, W = depth.shape
            K = self._mvs.intrinsics[i]
            py, px = np.mgrid[0:H, 0:W].astype(np.float32)
            cam = np.stack([(px - K[0, 2]) / K[0, 0] * depth,
                            (py - K[1, 2]) / K[1, 1] * depth, depth], -1)
            cam = cam[depth > 0]
            c2w = self._mvs.cam2worlds[i]
            pieces.append((cam @ c2w[:3, :3].T + c2w[:3, 3]).astype(
                np.float32))
        return np.concatenate(pieces, 0) if pieces else \
            np.zeros((0, 3), np.float32)

    # ------------------------------------------------------------- plane bg
    def get_plane_param(self, ind: Optional[int] = None):
        """(plane point, normal, colour) (reference :894-899); an index past
        PLANE_PARAMS raises IndexError."""
        return PLANE_PARAMS[self.plane_ind if ind is None else ind]

    def get_plane_param_points(self, rng=None):
        """The background plane's points and their attributes (reference
        :902-924), drawn from `rng` (RandomState(opt.seed) when None)."""
        rng = rng or np.random.RandomState(self.opt.seed)
        plane_pnt, plane_normal, _ = self.get_plane_param()
        xyz = generate_plane_points(plane_pnt, plane_normal, 10.0, 8000, rng)
        n = len(xyz)
        emb = rng.rand(n, self.opt.point_features_dim).astype(np.float32)
        dirs = rng.rand(n, 3).astype(np.float32)
        dirs /= np.maximum(np.linalg.norm(dirs, axis=-1, keepdims=True), 1e-6)
        color = np.zeros((n, 3), np.float32)
        conf = np.full((n, 1), 0.3, np.float32)
        return xyz, emb, dirs, color, conf

    def filter_plane(self, add_xyz: np.ndarray) -> np.ndarray:
        """True for grow candidates within 0.2 of the background plane
        (reference :927-934), which the grow rejects."""
        plane_pnt, plane_normal, _ = self.get_plane_param()
        return plane_distance(np.asarray(add_xyz), plane_pnt,
                              plane_normal) < 0.2
