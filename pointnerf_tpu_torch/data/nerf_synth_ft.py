"""NeRF-Synthetic legacy (non-360) per-scene finetune dataset (copy of
`pointnerf_tpu/data/nerf_synth_ft.py`, numpy and torch.load only).

Reference: data/nerf_synth_ft_dataset.py. Against the 360 variant it
subclasses:

* every split reads transforms_train.json: test and val ids index TRAIN
  frames, taken from a pairs table (reference :115-117, :295-296);
* the MVS init's view groups come from a curated pairs file
  (`{scan}_finetune_init_pairs_final.txt`, MVSNet's list format,
  reference :278-293), not from the cameras' hull;
* every item's near/far is the fixed blender range [2, 6] (reference
  :305, :497-498), not the CLI planes;
* the render path's rays follow the blender focal convention
  (`get_blender_raydir`, reference :643), with near/far from the camera's
  distance when the CLI planes are unset (reference :590-604);
* `--normview 1` re-expresses every pose in the first test camera's frame
  (reference :119-126, :236-256).

The files are found under data_root: `nerf_synth_configs/list/
{scan}_finetune_init_pairs_final.txt` and `dtu_configs/pairs.th` (a
torch-saved dict, `{scan}_{split}` → id list). Without either, the dataset
falls back to the 360 variant's rules (every train frame, hull triplets,
testskip), as the JAX package's does.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ops.camera import get_blender_raydir
from . import register_dataset
from .base import parse_bg_color
from .nerf_synth360_ft import (BLENDER2OPENCV, NerfSynth360FtDataset,
                               hull_view_triplets)

LEGACY_NEAR_FAR = np.array([2.0, 6.0], np.float32)  # reference :305


def load_pairs_txt(path: str) -> Tuple[List[List[int]], int]:
    """MVSNet-style pairs list (reference nerf_synth_ft_dataset.py:278-293):
    a `num_viewpoint,num_pairs` header, then per entry a ref-view line and
    a comma-separated src-view line. Entries past num_viewpoint add view
    groups without adding train ids. Returns (groups, num_viewpoint)."""
    groups = []
    with open(path) as f:
        num_lst = f.readline().rstrip().split(",")
        num_viewpoint, num_pairs = int(num_lst[0]), int(num_lst[1])
        for _ in range(max(num_viewpoint, num_pairs)):
            ref_line = f.readline().rstrip()
            if not ref_line:
                break
            src_views = [int(x) for x in f.readline().rstrip().split(",")]
            groups.append([int(ref_line)] + src_views)
    return groups, num_viewpoint


def load_pairs_th(path: str) -> Dict:
    """The split table: a dict of id lists, read with weights_only (which
    refuses anything but tensors and plain Python containers)."""
    import torch
    return torch.load(path, weights_only=True)


@register_dataset("nerf_synth_ft")
class NerfSynthFtDataset(NerfSynth360FtDataset):

    def initialize(self, opt, split: str = "train"):
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
        # every split reads the TRAIN transforms (reference :115-117)
        with open(os.path.join(self.data_dir, self.scan,
                               "transforms_train.json")) as f:
            self.meta = json.load(f)
        focal = 0.5 * 800 / np.tan(0.5 * self.meta["camera_angle_x"])
        self.focal = focal * w / 800.0
        self.near_far = LEGACY_NEAR_FAR.copy()

        self._build_id_lists()
        norm_w2c = self._norm_w2c() if opt.normview > 0 else None
        self.intrinsics, self.cam2worlds, self.world2cams = \
            self._build_mats(norm_w2c)
        if split == "render":
            self._build_render_poses()
            self.total = len(self.render_poses)
            return
        self._read_images()
        if not self.view_id_list and split == "train":
            self.view_id_list = hull_view_triplets(
                self.cam2worlds[:, :3, 3], full_comb=opt.full_comb > 0)
        self.total = len(self.id_list)

    def _pairs_txt_path(self) -> str:
        return os.path.join(self.data_dir, "nerf_synth_configs", "list",
                            f"{self.scan}_finetune_init_pairs_final.txt")

    def _pairs_th_path(self) -> str:
        return os.path.join(self.data_dir, "dtu_configs", "pairs.th")

    def _build_id_lists(self):
        """id_list and view_id_list per split (reference :274-296)."""
        self.view_id_list = []
        every = list(range(len(self.meta["frames"])))
        if self.split in ("train", "render"):
            pairs_path = self._pairs_txt_path()
            if os.path.exists(pairs_path):
                groups, num_viewpoint = load_pairs_txt(pairs_path)
                self.id_list = [g[0] for g in groups[:num_viewpoint]]
                # frame ids → positions in id_list (the reference's
                # view_id_dict, :345, :370); src views must be ref views
                pos = {fid: i for i, fid in enumerate(self.id_list)}
                try:
                    self.view_id_list = [[pos[v] for v in g] for g in groups]
                except KeyError as e:
                    raise ValueError(
                        f"pairs file {pairs_path}: src view {e} is not one of "
                        f"the {len(self.id_list)} ref views") from None
            else:
                self.id_list = every[::max(1, self.opt.trainskip)]
        else:   # test / val ids index TRAIN frames (reference :296)
            th_path = self._pairs_th_path()
            if os.path.exists(th_path):
                self.id_list = [int(i) for i in load_pairs_th(th_path)[
                    f"{self.scan}_{self.split}"]]
            else:
                self.id_list = every[::max(1, self.opt.testskip)]
        self.test_id_list = self.id_list

    def _norm_w2c(self) -> np.ndarray:
        """--normview: the first test camera's w2c (reference normalize_cam
        :236-256), frame 0's without a pairs table."""
        th_path = self._pairs_th_path()
        first = int(load_pairs_th(th_path)[f"{self.scan}_test"][0]) \
            if os.path.exists(th_path) else 0
        c2w = np.array(self.meta["frames"][first]["transform_matrix"],
                       np.float64) @ BLENDER2OPENCV
        return np.linalg.inv(c2w)

    def _build_mats(self, norm_w2c: Optional[np.ndarray] = None):
        K = np.array([[self.focal, 0, self.width / 2],
                      [0, self.focal, self.height / 2],
                      [0, 0, 1]], dtype=np.float32)
        intrinsics, c2ws, w2cs = [], [], []
        for vid in self.id_list:
            c2w = np.array(self.meta["frames"][vid]["transform_matrix"],
                           np.float64) @ BLENDER2OPENCV
            if norm_w2c is not None:            # reference :309-310
                c2w = norm_w2c @ c2w
            c2ws.append(c2w.astype(np.float32))
            w2cs.append(np.linalg.inv(c2w).astype(np.float32))
            intrinsics.append(K.copy())
        return np.stack(intrinsics), np.stack(c2ws), np.stack(w2cs)

    def get_dummyrot_item(self, idx: int,
                          rng: Optional[np.random.RandomState] = None
                          ) -> Dict:
        """Render-path item: blender focal ray directions, near/far from
        the camera's distance unless the CLI planes are set (reference
        :575-663)."""
        rng = rng or np.random.RandomState()
        pose = self.render_poses[idx]
        dist = float(np.linalg.norm(pose[:3, 3]))
        near = self.opt.near_plane if self.opt.near_plane > 0 \
            else max(dist - 1.5, 0.02)
        far = self.opt.far_plane if self.opt.far_plane > 0 else dist + 0.7
        item = self.make_item(None, self.intrinsics[0], pose, near, far,
                              rng, idx, full_img=True)
        raydir = get_blender_raydir(
            item["pixel_idx"].reshape(-1, 2), self.height, self.width,
            self.focal, pose[:3, :3].astype(np.float32),
            self.opt.dir_norm > 0)
        item["raydir"] = np.asarray(raydir, np.float32).reshape(1, -1, 3)
        return item
