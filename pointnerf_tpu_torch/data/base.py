"""Shared dataset machinery: bg color, pixel sampling, ray-item assembly
(copy of `pointnerf_tpu/data/base.py`, numpy only).

Reference: data/base_dataset.py and the per-dataset __getitem__ bodies
(e.g. nerf_synth360_ft_dataset.py:557-646), which repeat the same
patch/random/random2/no_crop pixel sampling and item packing. Items are
numpy [1, ...] host arrays.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..ops.camera import get_dtu_raydir


def parse_bg_color(bg: str):
    """reference: nerf_synth360_ft_dataset.py:136-143."""
    if not bg or bg == "black":
        return (0.0, 0.0, 0.0)
    if bg == "white":
        return (1.0, 1.0, 1.0)
    if bg == "random":
        return "random"
    return tuple(float(x) for x in bg.split(","))


def sample_pixels(random_sample: str, size: int, width: int, height: int,
                  rng: np.random.RandomState) -> np.ndarray:
    """pixelcoords [S,S,2] float32 (px, py) per sampling mode
    (reference: nerf_synth360_ft_dataset.py:597-625)."""
    if random_sample == "patch":
        indx = rng.randint(0, width - size + 1)
        indy = rng.randint(0, height - size + 1)
        px, py = np.meshgrid(np.arange(indx, indx + size, dtype=np.float32),
                             np.arange(indy, indy + size, dtype=np.float32))
    elif random_sample == "random":
        px = rng.randint(0, width, (size, size)).astype(np.float32)
        py = rng.randint(0, height, (size, size)).astype(np.float32)
    elif random_sample == "random2":
        px = rng.uniform(0, width - 1e-5, (size, size)).astype(np.float32)
        py = rng.uniform(0, height - 1e-5, (size, size)).astype(np.float32)
    else:  # no_crop / none: full image
        px, py = np.meshgrid(np.arange(width, dtype=np.float32),
                             np.arange(height, dtype=np.float32))
    return np.stack((px, py), axis=-1)


class BaseDataset:
    """Common item assembly. Subclasses set: img_wh, intrinsics [V,3,3],
    cam2worlds [V,4,4], render_gtimgs (float [H,W,3]), near_far, opt."""

    opt = None
    bg_color = (1.0, 1.0, 1.0)

    def initialize(self, opt, split: str = "train"):
        raise NotImplementedError

    def name(self):
        return type(self).__name__

    def __len__(self):
        return self.total

    def _resolve_bg(self, rng: np.random.RandomState):
        if self.bg_color == "random":
            return np.array([1.0, 1.0, 1.0], np.float32) if rng.rand() > 0.5 \
                else np.array([0.0, 0.0, 0.0], np.float32)
        return np.asarray(self.bg_color, np.float32)

    def make_item(self, gt_image: Optional[np.ndarray], intrinsic: np.ndarray,
                  c2w: np.ndarray, near: float, far: float,
                  rng: np.random.RandomState, idx: int,
                  full_img: bool = False) -> Dict:
        """One camera's ray batch (reference __getitem__ + get_item
        unsqueeze, nerf_synth360_ft_dataset.py:557-665)."""
        opt = self.opt
        width, height = self.img_wh
        camrot = c2w[:3, :3].astype(np.float32)
        campos = c2w[:3, 3].astype(np.float32)

        mode = "" if full_img else opt.random_sample
        pixelcoords = sample_pixels(mode, opt.random_sample_size, width,
                                    height, rng)
        raydir = np.asarray(
            get_dtu_raydir(pixelcoords.reshape(-1, 2),
                           intrinsic.astype(np.float32), camrot,
                           opt.dir_norm > 0), np.float32)

        item = {
            "campos": campos[None],
            "camrotc2w": camrot[None],
            "intrinsic": intrinsic.astype(np.float32)[None],
            "raydir": raydir.reshape(1, -1, 3),
            "pixel_idx": pixelcoords.reshape(1, -1, 2),
            "near": np.float32(near),
            "far": np.float32(far),
            "h": height, "w": width,
            "id": idx,
            "bg_color": self._resolve_bg(rng)[None],
        }
        if gt_image is not None:
            py = pixelcoords[..., 1].astype(np.int32).reshape(-1)
            px = pixelcoords[..., 0].astype(np.int32).reshape(-1)
            item["gt_image"] = gt_image[py, px].reshape(1, -1, 3).astype(
                np.float32)
            # per-ray masks only when a loss reads them, as the JAX package
            # (reference base_rendering_model.py:610-627)
            if opt.depth_loss_items or opt.bg_loss_items:
                a = getattr(self, "alphas", None)
                item["gt_mask"] = (
                    a[idx][py, px].reshape(1, -1) > 0.5
                    if a else np.ones((1, py.size), bool)).astype(np.float32)
            if opt.depth_loss_items:
                # gt_depth is camera-space z; datasets must declare metric
                # depth (mask-valued depths would be silent nonsense)
                d = getattr(self, "depths", None)
                if d is None or not getattr(self, "has_metric_depth", False):
                    raise ValueError(
                        f"--depth_loss_items needs metric per-view depth "
                        f"maps; dataset {self.name()} provides "
                        f"{'mask/placeholder depths' if d is not None else 'none'}")
                item["gt_depth"] = d[idx][py, px].reshape(1, -1).astype(
                    np.float32)
        return item

    def get_item(self, idx: int, rng: Optional[np.random.RandomState] = None,
                 full_img: bool = False) -> Dict:
        rng = rng or np.random.RandomState()
        return self.make_item(self.render_gtimgs[idx], self.intrinsics[idx],
                              self.cam2worlds[idx], self.near_far[0],
                              self.near_far[1], rng, idx, full_img=full_img)
