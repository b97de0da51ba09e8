"""Training observability: image dumps, the loss log, point-cloud txt dumps
(copy of `pointnerf_tpu/utils/visualizer.py` without tensorboard).

Reference: utils/visualizer.py — log.txt appends (:158-174), image saving
(:69-75), point-cloud txt dumps (:97-121), video assembly (:77-95), loss
accumulation with a running PSNR (:142-156). Images are written with the
port's PNG codec, videos as animated GIFs with its GIF codec (the JAX
package writes an mp4 through imageio). Not ported: tensorboard scalars.
"""

from __future__ import annotations

import os
import time
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np

from .gif import write_gif
from .png import read_png, write_png


def to8b(x: np.ndarray) -> np.ndarray:
    """float [0,1] → uint8 (reference: utils/util.py:34)."""
    return (255 * np.clip(np.asarray(x), 0, 1)).astype(np.uint8)


class Visualizer:
    def __init__(self, opt):
        self.opt = opt
        root = os.path.join(opt.checkpoints_dir, opt.experiment)
        self.image_dir = os.path.join(root, "images")
        self.point_dir = os.path.join(root, "points")
        self.vid_dir = os.path.join(root, "vids")
        self.log_path = os.path.join(root, "log.txt")
        for d in (self.image_dir, self.point_dir, self.vid_dir):
            os.makedirs(d, exist_ok=True)
        self._acc: Dict[str, list] = {}
        self._t_last = time.time()

    def display_current_results(self, visuals: Dict[str, np.ndarray],
                                step: int, subdir: str = ""):
        """Save each visual as images/[subdir/]step-{step:04d}-{name}.png
        (reference: visualizer.py:69-75)."""
        out = os.path.join(self.image_dir, subdir) if subdir else \
            self.image_dir
        os.makedirs(out, exist_ok=True)
        for name, img in visuals.items():
            if img is None:
                continue
            img = np.asarray(img)
            if img.ndim == 4:
                img = img[0]
            write_png(os.path.join(out, f"step-{step:04d}-{name}.png"),
                      to8b(img))

    def gen_video(self, name: str, img_dir: str, pattern: str, steps,
                  fps: int = 24) -> str:
        """Assemble the saved frames img_dir/(pattern % step) into
        vids/{name}.gif (reference: visualizer.py:85-95, an mp4 there);
        the frames stay on disk. Palette bound: `utils.gif.QUANT_BOUND`
        levels per channel. A missing frame raises. Returns the path."""
        out = os.path.join(self.vid_dir, name + ".gif")
        write_gif(out, [read_png(os.path.join(img_dir, pattern % s))
                        for s in steps], fps=fps)
        return out

    def save_neural_points(self, step, xyz: np.ndarray,
                           color: Optional[np.ndarray],
                           conf: Optional[np.ndarray] = None,
                           mask: Optional[np.ndarray] = None):
        """Dump active points to txt: x y z r g b [conf]
        (reference: visualizer.py:97-121)."""
        xyz = np.asarray(xyz)
        if mask is not None:
            mask = np.asarray(mask).astype(bool)
            xyz = xyz[mask]
            color = None if color is None else np.asarray(color)[mask]
            conf = None if conf is None else np.asarray(conf)[mask]
        cols = [xyz, to8b(color).astype(np.float32) if color is not None
                else np.zeros_like(xyz)]
        if conf is not None:
            cols.append(np.asarray(conf).reshape(len(xyz), -1))
        path = os.path.join(self.point_dir, f"{step}.txt")
        np.savetxt(path, np.concatenate(cols, axis=-1), fmt="%.6f")
        return path

    def reset(self):
        self._acc = {}

    def accumulate_losses(self, losses: Dict[str, float]):
        for k, v in losses.items():
            self._acc.setdefault(k, []).append(float(v))

    def get_means(self) -> "OrderedDict[str, float]":
        """Mean of each accumulated loss; *raycolor losses also get the
        mean of their per-step PSNR (reference: visualizer.py:142-156)."""
        out = OrderedDict()
        for k in sorted(self._acc):
            vals = np.asarray(self._acc[k], np.float64)
            out[k] = float(vals.mean())
            if "raycolor" in k:
                out[k + "_psnr"] = float(
                    (-10.0 * np.log10(np.maximum(vals, 1e-10))).mean())
        return out

    def print_losses(self, step: int, extra: str = ""):
        """Console and log.txt line with sec/iter (reference:
        visualizer.py:158-167)."""
        now = time.time()
        means = self.get_means()
        n = max(1, max((len(v) for v in self._acc.values()), default=1))
        msg = f"step: {step}  " + "  ".join(
            f"{k}: {v:.6f}" for k, v in means.items())
        msg += f"  sec/iter: {(now - self._t_last) / n:.3f}"
        if extra:
            msg += "  " + extra
        print(msg)
        self.append_log(msg)
        self._t_last = now
        self.reset()
        return means

    def print_details(self, text: str):
        print(text)
        self.append_log(text)

    def append_log(self, line: str):
        with open(self.log_path, "a") as f:
            f.write(line + "\n")
