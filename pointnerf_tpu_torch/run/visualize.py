"""Headless neural-point-cloud viewer (port of
`pointnerf_tpu/run/visualize.py`; reference run/visualize.py and
vis_grow_train.py).

The reference opens an interactive pyrender window; this driver covers
the same need without a display, as the JAX package's does:

* ``--ply out.ply``: the confidence-thresholded colored cloud as a binary
  PLY (byte for byte the JAX package's file);
* a turntable: orbit-camera z-buffered point splats of the cloud, PNG
  frames under <out> and an animated GIF;
* ``--grow dir``: every ``points/{step}.txt`` dump of a training run
  splatted into one growth GIF (reference run/vis_grow_train.py:36-66).

`splat_render` runs in torch on an explicit device, the card by default.
The JAX package's numpy splat paints the points far to near, window
offset by window offset, and the last write to a pixel wins; a scatter on
the card does not order its writes, so each pixel here takes the colour of
the covering write with the largest painter rank (offset, then depth
order): a scatter_reduce amax over the ranks, then a gather. That is
numpy's image, on any device. Its products are elementwise float32 ops in
a fixed order, so the card and the CPU round every pixel coordinate alike
(np.round and torch.round both round half to even).

Deviation: the videos are animated GIFs (`utils/gif`); the JAX package
tries an mp4 through imageio, which the GPU machine lacks. The frames
stay as PNGs (`utils/png`).

Usage:
    python -m pointnerf_tpu_torch.run.visualize --checkpoint ckpt_dir \
        [--resume_iter N] [--ply cloud.ply] [--out dir] [--device cpu]
    python -m pointnerf_tpu_torch.run.visualize --grow runs/exp/points \
        --out dir
"""

from __future__ import annotations

import argparse
import glob
import os
import re
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.gif import write_gif
from ..utils.png import write_png


# --------------------------------------------------------------------- loading
def load_point_cloud(checkpoint: str, resume_iter: Optional[int] = None,
                     thres: float = 0.1
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A checkpoint dir (its newest step, or resume_iter) or a
    ``*_net_ray_marching.npz`` → (xyz, rgb in [0, 1], conf) of the points
    whose conf exceeds thres (reference run/visualize.py:43-45)."""
    path = checkpoint
    if os.path.isdir(path):
        if resume_iter is None:
            cands = []
            for p in glob.glob(os.path.join(path, "*_net_ray_marching.npz")):
                m = re.match(r"^(\d+)_net_ray_marching\.npz$",
                             os.path.basename(p))
                if m:
                    cands.append(int(m.group(1)))
            if not cands:
                raise FileNotFoundError(
                    f"no *_net_ray_marching.npz checkpoints in {path}")
            resume_iter = max(cands)
        path = os.path.join(path, f"{resume_iter}_net_ray_marching.npz")
    raw = dict(np.load(path))
    xyz = np.asarray(raw["neural_points.xyz"], np.float32)
    xyz = xyz[0] if xyz.ndim == 3 else xyz
    n = len(xyz)

    def buf(key, default):
        if key not in raw:
            return default
        a = np.asarray(raw[key], np.float32)
        return a[0] if a.ndim == 3 else a

    rgb = buf("neural_points.points_color", np.full((n, 3), 0.7, np.float32))
    conf = buf("neural_points.points_conf", np.ones((n, 1), np.float32))
    conf = conf.reshape(n)
    keep = conf > thres
    return xyz[keep], np.clip(rgb[keep], 0.0, 1.0), conf[keep]


def load_points_txt(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """A `Visualizer.save_neural_points` dump (x y z r g b [conf], colours
    0-255) → (xyz, rgb in [0, 1])."""
    arr = np.loadtxt(path, dtype=np.float32)
    if arr.ndim == 1:
        arr = arr.reshape(1, -1)
    xyz = arr[:, :3]
    rgb = (arr[:, 3:6] / 255.0 if arr.shape[1] >= 6
           else np.full((len(xyz), 3), 0.7, np.float32))
    return xyz, np.clip(rgb, 0.0, 1.0)


# ------------------------------------------------------------------------- ply
def write_ply(path: str, xyz: np.ndarray, rgb01: np.ndarray) -> None:
    """Binary little-endian PLY: float xyz, uchar rgb."""
    n = len(xyz)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n")
    rec = np.empty(n, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
    rec["xyz"] = xyz.astype("<f4")
    rec["rgb"] = np.clip(rgb01 * 255.0 + 0.5, 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        rec.tofile(f)


# ------------------------------------------------------------------ splatting
def splat_render(xyz, rgb01, c2w: np.ndarray, H: int, W: int, focal: float,
                 point_size: int = 2, bg: float = 1.0,
                 device="cuda") -> torch.Tensor:
    """Z-buffered point splat → [H,W,3] float in [0, 1] on `device` (the
    card unless the caller names another). Each visible point covers a
    point_size² pixel window; among a pixel's writes the one of the latest
    window offset wins, and within an offset the nearest point (the
    painter's order of the JAX package's numpy splat)."""
    dev = torch.device(device)
    xyz = torch.as_tensor(np.asarray(xyz, np.float32), device=dev)
    col = torch.as_tensor(np.asarray(rgb01, np.float32), device=dev)
    c2w = np.asarray(c2w, np.float32)
    R = torch.as_tensor(c2w[:3, :3], device=dev)      # w2c_r.T
    d = xyz - torch.as_tensor(c2w[:3, 3], device=dev)
    cam = d[:, 0:1] * R[0] + d[:, 1:2] * R[1] + d[:, 2:3] * R[2]
    z = -cam[:, 2]
    vis = z > 1e-6
    cam, z, col = cam[vis], z[vis], col[vis]
    px = focal * cam[:, 0] / z + W * 0.5
    py = -focal * cam[:, 1] / z + H * 0.5
    order = torch.argsort(-z, stable=True)            # far first, near last
    px, py, col = px[order], py[order], col[order]
    M = px.shape[0]
    half = point_size // 2
    pix, rank = [], []
    t = 0
    for dy in range(-half, point_size - half):
        for dx in range(-half, point_size - half):
            ix = torch.round(px + dx).long()
            iy = torch.round(py + dy).long()
            ok = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
            pix.append((iy * W + ix)[ok])
            rank.append((t * M + torch.arange(M, device=dev))[ok])
            t += 1
    best = torch.full((H * W,), -1, dtype=torch.int64, device=dev)
    best.scatter_reduce_(0, torch.cat(pix), torch.cat(rank), "amax")
    img = torch.full((H * W, 3), bg, dtype=torch.float32, device=dev)
    hit = best >= 0
    img[hit] = col[best[hit] % max(M, 1)]
    return img.reshape(H, W, 3)


def orbit_pose(center: np.ndarray, radius: float, azimuth: float,
               elevation: float = 0.45) -> np.ndarray:
    """Camera-to-world look-at pose on a circle around the +z-up
    `center`."""
    eye = center + radius * np.array([
        np.cos(azimuth) * np.cos(elevation),
        np.sin(azimuth) * np.cos(elevation),
        np.sin(elevation)], np.float32)
    fwd = center - eye
    fwd = fwd / (np.linalg.norm(fwd) + 1e-9)
    up = np.array([0.0, 0.0, 1.0], np.float32)
    right = np.cross(fwd, up)
    right /= (np.linalg.norm(right) + 1e-9)
    true_up = np.cross(right, fwd)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, true_up, -fwd, eye
    return c2w


def frame_cloud(xyz: np.ndarray) -> Tuple[np.ndarray, float]:
    """The orbit's center (the bounding box's) and radius."""
    center = (xyz.min(0) + xyz.max(0)) * 0.5
    radius = float(np.linalg.norm(xyz.max(0) - xyz.min(0))) * 0.9 + 1e-6
    return center.astype(np.float32), radius


def _frame_u8(img: torch.Tensor) -> np.ndarray:
    return (np.clip(img.cpu().numpy(), 0, 1) * 255).astype(np.uint8)


def render_turntable(xyz: np.ndarray, rgb01: np.ndarray, out_dir: str,
                     n_frames: int = 60, size: int = 512,
                     point_size: int = 2, fps: int = 24,
                     device="cuda") -> str:
    """n_frames orbit splats of the cloud as out_dir/frame-{i:04d}.png and
    out_dir/turntable.gif. Returns the GIF's path."""
    os.makedirs(out_dir, exist_ok=True)
    center, radius = frame_cloud(xyz)
    focal = size / (2.0 * np.tan(np.deg2rad(50.0) / 2.0))
    frames = []
    for i in range(n_frames):
        az = 2.0 * np.pi * i / n_frames
        frame = _frame_u8(splat_render(
            xyz, rgb01, orbit_pose(center, radius, az), size, size, focal,
            point_size, device=device))
        write_png(os.path.join(out_dir, f"frame-{i:04d}.png"), frame)
        frames.append(frame)
    vid = os.path.join(out_dir, "turntable.gif")
    write_gif(vid, frames, fps=fps)
    return vid


def render_grow(points_dir: str, out_dir: str, size: int = 512,
                point_size: int = 2, fps: int = 8,
                device="cuda") -> Optional[str]:
    """The growth GIF of a run's points/{step}.txt dumps, the camera framed
    on the last cloud and turning half a circle (reference
    run/vis_grow_train.py:36-66); frames as out_dir/grow-{i:04d}.png.
    None without dumps."""
    steps = []
    for p in glob.glob(os.path.join(points_dir, "*.txt")):
        m = re.match(r"^(\d+)\.txt$", os.path.basename(p))
        if m:
            steps.append(int(m.group(1)))
    if not steps:
        return None
    steps.sort()
    os.makedirs(out_dir, exist_ok=True)
    xyz_last, _ = load_points_txt(os.path.join(points_dir,
                                               f"{steps[-1]}.txt"))
    center, radius = frame_cloud(xyz_last)
    focal = size / (2.0 * np.tan(np.deg2rad(50.0) / 2.0))
    frames = []
    for i, s in enumerate(steps):
        xyz, rgb = load_points_txt(os.path.join(points_dir, f"{s}.txt"))
        az = 2.0 * np.pi * i / max(len(steps), 1) * 0.5
        frame = _frame_u8(splat_render(
            xyz, rgb, orbit_pose(center, radius, az), size, size, focal,
            point_size, device=device))
        write_png(os.path.join(out_dir, f"grow-{i:04d}.png"), frame)
        frames.append(frame)
    vid = os.path.join(out_dir, "grow.gif")
    write_gif(vid, frames, fps=fps)
    return vid


# ------------------------------------------------------------------------ main
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--checkpoint", help="ckpt dir or *_net_ray_marching.npz")
    ap.add_argument("--resume_iter", type=int, default=None)
    ap.add_argument("--thres", type=float, default=0.1,
                    help="confidence threshold (reference visualize.py:43)")
    ap.add_argument("--out", default="./vis")
    ap.add_argument("--ply", default=None, help="also write a binary PLY here")
    ap.add_argument("--n_frames", type=int, default=60)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--point_size", type=int, default=2)
    ap.add_argument("--grow", default=None,
                    help="points/ dir of a run -> growth video")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    out = {}
    if args.grow:
        out["grow"] = render_grow(args.grow, args.out, args.size,
                                  args.point_size, device=args.device)
        print(f"grow video: {out['grow']}" if out["grow"] else
              f"no {args.grow}/<step>.txt dumps found")
        if not args.checkpoint:
            return out
    if not args.checkpoint:
        raise SystemExit("--checkpoint or --grow required")
    xyz, rgb, conf = load_point_cloud(args.checkpoint, args.resume_iter,
                                      args.thres)
    print(f"{len(xyz)} points above conf {args.thres}")
    out["n_points"] = len(xyz)
    if args.ply:
        write_ply(args.ply, xyz, rgb)
        print(f"wrote {args.ply}")
    out["turntable"] = render_turntable(xyz, rgb, args.out, args.n_frames,
                                        args.size, args.point_size,
                                        device=args.device)
    print(f"turntable: {out['turntable']}")
    return out


if __name__ == "__main__":
    main()
