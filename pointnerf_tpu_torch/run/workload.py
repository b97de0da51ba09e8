"""The synthetic lego-preset workload of bench.py, in numpy and torch.

`lego_options` is the NeRF-Synthetic lego preset at its full widths with
bench.py's cuts (max_o 280,000, 60² rays a step); `make_cloud` draws
bench.py's 100k-point shell-and-blobs cloud over the lego ranges and
`make_train_batch` its 3,600-ray train batch, both from RandomState(0) as
bench.py draws them. `chip_smoke.py`, `profile_render.py` and the
micro-benchmarks in `pointnerf_tpu_torch/scripts/` share them.

`make_plate_scene` writes the finetune driver's synthetic scene in the
NeRF-Synthetic layout (the geometry of the JAX package's test fixture
`tests/fixtures.py::make_nerf_synth_scene`), with the port's own PNG and PLY
writers, for `chip_smoke.py`'s finetune phase and the `cuda` driver tests.
`make_dtu_scene` writes the same plate in the DTU/MVSNet layout (the
geometry of `tests/fixtures.py::make_dtu_scene`) for the generalizable
driver's phases, and `make_tt_scene` in the Tanks&Temples (NSVF) layout
(the geometry of `tests/fixtures.py::make_tt_scene`, with a fused.ply) for
the evaluation phase, which scores with the random LPIPS weights of
`lpips_state_dict`.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch

from ..config import nerf_synth_preset
from ..data.pfm import write_pfm
from ..data.ply import write_ply_points
from ..utils.png import write_png


def lego_options():
    return nerf_synth_preset("lego").replace(max_o=280000,
                                             random_sample_size=60)


def make_cloud(opt, n_points: int = 100_000, rng=None):
    """bench.py::make_workload's synthetic lego-range cloud, drawn from `rng`
    (RandomState(0), as bench.py, if None): (xyz, emb, color, dirs, conf)."""
    rng = np.random.RandomState(0) if rng is None else rng
    mn = np.asarray(opt.ranges[:3], np.float32)
    mx = np.asarray(opt.ranges[3:], np.float32)
    xyz = rng.uniform(mn, mx, (n_points, 3)).astype(np.float32)
    shell = xyz / (np.linalg.norm(xyz / (mx - mn), axis=-1, keepdims=True)
                   + 1e-6) * 0.6
    take = rng.rand(n_points) < 0.5
    xyz[take] = shell[take].astype(np.float32)
    emb = rng.uniform(-0.5, 0.5, (n_points, opt.point_features_dim)
                      ).astype(np.float32)
    color = rng.uniform(0, 1, (n_points, 3)).astype(np.float32)
    dirs = rng.normal(size=(n_points, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    conf = np.full((n_points, 1), 0.8, np.float32)
    return xyz, emb, color, dirs, conf


def make_train_batch(opt, dev) -> Dict:
    """bench.py::make_workload's train batch: random_sample_size² rays from
    campos (0, 0, 4) looking down -z, pixels spread over ±0.35, and a random
    gt_image, drawn from the RandomState(0) stream after the cloud."""
    rng = np.random.RandomState(0)
    make_cloud(opt, rng=rng)
    R = opt.random_sample_size ** 2
    campos = np.array([[0.0, 0.0, 4.0]], np.float32)
    camrot = np.array([[[1, 0, 0], [0, -1, 0], [0, 0, -1]]], np.float32)
    px = rng.uniform(-0.35, 0.35, (1, R, 2)).astype(np.float32)
    raydir = np.concatenate([px, np.ones((1, R, 1), np.float32)], axis=-1)
    raydir = raydir @ camrot[0].T
    raydir /= np.linalg.norm(raydir, axis=-1, keepdims=True)
    gt = rng.uniform(0, 1, (1, R, 3)).astype(np.float32)
    on = lambda a: torch.as_tensor(a, device=dev)
    return {"raydir": on(raydir), "campos": on(campos),
            "camrotc2w": on(camrot), "near": float(opt.near_plane),
            "far": float(opt.far_plane),
            "bg_color": torch.ones((1, 3), device=dev), "gt_image": on(gt)}


def look_at_pose(campos):
    """Blender-convention c2w looking at the origin, +z up."""
    fwd = campos / np.linalg.norm(campos)
    right = np.cross([0.0, 0.0, 1.0], fwd)
    right /= np.linalg.norm(right)
    pose = np.eye(4)
    pose[:3, 0], pose[:3, 1], pose[:3, 2] = right, np.cross(fwd, right), fwd
    pose[:3, 3] = campos
    return pose


def plate_color(x, y):
    return np.stack([np.clip(x + 0.5, 0, 1), np.clip(y + 0.5, 0, 1),
                     np.full_like(x, 0.5)], axis=-1)


def render_plate_rgba(c2w, focal, W, H, half=0.4):
    """Analytic RGBA view of the |x|,|y| <= half plate at z = 0."""
    px, py = np.meshgrid(np.arange(W, dtype=np.float64),
                         np.arange(H, dtype=np.float64))
    dirs = np.stack([(px + 0.5 - W / 2) / focal, -(py + 0.5 - H / 2) / focal,
                     -np.ones_like(px)], axis=-1) @ c2w[:3, :3].T
    t0 = c2w[:3, 3]
    tt = np.where(np.abs(dirs[..., 2]) > 1e-9, -t0[2] / dirs[..., 2], -1.0)
    hit = t0 + tt[..., None] * dirs
    inside = (tt > 0) & (np.abs(hit[..., 0]) <= half) \
        & (np.abs(hit[..., 1]) <= half)
    rgb = np.where(inside[..., None], plate_color(hit[..., 0], hit[..., 1]),
                   0.0)
    return np.concatenate([rgb, inside[..., None].astype(np.float64)], -1)


def make_plate_scene(root, wh=(400, 400), n_train=12, n_test=4,
                     side=317, hole=(0.1, 0.05, 0.1), scan="plate",
                     radius=3.0, camera_angle_x=0.6911112070083618):
    """A plate scene in the NeRF-Synthetic layout, written with the port's
    PNG and PLY writers: the geometry of tests/fixtures.py::
    make_nerf_synth_scene (a colored plate at z = 0 seen from a sphere of
    radius 3), with a side² grid of noisy plate points as its init cloud,
    less a disk `hole` = (x, y, r), so that probe-and-grow finds rays that
    miss. Returns the number of init points written."""
    W, Hh = wh
    scene = os.path.join(root, scan)
    focal = 0.5 * 800 / np.tan(0.5 * camera_angle_x) * W / 800.0
    for split, n in (("train", n_train), ("test", n_test)):
        frames = []
        os.makedirs(os.path.join(scene, split), exist_ok=True)
        for i in range(n):
            theta = 2 * np.pi * (i + (0.5 if split != "train" else 0)) / n
            phi = np.deg2rad(35 + 20 * ((i % 3) - 1))
            campos = radius * np.array([np.cos(theta) * np.cos(phi),
                                        np.sin(theta) * np.cos(phi),
                                        np.sin(phi)])
            pose = look_at_pose(campos)
            rgba = render_plate_rgba(pose, focal, W, Hh)
            rel = f"./{split}/r_{i}"
            write_png(os.path.join(scene, f"{rel}.png"),
                      (np.clip(rgba, 0, 1) * 255).astype(np.uint8))
            frames.append({"file_path": rel, "rotation": 0.0,
                           "transform_matrix": pose.tolist()})
        with open(os.path.join(scene, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": camera_angle_x, "frames": frames},
                       f)
    rng = np.random.RandomState(0)
    g = np.linspace(-0.4, 0.4, side)
    gx, gy = np.meshgrid(g, g, indexing="ij")
    xyz = np.stack([gx, gy, np.zeros_like(gx)], -1).reshape(-1, 3)
    xyz = xyz + rng.normal(0, 0.003, xyz.shape)
    hx, hy, hr = hole
    xyz = xyz[(xyz[:, 0] - hx) ** 2 + (xyz[:, 1] - hy) ** 2 > hr ** 2]
    os.makedirs(os.path.join(scene, "colmap_results/dense"), exist_ok=True)
    write_ply_points(os.path.join(scene, "colmap_results/dense/fused.ply"),
                     xyz.astype(np.float32), plate_color(xyz[:, 0], xyz[:, 1]))
    return len(xyz)


def make_dtu_scene(root, scan="scan1", n_views=6, wh=(64, 64), radius=3.0,
                   focal=None):
    """The plate in the DTU/MVSNet layout, written with the port's PNG and
    PFM writers (tests/fixtures.py::make_dtu_scene's geometry at any `wh`):
    Cameras/train/*_cam.txt (intrinsics at 1/4 scale, translations and
    depths in 200× world units), Rectified PNGs for the 7 lights, raw
    1600×1200 Depths_raw PFMs that the loader's halving, crop and resize
    bring back to the analytic plate depth, and dtu_configs (one scan in
    every list, each view's 5 nearest others as its sources). `focal`
    defaults to the fixture's 60 px at 64 px, scaled with the width."""
    W, H = wh
    focal = 60.0 * W / 64.0 if focal is None else float(focal)
    scale = 200.0
    for d in ("Cameras/train", f"Rectified/{scan}_train",
              f"Depths_raw/{scan}", "dtu_configs/lists"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1.0]])
    flip = np.diag([1.0, -1.0, -1.0, 1.0])
    for vid in range(n_views):
        theta = 2 * np.pi * vid / n_views
        phi = np.deg2rad(40)
        campos = radius * np.array([np.cos(theta) * np.cos(phi),
                                    np.sin(theta) * np.cos(phi), np.sin(phi)])
        pose_gl = look_at_pose(campos)
        c2w_cv = pose_gl @ flip
        w2c_dtu = np.linalg.inv(c2w_cv)
        w2c_dtu[:3, 3] *= scale
        dmin_dtu = 2.0 * scale
        dint = (4.5 - 2.0) * scale / (192 * 1.06)
        K4 = K.copy()
        K4[:2] /= 4.0
        with open(os.path.join(root, f"Cameras/train/{vid:08d}_cam.txt"),
                  "w") as f:
            f.write("extrinsic\n")
            for r in w2c_dtu:
                f.write(" ".join(f"{x:.9f}" for x in r) + "\n")
            f.write("\nintrinsic\n")
            for r in K4:
                f.write(" ".join(f"{x:.9f}" for x in r) + "\n")
            f.write(f"\n{dmin_dtu:.6f} {dint:.6f}\n")

        rgba = render_plate_rgba(pose_gl, focal, W, H)
        rgb = rgba[..., :3] * rgba[..., 3:] + 1.0 * (1 - rgba[..., 3:])
        img8 = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
        for light in range(7):
            write_png(os.path.join(root, f"Rectified/{scan}_train/"
                                   f"rect_{vid + 1:03d}_{light}_r5000.png"),
                      img8)

        # raw pixel → cropped pixel → this K: the plate depth in DTU units
        px, py = np.meshgrid(np.arange(1600, dtype=np.float64),
                             np.arange(1200, dtype=np.float64))
        fx = (px / 2 - 80) / 640 * W
        fy = (py / 2 - 44) / 512 * H
        d_cam = np.stack([(fx - W / 2) / focal, (fy - H / 2) / focal,
                          np.ones_like(fx)], -1)
        d_w = d_cam @ c2w_cv[:3, :3].T
        t = (0.0 - campos[2]) / d_w[..., 2]
        hit = campos + t[..., None] * d_w
        inside = (t > 0) & (np.abs(hit[..., 0]) <= 0.4) \
            & (np.abs(hit[..., 1]) <= 0.4)
        write_pfm(os.path.join(root, f"Depths_raw/{scan}/"
                               f"depth_map_{vid:04d}.pfm"),
                  np.where(inside, t * scale, 0.0).astype(np.float32))

    for split in ("train", "test", "val"):
        with open(os.path.join(root, "dtu_configs/lists",
                               f"dtu_{split}_all.txt"), "w") as f:
            f.write(scan + "\n")
    with open(os.path.join(root, "dtu_configs/dtu_pairs.txt"), "w") as f:
        f.write(f"{n_views}\n")
        for ref in range(n_views):
            srcs = [v for v in range(n_views) if v != ref][:5]
            f.write(f"{ref}\n")
            f.write(f"{len(srcs)} " + " ".join(f"{v} 1.0" for v in srcs)
                    + "\n")
    return root


def make_tt_scene(root, scan="Truck", n_train=6, n_test=2, wh=(40, 40),
                  radius=3.0, half=0.4, focal=None, side=30):
    """The plate in the Tanks&Temples (NSVF) layout, written with the port's
    PNG and PLY writers (tests/fixtures.py::make_tt_scene's geometry at any
    `wh`, plate half-width `half` and camera distance `radius`):
    rgb/{0_,1_}NNNN.png RGBA views at 30° elevation, pose/*.txt OpenCV
    c2w, intrinsics.txt (4×4; `focal` defaults to the fixture's 40 px at
    40 px, scaled with the width), bbox.txt, and colmap_results/dense/
    fused.ply with a side² grid of noisy plate points. Returns the number
    of points written."""
    W, H = wh
    focal = 40.0 * W / 40.0 if focal is None else float(focal)
    scene = os.path.join(root, scan)
    for d in ("rgb", "pose", "colmap_results/dense"):
        os.makedirs(os.path.join(scene, d), exist_ok=True)
    K = np.diag([focal, focal, 1.0, 1.0])
    K[0, 2], K[1, 2] = W / 2, H / 2
    np.savetxt(os.path.join(scene, "intrinsics.txt"), K)
    bbox = np.array([-0.5, -0.5, -0.2, 0.5, 0.5, 0.2, 0.01]) * (half / 0.4)
    np.savetxt(os.path.join(scene, "bbox.txt"), bbox)
    flip = np.diag([1.0, -1.0, -1.0, 1.0])
    for prefix, n in (("0", n_train), ("1", n_test)):
        for i in range(n):
            theta = 2 * np.pi * (i + (0.3 if prefix == "1" else 0)) / n
            phi = np.deg2rad(30)
            campos = radius * np.array([np.cos(theta) * np.cos(phi),
                                        np.sin(theta) * np.cos(phi),
                                        np.sin(phi)])
            pose_gl = look_at_pose(campos)
            rgba = render_plate_rgba(pose_gl, focal, W, H, half=half)
            name = f"{prefix}_{i:04d}"
            write_png(os.path.join(scene, "rgb", name + ".png"),
                      (np.clip(rgba, 0, 1) * 255).astype(np.uint8))
            np.savetxt(os.path.join(scene, "pose", name + ".txt"),
                       pose_gl @ flip)
    rng = np.random.RandomState(0)
    g = np.linspace(-half, half, side)
    gx, gy = np.meshgrid(g, g, indexing="ij")
    xyz = np.stack([gx, gy, np.zeros_like(gx)], -1).reshape(-1, 3)
    xyz = xyz + rng.normal(0, 0.003 * half / 0.4, xyz.shape)
    write_ply_points(os.path.join(scene, "colmap_results/dense/fused.ply"),
                     xyz.astype(np.float32), plate_color(xyz[:, 0], xyz[:, 1]))
    return len(xyz)


def lpips_state_dict(net: str, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Random LPIPS weights in the lpips package's state-dict layout (the
    real files are drop-in replacements with the same keys): He-scaled
    convs, small biases, positive heads, the package's scaling layer, from
    a torch generator seeded with `seed`."""
    from ..utils.lpips import LPIPS
    gen = torch.Generator().manual_seed(seed)
    sd = LPIPS(net).state_dict()
    for k, v in sd.items():
        if k.startswith("net.") and k.endswith(".weight"):
            fan_in = v[0].numel()
            sd[k] = torch.randn(v.shape, generator=gen) * (2.0 / fan_in) ** 0.5
        elif k.startswith("net."):
            sd[k] = torch.randn(v.shape, generator=gen) * 0.05
        elif k.startswith("lin"):
            sd[k] = torch.randn(v.shape, generator=gen).abs() * 0.1
    sd["scaling_layer.shift"] = torch.tensor(
        [-.030, -.088, -.188]).view(1, 3, 1, 1)
    sd["scaling_layer.scale"] = torch.tensor([.458, .448, .450]).view(1, 3,
                                                                      1, 1)
    return sd
