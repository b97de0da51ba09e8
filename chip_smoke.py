"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from pointnerf_tpu_torch/csrc, holds each
kernel against its plain PyTorch version at the shapes the serving path
gives it, then renders one full 800x800 image of the NeRF-Synthetic lego
preset (random weights from a seeded torch.Generator, a 100k-point
shell-and-blobs cloud as bench.py builds it) through the port's
render_image, and re-renders two chunks of it on the CPU with the plain
versions. Any failed check raises. The last line is a JSON object with the
device; the line before it lists each kernel's launches, error and times.
Needs a CUDA device; without one it exits nonzero and prints no result.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

H = W = 800            # NeRF-Synthetic test views
FOCAL = 1111.1111      # 0.5 * 800 / tan(0.5 * camera_angle_x), angle 0.6911
RADIUS = 4.0           # camera distance of the NeRF-Synthetic test poses
GROUP = 8              # chunks per stacked serving group
K1_TOL = dict(rtol=1e-4, atol=1e-4)   # fp32, other summation order over
                                       # four <=284-term layers
CPU_TOL = dict(rtol=1e-4, atol=1e-4)  # card vs CPU: summation order differs


def log(*a):
    print(*a, flush=True)


def cuda_time(fn, reps: int) -> float:
    """Mean ms per call over `reps` calls, timed with CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_pair(kernel_fn, plain_fn, reps: int = 3):
    """Warm both, then time plain, kernel, kernel, plain in turns."""
    kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    p1 = cuda_time(plain_fn, reps)
    k1 = cuda_time(kernel_fn, reps)
    k2 = cuda_time(kernel_fn, reps)
    p2 = cuda_time(plain_fn, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def make_cloud(opt, n_points=100_000, seed=0):
    """bench.py::make_workload's synthetic lego-range cloud (numpy only)."""
    rng = np.random.RandomState(seed)
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


def make_item(opt, azimuth=0.7, elevation=0.5):
    """One full-image camera on the NeRF-Synthetic test sphere, looking at
    the origin (Blender convention: camera -z forward, +z up)."""
    from pointnerf_tpu_torch.ops.camera import get_blender_raydir
    campos = RADIUS * np.array([np.cos(elevation) * np.cos(azimuth),
                                np.cos(elevation) * np.sin(azimuth),
                                np.sin(elevation)])
    z = campos / np.linalg.norm(campos)            # camera looks along -z
    x = np.cross([0.0, 0.0, 1.0], z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    rot = np.stack([x, y, z], axis=1).astype(np.float32)
    px, py = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32))
    pix = np.stack([px, py], -1).reshape(-1, 2)
    raydir = get_blender_raydir(pix, H, W, FOCAL, rot, dir_norm=False)
    return {"h": H, "w": W, "pixel_idx": pix[None],
            "raydir": raydir.reshape(1, -1, 3),
            "campos": campos.astype(np.float32)[None],
            "camrotc2w": rot[None],
            "near": np.float32(opt.near_plane), "far": np.float32(opt.far_plane),
            "bg_color": np.ones((1, 3), np.float32)}


def build_workload(dev):
    """The main path's inputs on `dev`: the lego preset, bench.py's cloud,
    its grid (built there), seeded aggregator weights and one camera.
    Returns (opt, state, spec, grid, agg, serve_state, item, grid_ms)."""
    from pointnerf_tpu_torch.config import nerf_synth_preset
    from pointnerf_tpu_torch.models import neural_points as npc
    from pointnerf_tpu_torch.models.aggregator import init_aggregator_params
    from pointnerf_tpu_torch.run import common
    from pointnerf_tpu_torch.train.trainer import ServeState
    opt = nerf_synth_preset("lego").replace(max_o=280000,
                                            random_sample_size=60)
    xyz, emb, color, dirs, conf = make_cloud(opt)
    state = npc.create_point_cloud(xyz, emb, color, dirs, conf, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    spec, grid = common.make_spec_and_grid(opt, state)
    torch.cuda.synchronize()
    grid_ms = 1e3 * (time.perf_counter() - t0)
    gen = torch.Generator(device="cpu").manual_seed(0)
    agg = init_aggregator_params(opt, generator=gen, device=dev)
    return (opt, state, spec, grid, agg, ServeState(agg, state),
            make_item(opt), grid_ms)


def check_trunk(agg, opt, Ncb: int, NtB: int):
    """K1 against fused_trunk_reference at one serving group's tier shapes."""
    from pointnerf_tpu_torch.ops import trunk as tt
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(1)
    L1, L3 = opt.shading_feature_mlp_layer1, opt.shading_feature_mlp_layer3
    nf, nd = opt.num_feat_freqs, abs(opt.dist_xyz_freq)
    Fe = opt.point_features_dim
    rows = []
    for tier, K, n_pts in (("narrow", opt.k_tier if opt.k_tier > 0 else 1, Ncb),
                           ("wide", opt.K, NtB)):
        S = n_pts * K
        emb = (torch.rand(S, Fe, generator=g) - 0.5).to(dev)
        d = (0.02 * torch.randn(S, 6, generator=g)).to(dev)
        ex3 = (2 * torch.rand(S, 7, generator=g) - 1).to(dev)
        w = (torch.rand(S, 1, generator=g)
             * (torch.rand(S, 1, generator=g) < 0.3)).to(dev)
        for order1 in (False, True):
            ops = tt.pack_trunk_params(agg, Fe, 6, nf, nd,
                                       with_alpha=not order1)
            args = (L1, L3, nf, nd, K, opt.act_super > 0, order1, emb, d, ex3,
                    w, ops)
            got = tt.fused_trunk(*args)
            want = tt.fused_trunk_reference(*args)
            torch.cuda.synchronize()
            if (got[1] is None) != (want[1] is None):
                raise AssertionError("K1 alpha output presence differs")
            err = rel = 0.0
            for a, b in zip(got, want):
                if b is None:
                    continue
                torch.testing.assert_close(a, b, **K1_TOL)
                diff = (a - b).abs()
                err = max(err, float(diff.max()))
                rel = max(rel, float(diff.max() / b.abs().max()))
            ms, plain_ms = timed_pair(lambda: tt.fused_trunk(*args),
                                      lambda: tt.fused_trunk_reference(*args))
            mac = S * sum(t.numel() for t in ops if t.shape[0] > 1)
            log(f"K1 trunk_fwd {tier} K={K} order={1 if order1 else 2} "
                f"rows={S}: max_abs_err={err:.3e} "
                f"max_abs_err/max|plain|={rel:.3e} "
                f"kernel={ms:.3f} ms "
                f"plain={plain_ms:.3f} ms ({2 * mac / ms / 1e9:.2f} TFLOP/s "
                f"kernel)")
            rows.append((tier, order1, err, ms, plain_ms))
        del emb, d, ex3, w
    return rows


def check_occupancy(item, grid, spec, opt, rays: int):
    """K3 against the dense plain mask on the rays x samples of the serving
    group that holds the image's center."""
    from pointnerf_tpu_torch.ops import query as tq
    from pointnerf_tpu_torch.ops import raygen
    dev = torch.device("cuda")
    start = (H * W // 2) // rays * rays
    raydir = torch.as_tensor(item["raydir"][:, start:start + rays],
                             device=dev)
    campos = torch.as_tensor(item["campos"], device=dev)
    _, _, _, t = raygen.near_far_linear_ray_generation(
        campos, raydir, opt.z_depth_dim, near=float(item["near"]),
        far=float(item["far"]))
    kern = lambda: tq.mask_raypos_segmented(campos, raydir, t, grid, spec)[0]
    plain = lambda: tq.mask_raypos(tq.ray_points(campos, raydir, t), grid,
                                   spec)
    got, want = kern(), plain()
    torch.cuda.synchronize()
    n_diff = int((got != want).sum())
    if n_diff:
        raise AssertionError(f"K3 occupancy differs from the plain mask on "
                             f"{n_diff} samples")
    ms, plain_ms = timed_pair(kern, plain, reps=5)
    log(f"K3 occupancy rays={rays} samples={t.numel()}: equal "
        f"(occupied share {float(want.float().mean()):.4f}) "
        f"kernel={ms:.3f} ms plain={plain_ms:.3f} ms")
    return ms, plain_ms


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pointnerf_tpu_torch.models.renderer import effective_sr_budget
    from pointnerf_tpu_torch.ops import kernels
    from pointnerf_tpu_torch.run import common
    from pointnerf_tpu_torch.train.trainer import ServeState

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    kernels.library()
    build_s, build_log = kernels.build_info()
    log(f"kernel build: {build_s:.1f} s compile, "
        f"{time.perf_counter() - t0:.1f} s build+load")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log("  ptxas:", line.strip())

    opt, state, spec, grid, agg, ts, item, grid_ms = build_workload(
        torch.device("cuda"))
    log(f"grid build on card: {grid_ms:.1f} ms, "
        f"vdim {spec.vdim}, occupied voxels {int(grid['num_occ'])}")

    # kernels against their plain versions, at one serving group's shapes
    chunk = opt.random_sample_size ** 2
    Ncb = effective_sr_budget(opt, GROUP * chunk * opt.SR)
    NtB = min(Ncb, max(128, int(round(Ncb * opt.k_tier_wide_frac))))
    with torch.inference_mode():
        k1 = check_trunk(agg, opt, Ncb, NtB)
        k3 = check_occupancy(item, grid, spec, opt, GROUP * chunk)
    torch.cuda.empty_cache()

    # the main path: one full image through render_image, twice (the first
    # call warms the allocator and cuBLAS); counts cover the timed render
    common.render_image(ts, grid, opt, spec, item, group=GROUP)
    for k in kernels.KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    t0 = time.perf_counter()
    maps = common.render_image(ts, grid, opt, spec, item, group=GROUP,
                               stats=stats)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels.KERNELS}
    rgb, hit = maps["coarse_raycolor"], maps["ray_mask"][..., 0] > 0.5
    log(f"render 800x800: {1e3 * dt:.1f} ms/image, {H * W / dt:.0f} rays/s, "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"hit share {hit.mean():.4f}, groups {stats['groups']}, "
        f"sr_overflow {stats['sr_overflow']}, "
        f"occ_overflow {stats['occ_overflow']}, launches {launches}")
    for k in kernels.KERNELS:
        if k.launches == 0:
            raise AssertionError(f"the main path never launched {k.name}")
    if rgb.shape != (H, W, 3) or not np.isfinite(rgb).all():
        raise AssertionError("rendered image is not a finite [800,800,3] map")
    if not 0.0 < hit.mean() < 1.0:
        raise AssertionError(f"hit share {hit.mean()} is degenerate")
    if rgb.min() < -0.01 or rgb.max() > 1.01:
        raise AssertionError(f"colors out of range [{rgb.min()}, {rgb.max()}]")
    if not np.allclose(rgb[~hit], 1.0, atol=1e-6):
        raise AssertionError("missed rays do not show the white background")

    # two chunks rendered again on the CPU with the plain versions
    per_chunk = hit.reshape(-1)[: (H * W // chunk) * chunk].reshape(-1, chunk)
    pick = np.sort(np.argsort(-per_chunk.sum(1), kind="stable")[:2])
    sel = np.concatenate([np.arange(c * chunk, (c + 1) * chunk) for c in pick])
    sub = dict(item, raydir=item["raydir"][:, sel],
               pixel_idx=item["pixel_idx"][:, sel])
    cpu_state = {k: (None if v is None else v.cpu()) for k, v in state.items()}
    cpu_grid = {k: v.cpu() for k, v in grid.items()}
    cpu_ts = ServeState(copy.deepcopy(agg).cpu(), cpu_state)
    t0 = time.perf_counter()
    cpu_maps = common.render_image(cpu_ts, cpu_grid,
                                   opt.replace(use_fused_trunk=1), spec, sub,
                                   group=GROUP)
    px, py = sub["pixel_idx"][0, :, 0].astype(int), \
        sub["pixel_idx"][0, :, 1].astype(int)
    np.testing.assert_array_equal(cpu_maps["ray_mask"][py, px],
                                  maps["ray_mask"][py, px])
    np.testing.assert_allclose(cpu_maps["coarse_raycolor"][py, px],
                               rgb[py, px], **CPU_TOL)
    cerr = float(np.abs(cpu_maps["coarse_raycolor"][py, px]
                        - rgb[py, px]).max())
    log(f"CPU re-render of chunks {pick.tolist()} ({len(sel)} rays, "
        f"{int(hit.reshape(-1)[sel].sum())} hit): max_abs_err {cerr:.3e} "
        f"in {time.perf_counter() - t0:.1f} s")

    narrow2 = next(r for r in k1 if r[0] == "narrow" and not r[1])
    wide2 = next(r for r in k1 if r[0] == "wide" and not r[1])
    report = {"kernels": [
        {"name": kernels.TRUNK_FWD.name, "route": "cuda",
         "source": kernels.TRUNK_FWD.source,
         "replaces": kernels.TRUNK_FWD.replaces,
         "launches": launches[kernels.TRUNK_FWD.name],
         "max_abs_err": max(r[2] for r in k1),
         "ms": narrow2[3] + wide2[3], "plain_ms": narrow2[4] + wide2[4]},
        {"name": kernels.OCCUPANCY.name, "route": "cuda",
         "source": kernels.OCCUPANCY.source,
         "replaces": kernels.OCCUPANCY.replaces,
         "launches": launches[kernels.OCCUPANCY.name],
         "max_abs_err": 0.0, "ms": k3[0], "plain_ms": k3[1]},
    ]}
    log(json.dumps(report))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
