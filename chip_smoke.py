"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from pointnerf_tpu_torch/csrc and holds each
kernel against its plain PyTorch version at the shapes its path gives it
(K1, K3 and K4 at a serving group's, K2 and K5 at a train step's, K6 at
its micro-benchmark's and at a train step's, K7 at its micro-benchmark's).
Then it drives the port's main paths on the NeRF-Synthetic lego preset
(random weights from a seeded torch.Generator, bench.py's 100k-point
shell-and-blobs cloud), each in the default configuration (fused_shade=0:
K1, K2, K3, K6) and in the fused_shade configuration (fused_shade=1: K4,
K5, K3, K6):

- serving: one full 800x800 image through render_image, two chunks of it
  re-rendered on the CPU with the plain versions; the fused_shade image is
  held against the default one;
- training: bench.py's 3,600-ray batch through create_train_state and
  train_step, one warm-up step and TRAIN_STEPS timed ones, then one
  compute_grads on the card against the CPU's plain versions; the
  fused_shade step-1 loss is held against the default one;

and last the finetune driver, run/train_ft.main, at the lego preset's
widths on a 400x400 plate scene it writes in the NeRF-Synthetic layout
(FT_STEPS steps with a prune, probe-and-grows and a final checkpoint; the
test PSNR must pass FT_PSNR and the PSNR before training), then main again,
which must resume and stop at once.

Each path runs with the launch counts set to 0 just before it and read just
after; every kernel of the path's configuration must have launched in it,
and the other configuration's trunk kernels not at all. Any failed check
raises. The last line is a JSON object with the device; the line before it
is the card's name and power limit, and the line before that lists each
kernel's launches (summed over the paths; K7's from its micro-benchmark's
segmented pipeline), error, times, bound and library call. Needs a CUDA
device; without one it exits nonzero and prints no result.
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
K2_ROW_TOL = K1_TOL                   # K2's per-row cotangents: as K1
KINK = 1e-5                           # rows with a LeakyReLU input this near
                                      # 0 get neighbor weight 0 in the K2
                                      # check: the two summation orders may
                                      # take different slopes there
K2_SUM_REL = 1e-4                     # K2's weight gradients sum ~1e5 rows in
                                      # another order: max error over the
                                      # gradient's largest entry
TRAIN_STEPS = 20                      # timed train steps after one warm-up
LOSS_RTOL = 1e-4                      # card vs CPU loss items
GRAD_REL = 1e-3                       # card vs CPU gradients, ||diff|| /
                                      # ||cpu|| per tensor: summation order
                                      # differs, and a row whose LeakyReLU
                                      # input lies within rounding of 0 may
                                      # take the other slope on the card
SHADE_IMAGE_TOL = 1e-4                # fused_shade=1 image vs the default
                                      # one: the same math, other order
STEP1_RTOL = 1e-5                     # fused_shade=1 step-1 loss vs default
SHADE_GRADS = ("demb", "dxyz", "dxyzp", "dcolor", "ddir", "dconf")
SCATTER_REL = 1e-4                    # K6 vs plain, per entry, of the sum
                                      # of |updates| reaching it: duplicate
                                      # indices sum in another order
SCATTER_SCRIPT = dict(S=384000, cap=102400, C=42, dup=6.0)  # scatter_pallas
OCC_U = 96                            # occ_micro3's distinct-row budget
FT_WH = 400                           # finetune views (plate scene)
FT_STEPS = 800                        # finetune steps
FT_PRUNE = 200                        # the one prune
FT_PROBE = 250                        # probe-and-grow every FT_PROBE steps
FT_PSNR = 16.0                        # final test PSNR bar (dB)
PHASES = ("train_s", "prune_s", "grow_s", "test_s", "save_s")
FT_PROB_THRESH = -0.7                 # probe opacity gate off, as the ficus
                                      # preset sets it: after 800 steps at
                                      # the preset's lr no sample reaches
                                      # lego's 0.7 (no candidates at all)
PEAK_FP32 = 67e12                     # H100 SXM fp32 FLOP/s outside the
                                      # tensor cores, at 700 W (data sheet)
PEAK_BYTES = 3.35e12                  # H100 SXM HBM3 bytes/s (data sheet)


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


def bound(flops: float, nbytes: float):
    """(least ms the card could take, what bounds it): the larger of the
    operations over the fp32 peak and the bytes over the memory rate."""
    ops_ms, bytes_ms = 1e3 * flops / PEAK_FP32, 1e3 * nbytes / PEAK_BYTES
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


def nbytes(*tensors) -> int:
    """Bytes of the tensors (each read or written once; None counts 0)."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def trunk_macs(ops) -> int:
    """Multiply-adds per row of the trunk's products (every weight matrix
    of the packed operands, the alpha head's included; the biases, the PE
    sines and the shade kernels' front half, under 1%, are not counted)."""
    return sum(t.numel() for t in ops if t.shape[0] > 1)


def tier_sums(rows):
    """(ms, plain_ms, bound_ms) of the order-2 checks at the narrow and the
    wide tier summed: one group's or one step's work of the kernel."""
    picked = [r for r in rows if r["order"] == 2 and r.get("mode", 20) == 20]
    assert {r["tier"] for r in picked} == {"narrow", "wide"}
    return tuple(sum(r[k] for r in picked)
                 for k in ("ms", "plain_ms", "bound_ms"))


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
    from pointnerf_tpu_torch.models import neural_points as npc
    from pointnerf_tpu_torch.models.aggregator import init_aggregator_params
    from pointnerf_tpu_torch.run import common
    from pointnerf_tpu_torch.run.workload import lego_options, make_cloud
    from pointnerf_tpu_torch.train.trainer import ServeState
    opt = lego_options()
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
            mac = S * trunk_macs(ops)
            b_ms, b_by = bound(2 * mac, nbytes(emb, d, ex3, w, *ops, *got))
            log(f"K1 trunk_fwd {tier} K={K} order={1 if order1 else 2} "
                f"rows={S}: max_abs_err={err:.3e} "
                f"max_abs_err/max|plain|={rel:.3e} "
                f"kernel={ms:.3f} ms "
                f"plain={plain_ms:.3f} ms ({2 * mac / ms / 1e9:.2f} TFLOP/s "
                f"kernel) bound={b_ms:.3f} ms ({b_by})")
            rows.append(dict(tier=tier, order=1 if order1 else 2, err=err,
                             ms=ms, plain_ms=plain_ms, bound_ms=b_ms))
        del emb, d, ex3, w
    return rows


def trunk_bwd_inputs(opt, S: int, K: int, gen: torch.Generator, dev):
    """Seeded per-neighbor rows and per-point cotangents at the trunk's
    widths: (emb, d, ex3, w, dfeat, dalpha) on `dev`."""
    Fe, H = opt.point_features_dim, opt.shading_feature_num
    rnd = lambda *shape: torch.rand(*shape, generator=gen)
    emb = rnd(S, Fe) - 0.5
    d = 0.02 * torch.randn(S, 6, generator=gen)
    ex3 = 2 * rnd(S, 7) - 1
    w = rnd(S, 1) * (rnd(S, 1) < 0.3)
    dfeat = torch.randn(S // K, H, generator=gen)
    dalpha = torch.randn(S // K, 1, generator=gen)
    return [t.to(dev) for t in (emb, d, ex3, w, dfeat, dalpha)]


def check_trunk_bwd(agg, opt, Ncb: int, NtB: int):
    """K2 against fused_trunk_bwd_reference at one train step's tier
    shapes (narrow: Ncb rows at K=k_tier, wide: NtB shading points x K),
    orders 1 and 2. The derivative of LeakyReLU jumps at 0, so rows with a
    pre-activation within KINK of 0 get neighbor weight 0 (no cotangent
    reaches their layers; their count is printed). Per-row cotangents are
    then held at K2_ROW_TOL; each weight gradient sums every row, so it is
    held relative to its largest entry (K2_SUM_REL). Two launches on the
    same inputs must give bit-equal weight gradients."""
    from pointnerf_tpu_torch.ops import trunk as tt
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(2)
    L1, L3 = opt.shading_feature_mlp_layer1, opt.shading_feature_mlp_layer3
    nf, nd = opt.num_feat_freqs, abs(opt.dist_xyz_freq)
    Fe = opt.point_features_dim
    rows = []
    for tier, K, n_pts in (("narrow", opt.k_tier if opt.k_tier > 0 else 1,
                            Ncb), ("wide", opt.K, NtB)):
        S = n_pts * K
        emb, d, ex3, w, dfeat, dalpha = trunk_bwd_inputs(opt, S, K, g, dev)
        for order1 in (False, True):
            ops = tt.pack_trunk_params(agg, Fe, 6, nf, nd,
                                       with_alpha=not order1)
            ops = [o.detach() for o in ops]
            zs = tt.trunk_activations(L1, L3, nf, nd, emb, d, ex3, ops,
                                      not order1)
            smooth = torch.ones(S, dtype=torch.bool, device=dev)
            for z in zs[2] + zs[4]:
                smooth &= (z.abs() >= KINK).all(dim=1)
            w_s = w * smooth[:, None]
            args = (L1, L3, nf, nd, K, opt.act_super > 0, order1, emb, d, ex3,
                    w_s, ops, dfeat, None if order1 else dalpha)
            got = tt.trunk_bwd(*args)
            again = tt.trunk_bwd(*args)
            want = tt.fused_trunk_bwd_reference(*args)
            torch.cuda.synchronize()
            row_err = row_rel = sum_rel = 0.0
            for a, b in zip(got[:4], want[:4]):
                torch.testing.assert_close(a, b, **K2_ROW_TOL)
                diff = float((a - b).abs().max())
                row_err = max(row_err, diff)
                row_rel = max(row_rel, diff / float(b.abs().max()))
            for a, b, c in zip(got[4], want[4], again[4]):
                if not torch.equal(a, c):
                    raise AssertionError("K2 weight gradients differ between "
                                         "two launches on the same inputs")
                rel = float((a - b).abs().max() / b.abs().max())
                if not rel <= K2_SUM_REL:
                    raise AssertionError(f"K2 weight gradient off by {rel:.3e}"
                                         f" of its largest entry")
                sum_rel = max(sum_rel, rel)
            ms, plain_ms = timed_pair(
                lambda: tt.trunk_bwd(*args),
                lambda: tt.fused_trunk_bwd_reference(*args))
            b_ms, b_by = bound(
                3 * 2 * S * trunk_macs(ops),
                nbytes(*args[7:11], *ops, *args[12:], *got[:4], *got[4]))
            log(f"K2 trunk_bwd {tier} K={K} order={1 if order1 else 2} "
                f"rows={S}: per-row max_abs_err={row_err:.3e} "
                f"({S - int(smooth.sum())} rows within {KINK:g} of a "
                f"LeakyReLU kink weighted 0) "
                f"max_abs_err/max|plain|={row_rel:.3e}, weight grads "
                f"max_abs_err/max|plain|={sum_rel:.3e}, dW bit-equal over two "
                f"launches; kernel={ms:.3f} ms plain={plain_ms:.3f} ms "
                f"bound={b_ms:.3f} ms ({b_by})")
            rows.append(dict(tier=tier, order=1 if order1 else 2,
                             err=row_err, ms=ms, plain_ms=plain_ms,
                             bound_ms=b_ms))
        del emb, d, ex3, w, dfeat, dalpha
    return rows


def shade_inputs(opt, S: int, K: int, gen: torch.Generator, dev):
    """Seeded fused_shade row arguments shaped like the path's: neighbors
    within a few voxels of their sample, validity a prefix of each K-group
    (mostly short), confs across [0, 1.2] (past both clamp edges), unit
    point and view directions, a random rotation. Returns the 11 tensors
    emb, xyz, xyzp, color, pdir, conf, mask, sl, slw, ovd, RT on `dev`."""
    n = S // K
    rnd = lambda *shape: torch.rand(*shape, generator=gen)
    up = lambda x: x.repeat_interleave(K, dim=0)

    def unit(m):
        v = torch.randn(m, 3, generator=gen)
        return v / v.norm(dim=1, keepdim=True)

    mn = torch.tensor(opt.ranges[:3])
    mx = torch.tensor(opt.ranges[3:])
    slw = mn + (mx - mn) * rnd(n, 3)
    sl = torch.cat([0.6 * rnd(n, 2) - 0.3, 2.0 + 4.0 * rnd(n, 1)], dim=1)
    n_valid = torch.floor((K + 1) * rnd(n) ** 2)       # 0..K, mostly short
    mask = (torch.arange(S) % K < up(n_valid)).float()[:, None]
    vox = float(np.linalg.norm(opt.vsize))
    rt, _ = torch.linalg.qr(torch.randn(3, 3, generator=gen))
    rows = [rnd(S, opt.point_features_dim) - 0.5,
            up(slw) + 2 * vox * torch.randn(S, 3, generator=gen),
            up(sl) + 0.01 * torch.randn(S, 3, generator=gen), rnd(S, 3),
            unit(S), 1.2 * rnd(S, 1), mask, sl, slw, unit(n), rt]
    return [t.to(dev).contiguous() for t in rows]


def check_shade(aggs, opt, Ncb: int, NtB: int):
    """K4 against fused_shade_reference at one serving group's tier shapes
    (narrow: Ncb rows at K=k_tier, wide: NtB shading points x K), orders 1
    and 2 at dist mode 20 and dist mode 0 at the narrow shape (aggs: the
    aggregator of each mode). All four outputs are held at K1_TOL."""
    from pointnerf_tpu_torch.ops import trunk as tt
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(3)
    L1, L3 = opt.shading_feature_mlp_layer1, opt.shading_feature_mlp_layer3
    nf, nd = opt.num_feat_freqs, abs(opt.dist_xyz_freq)
    Fe = opt.point_features_dim
    rows = []
    for tier, K, n_pts, modes in (
            ("narrow", opt.k_tier if opt.k_tier > 0 else 1, Ncb, (20, 0)),
            ("wide", opt.K, NtB, (20,))):
        S = n_pts * K
        ins = shade_inputs(opt, S, K, g, dev)
        for mode in modes:
            for order1 in (False, True) if mode == 20 else (False,):
                ops = tt.pack_trunk_params(aggs[mode], Fe, tt.DIST_COLS[mode],
                                           nf, nd, with_alpha=not order1)
                args = (L1, L3, nf, nd, K, opt.act_super > 0, order1, mode,
                        *ins, ops)
                got = tt.fused_shade(*args)
                want = tt.fused_shade_reference(*args)
                torch.cuda.synchronize()
                if (got[1] is None) != (want[1] is None):
                    raise AssertionError("K4 alpha output presence differs")
                err = rel = 0.0
                for a, b in zip(got, want):
                    if b is None:
                        continue
                    torch.testing.assert_close(a, b, **K1_TOL)
                    diff = (a - b).abs()
                    err = max(err, float(diff.max()))
                    rel = max(rel, float(diff.max() / b.abs().max()))
                ms, plain_ms = timed_pair(
                    lambda: tt.fused_shade(*args),
                    lambda: tt.fused_shade_reference(*args))
                mac = S * trunk_macs(ops)
                b_ms, b_by = bound(2 * mac, nbytes(*ins, *ops, *got))
                live = float(ins[6].mean())
                log(f"K4 shade_fwd {tier} K={K} order={1 if order1 else 2} "
                    f"dist_mode={mode} rows={S} (valid share {live:.3f}): "
                    f"max_abs_err={err:.3e} max_abs_err/max|plain|={rel:.3e} "
                    f"kernel={ms:.3f} ms plain={plain_ms:.3f} ms "
                    f"({2 * mac / ms / 1e9:.2f} TFLOP/s kernel) "
                    f"bound={b_ms:.3f} ms ({b_by})")
                rows.append(dict(tier=tier, order=1 if order1 else 2,
                                 mode=mode, err=err, ms=ms, plain_ms=plain_ms,
                                 bound_ms=b_ms))
        del ins
    return rows


def shade_bwd_scales(rows, K: int):
    """Per row, how much the front's backward scales an error of K2's
    per-row cotangents (dd_raw, dex3, dw_eff), each within K2_ROW_TOL:
    dxyzp = [ddp0·zp, ddp1·zp, ddp0·xp + ddp1·yp + ddp2], so up to
    1 + |xp| + |yp| + |zp|; dxyz = dd_raw[:3]·RTᵀ − (w_raw/nc)·dw_raw·d/nc
    with dw_raw = (dw_n − Σ_K dw_n·w_n)/S_w, so up to √3 + 2·w_n/nc (the
    weight of a near neighbor amplifies dw_eff's rounding). The other four
    outputs are not scaled."""
    from pointnerf_tpu_torch.ops import trunk as tt
    f = tt.shade_front(*rows[1:], 20, K)
    return {"dxyzp": 1.0 + rows[2].abs().sum(dim=1),
            "dxyz": 3 ** 0.5 + 2.0 * (f.w_n / f.nc)[:, 0]}


def assert_rows_close(what, a, b, scale=None):
    """|a − b| <= K2_ROW_TOL's atol (times `scale` [S] per row, if given)
    + its rtol·|b|, entry by entry."""
    atol = K2_ROW_TOL["atol"] * (1.0 if scale is None else scale[:, None])
    bad = (a - b).abs() > atol + K2_ROW_TOL["rtol"] * b.abs()
    if bool(bad.any()):
        i = int(bad.any(dim=1).nonzero()[0])
        raise AssertionError(f"{what}: {int(bad.sum())} entries past the "
                             f"tolerance, first in row {i}: "
                             f"{a[i].tolist()} vs {b[i].tolist()}")


def check_shade_bwd(agg, opt, Ncb: int, NtB: int):
    """K5 against fused_shade_bwd_reference at one train step's tier shapes,
    orders 1 and 2 at dist mode 20, with nonzero cotangents on all four
    outputs (dwout and dconfout exercise the weight and conf chains). Rows
    with a LeakyReLU input within KINK of 0 are masked out (no cotangent
    reaches their layers; see check_trunk_bwd). The six per-row cotangents
    are held at K2_ROW_TOL, with the atol of dxyz and dxyzp scaled per row
    as the front's backward scales K2's per-row errors (shade_bwd_scales),
    the weight gradients at K2_SUM_REL of their largest entry, and two
    launches must give bit-equal weight gradients."""
    from pointnerf_tpu_torch.ops import trunk as tt
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(4)
    L1, L3 = opt.shading_feature_mlp_layer1, opt.shading_feature_mlp_layer3
    nf, nd = opt.num_feat_freqs, abs(opt.dist_xyz_freq)
    Fe, H = opt.point_features_dim, opt.shading_feature_num
    rows = []
    for tier, K, n_pts in (("narrow", opt.k_tier if opt.k_tier > 0 else 1,
                            Ncb), ("wide", opt.K, NtB)):
        S = n_pts * K
        ins = shade_inputs(opt, S, K, g, dev)
        cts = [torch.randn(S // K, H, generator=g),
               torch.randn(S // K, 1, generator=g),
               torch.randn(S, 1, generator=g),
               torch.randn(S, 1, generator=g)]
        cts = [c.to(dev) for c in cts]
        for order1 in (False, True):
            ops = [o.detach() for o in tt.pack_trunk_params(
                agg, Fe, 6, nf, nd, with_alpha=not order1)]
            f = tt.shade_front(*ins[1:], 20, K)
            zs = tt.trunk_activations(L1, L3, nf, nd, ins[0], f.d_raw, f.ex3,
                                      ops, not order1)
            smooth = torch.ones(S, dtype=torch.bool, device=dev)
            for z in zs[2] + zs[4]:
                smooth &= (z.abs() >= KINK).all(dim=1)
            del f, zs
            rows_in = list(ins)
            rows_in[6] = ins[6] * smooth[:, None]
            args = (L1, L3, nf, nd, K, opt.act_super > 0, order1, 20,
                    *rows_in, ops, cts[0], None if order1 else cts[1],
                    cts[2], cts[3])
            got = tt.shade_bwd(*args)
            again = tt.shade_bwd(*args)
            want = tt.fused_shade_bwd_reference(*args)
            torch.cuda.synchronize()
            scales = shade_bwd_scales(rows_in, K)
            row_err = row_rel = sum_rel = 0.0
            errs = {}
            for name, a, b in zip(SHADE_GRADS, got[:6], want[:6]):
                assert_rows_close(f"K5 {name}", a, b, scales.get(name))
                diff = float((a - b).abs().max())
                errs[name] = f"{diff:.2e}"
                row_err = max(row_err, diff)
                row_rel = max(row_rel, diff / max(float(b.abs().max()),
                                                  1e-30))
            for a, b, c in zip(got[6], want[6], again[6]):
                if not torch.equal(a, c):
                    raise AssertionError("K5 weight gradients differ between "
                                         "two launches on the same inputs")
                rel = float((a - b).abs().max() / b.abs().max())
                if not rel <= K2_SUM_REL:
                    raise AssertionError(f"K5 weight gradient off by {rel:.3e}"
                                         f" of its largest entry")
                sum_rel = max(sum_rel, rel)
            ms, plain_ms = timed_pair(
                lambda: tt.shade_bwd(*args),
                lambda: tt.fused_shade_bwd_reference(*args))
            b_ms, b_by = bound(3 * 2 * S * trunk_macs(ops),
                               nbytes(*rows_in, *ops, *args[20:], *got[:6],
                                      *got[6]))
            log(f"K5 shade_bwd {tier} K={K} order={1 if order1 else 2} "
                f"dist_mode=20 rows={S}: per-row max_abs_err={row_err:.3e} "
                f"{errs} (atol scaled up to x{float(scales['dxyz'].max()):.0f}"
                f" for dxyz, x{float(scales['dxyzp'].max()):.2f} for dxyzp) "
                f"({S - int(smooth.sum())} rows within {KINK:g} of a "
                f"LeakyReLU kink masked) max_abs_err/max|plain|={row_rel:.3e},"
                f" weight grads max_abs_err/max|plain|={sum_rel:.3e}, dW "
                f"bit-equal over two launches; kernel={ms:.3f} ms "
                f"plain={plain_ms:.3f} ms bound={b_ms:.3f} ms ({b_by})")
            rows.append(dict(tier=tier, order=1 if order1 else 2,
                             err=row_err, ms=ms, plain_ms=plain_ms,
                             bound_ms=b_ms))
        del ins, cts
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
    # bytes: the depths (a broadcast axis read once), the rays and the mask;
    # the table lookups (one byte of a 9 MB L2-resident table per in-range
    # sample) are not counted. Operations: a dozen per sample.
    depths = int(np.prod([n for n, st in zip(t.shape, t.stride()) if st]))
    b_ms, b_by = bound(12 * t.numel(), 4 * depths + nbytes(campos, raydir)
                       + t.numel())
    log(f"K3 occupancy rays={rays} samples={t.numel()}: equal "
        f"(occupied share {float(want.float().mean()):.4f}) "
        f"kernel={ms:.3f} ms plain={plain_ms:.3f} ms bound={b_ms:.4f} ms "
        f"({b_by})")
    return dict(err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by)


def serve_path(opt, state, spec, grid, agg, ts, item, label, kerns):
    """The serving main path: one full image through render_image, twice
    (the first call warms the allocator and cuBLAS; the counts cover the
    second), then two of its chunks re-rendered on the CPU. Every kernel of
    `kerns` must launch, no other trunk kernel. Returns (launch counts, the
    image's maps, render stats)."""
    from pointnerf_tpu_torch.ops import kernels
    from pointnerf_tpu_torch.run import common
    from pointnerf_tpu_torch.train.trainer import ServeState
    chunk = opt.random_sample_size ** 2
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
    log(f"{label}: render 800x800: {1e3 * dt:.1f} ms/image, "
        f"{H * W / dt:.0f} rays/s, "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"hit share {hit.mean():.4f}, groups {stats['groups']}, "
        f"sr_overflow {stats['sr_overflow']}, "
        f"occ_overflow {stats['occ_overflow']}, launches {launches}")
    check_launches(label, kerns)
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
    log(f"{label}: CPU re-render of chunks {pick.tolist()} ({len(sel)} rays,"
        f" {int(hit.reshape(-1)[sel].sum())} hit): max_abs_err {cerr:.3e} "
        f"in {time.perf_counter() - t0:.1f} s")
    return launches, maps, stats


def check_launches(label, kerns):
    """Every kernel of `kerns` launched since the counts were reset, and no
    trunk kernel outside it (K1/K2 on the default paths, K4/K5 on the
    fused_shade ones)."""
    from pointnerf_tpu_torch.ops import kernels
    for k in kernels.KERNELS:
        if k in kerns and k.launches == 0:
            raise AssertionError(f"{label} never launched {k.name}")
        if k not in kerns and k is not kernels.OCCUPANCY and k.launches:
            raise AssertionError(f"{label} launched {k.name} "
                                 f"{k.launches} times")


def train_path(opt, state, spec, grid, label, kerns):
    """The training main path: create_train_state, one warm-up train_step
    and TRAIN_STEPS timed ones on bench.py's batch (the counts cover the
    timed steps; every kernel of `kerns` must launch, no other trunk
    kernel). The loss must be finite and fall from the first step to the
    last. Returns (launch counts, the train state, the batch, the losses)."""
    from pointnerf_tpu_torch.ops import kernels
    from pointnerf_tpu_torch.run.workload import make_train_batch
    from pointnerf_tpu_torch.train import trainer
    dev = torch.device("cuda")
    st = trainer.create_train_state(opt, state,
                                    torch.Generator().manual_seed(0))
    batch = make_train_batch(opt, dev)
    R = batch["raydir"].shape[1]
    _, items = trainer.train_step(st, grid, batch, opt, spec)
    steps = [items]
    for k in kernels.KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        _, items = trainer.train_step(st, grid, batch, opt, spec)
        steps.append(items)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / TRAIN_STEPS
    launches = {k.name: k.launches for k in kernels.KERNELS}
    losses = [float(i["loss_total"]) for i in steps]
    over = [int(i["sr_overflow"]) for i in steps[1:]]
    log(f"{label}: {R} rays/step, {1e3 * dt:.1f} ms/step, "
        f"{R / dt:.0f} train rays/s over {TRAIN_STEPS} steps, "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"sr_overflow per step {min(over)}-{max(over)}, launches {launches}")
    log(f"{label}: loss_total step 1 {losses[0]:.6f} -> step "
        f"{len(losses)} {losses[-1]:.6f}; items of the last step "
        f"{ {k: round(float(v), 6) for k, v in steps[-1].items()} }")
    check_launches(label, kerns)
    if not all(np.isfinite(float(v)) for i in steps for v in i.values()):
        raise AssertionError("a train step gave a non-finite loss item")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    return launches, st, batch, losses


def check_train_cpu(st, batch, opt, spec, grid, label):
    """One compute_grads on the card against the CPU's plain versions
    (use_fused_trunk=1; fused_shade as `opt` says) from the same state,
    batch and jitter draws: equal counters, losses within LOSS_RTOL, each
    gradient within GRAD_REL."""
    from pointnerf_tpu_torch.train import trainer
    u = trainer.jitter_draws(st, batch, opt)
    card = trainer.compute_grads(st, grid, batch, opt, spec, u)
    points = {k: (None if v is None else v.detach().cpu())
              for k, v in st.points.items()}
    cpu_st = trainer.make_train_state(copy.deepcopy(st.aggregator).cpu(),
                                      points, opt, torch.Generator(), st.step)
    on_cpu = lambda d: {k: (v.cpu() if torch.is_tensor(v) else v)
                        for k, v in d.items()}
    t0 = time.perf_counter()
    cpu = trainer.compute_grads(cpu_st, on_cpu(grid), on_cpu(batch),
                                opt.replace(use_fused_trunk=1), spec, u.cpu())
    cpu_s = time.perf_counter() - t0
    for k in ("sr_overflow", "occ_overflow"):
        if float(card[0][k]) != float(cpu[0][k]):
            raise AssertionError(f"{k} differs: card {float(card[0][k])}, "
                                 f"CPU {float(cpu[0][k])}")
    for k, v in cpu[0].items():
        np.testing.assert_allclose(float(card[0][k]), float(v),
                                   rtol=LOSS_RTOL, err_msg=k)
    worst, worst_abs = ("", 0.0), 0.0
    for part in (1, 2):
        for k, g in cpu[part].items():
            d = card[part][k].cpu() - g
            rel = float(d.norm() / g.norm()) if g.norm() > 0 \
                else float(d.norm())
            if not rel <= GRAD_REL:
                raise AssertionError(f"gradient of {k} off by {rel:.3e} "
                                     f"(||card - cpu|| / ||cpu||)")
            worst = max(worst, (k, rel), key=lambda t: t[1])
            worst_abs = max(worst_abs, float(d.abs().max()))
    log(f"{label}: card vs CPU compute_grads on the full "
        f"{batch['raydir'].shape[1]}-ray batch: loss_total "
        f"{float(card[0]['loss_total']):.7f} vs "
        f"{float(cpu[0]['loss_total']):.7f}; worst gradient {worst[0]} "
        f"||card - cpu||/||cpu|| {worst[1]:.3e}, max abs error "
        f"{worst_abs:.3e}; CPU {cpu_s:.1f} s")
    return worst[1]


# ------------------------------------------------------------ K6, K7 checks
def scatter_bad(got, want, abs_sum):
    """Entries of `got` off from `want` by more than SCATTER_REL of the sum
    of |updates| that reach them (the scale of a float sum's rounding in
    any order; 1e-30 absorbs denormals)."""
    return (got - want).abs() > SCATTER_REL * abs_sum + 1e-30


def check_scatter(label, idx, upd, n_rows):
    """K6 against scatter_add_rows_reference on the same inputs, each entry
    within SCATTER_REL of the sum of |updates| that reach it, so the
    tolerance follows the data at every shape (a train step's point
    gradients are ~1e-4, the script's updates ~1). The check must catch a
    scatter that drops one kept entry in 97: it is run on the plain version
    of such a scatter, which must fail it; the share of kept entries whose
    loss alone would fail it is printed. Also: the largest difference
    between two launches (float atomics sum in no fixed order), and the
    times of the kernel, the plain version and the library call
    `torch.zeros(n_rows, C).index_add_(0, idx, upd)` over the kept entries
    (filtered outside the timed region: index_add_ cannot skip). Bound:
    bytes, the indices and the kept updates read once and the table
    written once."""
    from pointnerf_tpu_torch.ops.scatter import (scatter_add_rows,
                                                 scatter_add_rows_reference)
    kern = lambda: scatter_add_rows(idx, upd, n_rows)
    plain = lambda: scatter_add_rows_reference(idx, upd, n_rows)
    keep = idx >= 0
    lib_idx, lib_upd = idx[keep].long(), upd[keep]
    library = lambda: torch.zeros((n_rows, upd.shape[1]),
                                  device=upd.device).index_add_(
        0, lib_idx, lib_upd)
    got, again, want = kern(), kern(), plain()
    abs_sum = scatter_add_rows_reference(idx, upd.abs(), n_rows)
    kept_at = torch.nonzero(keep)[:, 0]
    dropped = idx.clone()
    dropped[kept_at[::97]] = -1
    torch.cuda.synchronize()
    for what, out in (("K6", got), ("K6 again", again),
                      ("index_add_", library())):
        bad = scatter_bad(out, want, abs_sum)
        if bool(bad.any()):
            raise AssertionError(f"{what} differs from the plain version on "
                                 f"{int(bad.sum())} entries")
    if not bool(scatter_bad(scatter_add_rows_reference(dropped, upd, n_rows),
                            want, abs_sum).any()):
        raise AssertionError("the K6 check passes a scatter that drops one "
                             "kept entry in 97")
    caught = float((upd[keep].abs() > SCATTER_REL * abs_sum[idx[keep].long()]
                    ).any(dim=1).float().mean())
    err = float((got - want).abs().max())
    rerun = float((got - again).abs().max())
    top = float(want.abs().max())
    ms, plain_ms = timed_pair(kern, plain, reps=10)
    library_ms = cuda_time(library, 10)
    C = upd.shape[1]
    n_skip = int((~keep).sum())
    # skipped rows' updates are never read
    b_ms, b_by = bound(0, nbytes(idx) + 4 * C * (idx.shape[0] - n_skip)
                       + 4 * C * n_rows)
    log(f"K6 scatter_rows {label} S={idx.shape[0]} ({n_skip} skipped) "
        f"cap={n_rows} C={C}: max_abs_err={err:.3e} (max|plain| {top:.3e}; "
        f"each entry within {SCATTER_REL:g} of its sum of |updates|; a "
        f"scatter dropping one kept entry in 97 fails; the loss of any one "
        f"of {100 * caught:.2f}% of the kept entries alone would), two "
        f"launches differ by {rerun:.3e}; kernel={ms:.4f} ms "
        f"plain={plain_ms:.4f} ms index_add_ over the kept entries="
        f"{library_ms:.4f} ms bound={b_ms:.4f} ms ({b_by})")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms)


class ScatterRecorder:
    """Records the arguments of the point-gradient scatter calls of one
    compute_grads (neural_points' scatter_add_rows, wrapped for the call),
    so K6 is checked at the shapes and indices a train step gives it."""

    def __enter__(self):
        from pointnerf_tpu_torch.models import neural_points as npc
        self.calls, self._orig = [], npc.scatter_add_rows

        def record(idx, upd, n_rows):
            self.calls.append((idx.clone(), upd.clone(), n_rows))
            return self._orig(idx, upd, n_rows)
        npc.scatter_add_rows = record
        return self

    def __exit__(self, *exc):
        from pointnerf_tpu_torch.models import neural_points as npc
        npc.scatter_add_rows = self._orig


def check_row_select(dev):
    """K7 against row_select_reference at occ_micro3's shapes (bench.py's
    3,600-ray batch with jittered depths, D = 400, U = 96, LW = 128): each
    ray's gathered rows in int8 and bf16, Rt = 8/16/32/120 rays per CTA; the
    kernel must equal the plain version exactly. Then the segmented pipeline
    with K7 (its micro-benchmark's path; its launches are the ones
    reported) against the dense mask, equal on every ray with at most U
    distinct rows. Times the int8 Rt=16 launch against the plain version
    and the library call, one torch.gather over rows_g viewed [N, U·LW] at
    rank·LW + lane (the index computed outside the timed region). Bound:
    bytes of rows_g, rank, lane and the output."""
    from pointnerf_tpu_torch.ops import kernels
    from pointnerf_tpu_torch.ops.query import (mask_raypos, row_select,
                                               row_select_reference)
    from pointnerf_tpu_torch.scripts import occ_micro3 as om
    _, grid, spec, _, raypos, _ = om.bench_workload(dev)
    rows = grid["coor_occ_rows"]
    U, LW = OCC_U, rows.shape[-1]
    inb, rid, lane, is_start, rank = om.stages(raypos, spec, LW)
    rank_c = torch.clamp(rank, max=U - 1)
    c = om.ray_rows(rid, is_start, rank, U).reshape(-1).long()
    N, D = rank.shape
    out = None
    for dtype in (torch.int8, torch.bfloat16):
        rows_g = rows.to(dtype)[c].reshape(N, U, LW)
        want = row_select_reference(rows_g, rank_c, lane)
        for Rt in (8, 16, 32, 120):
            got = row_select(rows_g, rank_c, lane, Rt)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"K7 {dtype} Rt={Rt} differs from the "
                                     f"plain version on "
                                     f"{int((got != want).sum())} samples")
        if dtype == torch.int8:
            flat = rows_g.reshape(N, U * LW)
            gidx = (rank_c * LW + lane).long()
            ms, plain_ms = timed_pair(
                lambda: row_select(rows_g, rank_c, lane, 16),
                lambda: row_select_reference(rows_g, rank_c, lane), reps=10)
            library_ms = cuda_time(lambda: torch.gather(flat, 1, gidx), 10)
            # int32 rank and lane in, float32 out
            b_ms, b_by = bound(0, nbytes(rows_g) + 12 * N * D)
            out = dict(err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                       bound_by=b_by, library_ms=library_ms)
            log(f"K7 row_select int8 and bf16 rows, Rt 8/16/32/120, N={N} "
                f"D={D} U={U} LW={LW}: equal to the plain version; int8 Rt=16 "
                f"kernel={ms:.4f} ms plain={plain_ms:.4f} ms "
                f"gather={library_ms:.4f} ms bound={b_ms:.4f} ms ({b_by})")
        del rows_g
    dense = mask_raypos(raypos, grid, spec)
    kernels.ROW_SELECT.launches = 0
    seg, over = om.segmented_mask(raypos, grid, spec, U, torch.int8, 16)
    out["launches"] = kernels.ROW_SELECT.launches
    keep = ~over.reshape(dense.shape[:2])
    if not torch.equal(dense[keep], seg[keep]):
        raise AssertionError("the segmented mask with K7 differs from the "
                             "dense mask on rays within U rows")
    log(f"K7 segmented pipeline vs dense mask: equal on the "
        f"{int(keep.sum())} rays within U={U} distinct rows; "
        f"{int(over.sum())} rays past U (max distinct rows "
        f"{int(rank.max()) + 1})")
    return out


# ------------------------------------------------------- the finetune phase
def finetune_options(root):
    """The lego preset at full widths on the plate scene, with the
    finetune phase's cadence: FT_STEPS steps, one prune, a probe-and-grow
    every FT_PROBE steps (opacity gate FT_PROB_THRESH), one checkpoint at
    the end, test renders of the 4 test views before and after."""
    from pointnerf_tpu_torch.config import nerf_synth_preset
    return nerf_synth_preset("lego").replace(
        data_root=root, scan="plate", img_wh=(FT_WH, FT_WH), load_points=1,
        checkpoints_dir=os.path.join(root, "checkpoints"),
        experiment="plate_ft", maximum_step=FT_STEPS, prune_iter=FT_PRUNE,
        prune_max_iter=FT_PRUNE, prob_freq=FT_PROBE, print_freq=100,
        save_iter_freq=10 * FT_STEPS, save_point_freq=0, test_freq=0,
        test_num=4, prob_thresh=FT_PROB_THRESH)


def finetune_path(root):
    """The finetune driver's main path on the card: train_ft.main at the
    lego preset's widths on the plate scene (prune, probe-and-grow, final
    checkpoint), with the PSNR of a test render of the initial state before
    it, then main again, which must resume from the checkpoint and stop at
    once. Returns the launch counts of the first main."""
    from pointnerf_tpu_torch.data import create_dataset
    from pointnerf_tpu_torch.ops import kernels
    from pointnerf_tpu_torch.run import common, train_ft
    from pointnerf_tpu_torch.run.workload import make_plate_scene
    from pointnerf_tpu_torch.train import trainer
    from pointnerf_tpu_torch.utils.visualizer import Visualizer
    n_written = make_plate_scene(root, wh=(FT_WH, FT_WH))
    opt = finetune_options(root)
    dev = torch.device("cuda")
    train_ds = create_dataset(opt, "train")
    state = common.init_point_state_from_dataset(opt, train_ds, device=dev)
    n_init = int(state["mask"].sum())
    st = trainer.create_train_state(opt, state,
                                    torch.Generator().manual_seed(opt.seed))
    spec, grid = common.make_spec_and_grid(opt, state)
    psnr0 = train_ft.test(st, grid, opt, spec, create_dataset(opt, "test"),
                          Visualizer(opt), 0, write_images=False)
    del st, state, grid, train_ds
    torch.cuda.empty_cache()
    log(f"finetune: plate scene {FT_WH}x{FT_WH}, 12 train / 4 test views, "
        f"{n_written} init points -> {n_init} after the voxel downsample "
        f"(vox_res {opt.vox_res}); lr {opt.lr} plr {opt.plr}; test PSNR "
        f"before training {psnr0:.3f}")
    for k in kernels.KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = train_ft.main(opt)
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels.KERNELS}
    tm = res["timing"]
    ms = 1e3 * tm["train_s"] / tm["steps"]
    R = opt.random_sample_size ** 2
    log(f"finetune: {tm['steps']} steps, {ms:.1f} ms/step, {1e3 * R / ms:.0f}"
        f" train rays/s ({R} rays a step, host clock around each step and "
        f"its items' fetch), wall {wall:.1f} s (prunes {tm['prune_s']:.1f} s, "
        f"probe-and-grows {tm['grow_s']:.1f} s, test renders "
        f"{tm['test_s']:.1f} s, checkpoints {tm['save_s']:.1f} s, the rest "
        f"{wall - sum(tm[k] for k in PHASES):.1f} s); prune (step, before, "
        f"after) "
        f"{tm['prune']}, grow {tm['grow']}; final test PSNR "
        f"{res['final_psnr']:.3f} (before training {psnr0:.3f}), scores "
        f"{ {k: round(v, 4) for k, v in res['scores'].items()} }; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{launches}")
    check_launches("finetune", (kernels.TRUNK_FWD, kernels.TRUNK_BWD,
                                kernels.OCCUPANCY, kernels.SCATTER_ROWS))
    ckpt = os.path.join(opt.checkpoints_dir, opt.experiment)
    for f in (f"{FT_STEPS}_net_ray_marching.npz", f"{FT_STEPS}_states.npz",
              f"{FT_STEPS}_full.npz", "log.txt"):
        if not os.path.exists(os.path.join(ckpt, f)):
            raise AssertionError(f"finetune wrote no {f}")
    if res["total_steps"] != FT_STEPS or not tm["prune"] or not tm["grow"]:
        raise AssertionError("the finetune did not run its steps, one prune "
                             "and a probe-and-grow")
    if not (res["final_psnr"] > FT_PSNR and res["final_psnr"] > psnr0):
        raise AssertionError(f"final test PSNR {res['final_psnr']:.3f} not "
                             f"above {FT_PSNR} and the initial {psnr0:.3f}")
    del res
    torch.cuda.empty_cache()
    res2 = train_ft.main(opt)
    log(f"finetune resume: total_steps {res2['total_steps']}, "
        f"{res2['timing']['steps']} steps run, final test PSNR "
        f"{res2['final_psnr']:.3f}")
    if res2["total_steps"] != FT_STEPS or res2["timing"]["steps"] != 0:
        raise AssertionError("the second main did not resume and stop")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pointnerf_tpu_torch.models.renderer import effective_sr_budget
    from pointnerf_tpu_torch.ops import kernels

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
        if ("==" in line or "registers" in line or "spill" in line
                or "error" in line):
            log("  ptxas:", line.strip())

    opt, state, spec, grid, agg, ts, item, grid_ms = build_workload(
        torch.device("cuda"))
    log(f"grid build on card: {grid_ms:.1f} ms, "
        f"vdim {spec.vdim}, occupied voxels {int(grid['num_occ'])}")

    # kernels against their plain versions: K1, K3 and K4 at one serving
    # group's shapes, K2 and K5 at one train step's
    from pointnerf_tpu_torch.models.aggregator import init_aggregator_params
    dev = torch.device("cuda")
    chunk = opt.random_sample_size ** 2
    tier_rows = lambda rows: (
        effective_sr_budget(opt, rows),
        min(effective_sr_budget(opt, rows),
            max(128, int(round(effective_sr_budget(opt, rows)
                               * opt.k_tier_wide_frac)))))
    agg0 = init_aggregator_params(opt.replace(agg_dist_pers=0),
                                  torch.Generator().manual_seed(5), device=dev)
    with torch.inference_mode():
        k1 = check_trunk(agg, opt, *tier_rows(GROUP * chunk * opt.SR))
        k3 = check_occupancy(item, grid, spec, opt, GROUP * chunk)
        k4 = check_shade({20: agg, 0: agg0}, opt,
                         *tier_rows(GROUP * chunk * opt.SR))
    k2 = check_trunk_bwd(agg, opt, *tier_rows(chunk * opt.SR))
    k5 = check_shade_bwd(agg, opt, *tier_rows(chunk * opt.SR))
    del agg0
    torch.cuda.empty_cache()
    # K6 at its script's shapes (its train-step shapes follow the train
    # path), K7 at occ_micro3's
    from pointnerf_tpu_torch.scripts.scatter_pallas import script_inputs
    idx_np, upd_np = script_inputs(**SCATTER_SCRIPT)
    check_scatter("scatter_pallas.py shapes (dup 6)",
                  torch.as_tensor(idx_np, device=dev),
                  torch.as_tensor(upd_np, device=dev), SCATTER_SCRIPT["cap"])
    del idx_np, upd_np
    k7 = check_row_select(dev)
    torch.cuda.empty_cache()

    # the main paths, default (K1, K2, K3, K6 in training) then fused_shade
    # (K4, K5, K3, K6 in training)
    shade_opt = opt.replace(fused_shade=1)
    default_k = (kernels.TRUNK_FWD, kernels.OCCUPANCY, kernels.TRUNK_BWD,
                 kernels.SCATTER_ROWS)
    shade_k = (kernels.SHADE_FWD, kernels.OCCUPANCY, kernels.SHADE_BWD,
               kernels.SCATTER_ROWS)
    serve, maps, stats = serve_path(opt, state, spec, grid, agg, ts, item,
                                    "serve", default_k[:2])
    torch.cuda.empty_cache()
    serve_s, maps_s, stats_s = serve_path(shade_opt, state, spec, grid, agg,
                                          ts, item, "serve fused_shade",
                                          shade_k[:2])
    diff = float(np.abs(maps_s["coarse_raycolor"]
                        - maps["coarse_raycolor"]).max())
    log(f"serve fused_shade vs default image: max_abs_diff {diff:.3e}; "
        f"sr_overflow {stats_s['sr_overflow']} vs {stats['sr_overflow']}, "
        f"occ_overflow {stats_s['occ_overflow']} vs {stats['occ_overflow']}")
    if not diff <= SHADE_IMAGE_TOL:
        raise AssertionError(f"the fused_shade image differs by {diff:.3e}")
    for k in ("sr_overflow", "occ_overflow"):
        if stats_s[k] != stats[k]:
            raise AssertionError(f"{k} differs between the configurations")
    del maps, maps_s
    torch.cuda.empty_cache()
    train, st, batch, losses = train_path(opt, state, spec, grid, "train",
                                          default_k)
    check_train_cpu(st, batch, opt, spec, grid, "train")
    from pointnerf_tpu_torch.train import trainer
    with ScatterRecorder() as rec:
        trainer.compute_grads(st, grid, batch, opt, spec,
                              trainer.jitter_draws(st, batch, opt))
    log(f"train step's point-gradient scatters: S "
        f"{[c[0].shape[0] for c in rec.calls]}, cap {rec.calls[0][2]}")
    k6 = check_scatter("one train step's wide tier",
                       *max(rec.calls, key=lambda c: c[0].shape[0]))
    del st, rec
    torch.cuda.empty_cache()
    train_s, st, batch, losses_s = train_path(shade_opt, state, spec, grid,
                                              "train fused_shade", shade_k)
    check_train_cpu(st, batch, shade_opt, spec, grid, "train fused_shade")
    rel = abs(losses_s[0] - losses[0]) / abs(losses[0])
    log(f"train fused_shade vs default: step-1 loss_total {losses_s[0]:.7f} "
        f"vs {losses[0]:.7f} (relative difference {rel:.3e})")
    if not rel <= STEP1_RTOL:
        raise AssertionError(f"the fused_shade step-1 loss differs by {rel}")
    del st, batch, state, grid, ts, agg
    torch.cuda.empty_cache()

    # the finetune driver at lego widths: K1, K2, K3, K6
    import tempfile
    with tempfile.TemporaryDirectory() as root:
        finetune = finetune_path(root)

    runs = (serve, serve_s, train, train_s, finetune)
    report = {"kernels": []}
    for k, rows in ((kernels.TRUNK_FWD, k1), (kernels.TRUNK_BWD, k2),
                    (kernels.OCCUPANCY, k3), (kernels.SHADE_FWD, k4),
                    (kernels.SHADE_BWD, k5), (kernels.SCATTER_ROWS, k6),
                    (kernels.ROW_SELECT, k7)):
        if isinstance(rows, dict):
            err, by, library_ms = rows["err"], rows["bound_by"], \
                rows.get("library_ms")
            ms, plain_ms, b_ms = rows["ms"], rows["plain_ms"], \
                rows["bound_ms"]
        else:
            err, by, library_ms = max(r["err"] for r in rows), \
                "operations", None
            ms, plain_ms, b_ms = tier_sums(rows)
        launches = rows["launches"] if k is kernels.ROW_SELECT else \
            sum(run[k.name] for run in runs)
        report["kernels"].append(
            {"name": k.name, "route": "cuda", "source": k.source,
             "replaces": k.replaces, "launches": launches,
             "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": b_ms, "bound_by": by, "library_ms": library_ms})
    log(json.dumps(report))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
