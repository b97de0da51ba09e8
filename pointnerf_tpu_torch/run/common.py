"""Shared driver machinery: CLI options, point-cloud init, full-image
rendering (port of `pointnerf_tpu/run/common.py`).

Reference anchors: run/train_ft.py:51-167 (BRANCH B, the MVS point
init), :636-732 (BRANCH C point loading), :252-414 (chunked test render),
models/mvs/mvs_utils.py:537-561 (voxel downsample). Not ported (raise):
the pickled surface cloud (`cloud_path`, ROADMAP §1 item 6), sensor-depth
points (`load_points` 2 and 3) and `comb_file` (item 7).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import PRESETS, Options, validate_options
from ..data.ply import read_ply_points
from ..models import neural_points as npc
from ..models.renderer import effective_sr_budget
from ..ops.frustum import build_frustum_grid
from ..ops.grid import build_grid, make_grid_spec
from ..train import trainer

CONST_BATCH_KEYS = ("campos", "camrotc2w", "bg_color")
# the probe render's maps (reference probe_hole, train_ft.py:470-494)
PROBE_KEYS = ("coarse_raycolor", "ray_mask", "ray_max_sample_loc_w",
              "ray_max_far_dist", "ray_max_shading_opacity",
              "shading_avg_color", "shading_avg_dir", "shading_avg_conf",
              "shading_avg_embedding")


# ----------------------------------------------------------------- CLI plumbing
def options_from_cli(argv=None, base: Optional[Options] = None) -> Options:
    """argparse over the Options dataclass, one flag per field with the
    reference's names (reference: options/base_options.py), on top of
    --preset name[:scan] or --config opt.json."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--preset", type=str, default="",
                        help="preset name, e.g. nerf_synth:lego")
    parser.add_argument("--config", type=str, default="",
                        help="path to an Options json")
    known, unknown = parser.parse_known_args(argv)
    if known.config:
        with open(known.config) as f:
            base = Options.from_json(f.read())
    elif known.preset:
        name, _, scan = known.preset.partition(":")
        base = PRESETS[name](scan or "lego")
    base = base or Options()

    fields = {f.name: f for f in dataclasses.fields(Options)}
    over = argparse.ArgumentParser()
    for name in fields:
        cur = getattr(base, name)
        if isinstance(cur, bool):
            over.add_argument(f"--{name}", type=int, default=None)
        elif isinstance(cur, tuple):
            elem = float if (len(cur) and isinstance(cur[0], float)) else \
                (int if (len(cur) and isinstance(cur[0], int)) else str)
            over.add_argument(f"--{name}", type=elem, nargs="*", default=None)
        elif cur is None:
            over.add_argument(f"--{name}", type=str, default=None)
        else:
            over.add_argument(f"--{name}", type=type(cur), default=None)
    ns = over.parse_args(unknown)
    kw = {}
    for name in fields:
        v = getattr(ns, name)
        if v is None:
            continue
        cur = getattr(base, name)
        if isinstance(cur, bool):
            v = bool(v)
        elif isinstance(cur, tuple):
            v = tuple(v)
        elif cur is None and name == "max_o":
            v = int(v)
        elif cur is None and name in ("mvs_lr", "far_plane_shift"):
            v = float(v)
        kw[name] = v
    return validate_options(base.replace(**kw) if kw else base)


def run_cli(main, argv=None):
    """A driver's command line: --device (default cuda) and the Options
    flags (`options_from_cli`), handed to main(opt, device=...)."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--device", default="cuda")
    known, rest = ap.parse_known_args(argv)
    return main(options_from_cli(rest), device=known.device)


# ------------------------------------------------------------- point-cloud init
def construct_vox_points_closest(xyz: np.ndarray, vox_res: int,
                                 ranges: Optional[np.ndarray] = None
                                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Voxel downsample keeping the point nearest each voxel's centroid
    (reference: mvs_utils.construct_vox_points_closest, mvs_utils.py:537-
    561). A sort keyed (voxel, distance) makes each voxel's first element
    its winner, ties to the lowest original index. Returns (kept xyz
    float32, kept indices, ascending)."""
    xyz = np.asarray(xyz, np.float64)
    if ranges is None:
        mn, mx = xyz.min(0), xyz.max(0)
    else:
        mn, mx = np.asarray(ranges[:3]), np.asarray(ranges[3:])
    vsize = np.maximum(mx - mn, 1e-9).max() / vox_res
    coords = np.floor((xyz - mn) / vsize).astype(np.int64)
    dims = coords.max(0) + 1
    lin = (coords[:, 0] * dims[1] + coords[:, 1]) * dims[2] + coords[:, 2]

    order = np.argsort(lin, kind="stable")
    lin_s = lin[order]
    starts = np.flatnonzero(np.concatenate([[True], lin_s[1:] != lin_s[:-1]]))
    counts = np.diff(np.concatenate([starts, [len(lin_s)]]))
    xyz_s = xyz[order]
    centroids = np.add.reduceat(xyz_s, starts, axis=0) / counts[:, None]
    seg_id = np.repeat(np.arange(len(starts)), counts)
    d = np.sum((xyz_s - centroids[seg_id]) ** 2, axis=-1)
    keep = order[np.lexsort((d, lin_s))][starts]
    keep.sort()
    return xyz[keep].astype(np.float32), keep


def _vox_partition(xyz: np.ndarray, vox_res: int, space_min=None,
                   space_max=None):
    """Centered cubic voxel partition (reference mvs_utils.py:484-500: edge
    1.05× the largest extent, centered on the cloud; given space_min/max
    the per-axis edge is reused so two clouds share one partition).
    Returns (int32 voxel coords, space_min, space_max)."""
    xyz = np.asarray(xyz, np.float64)
    if space_min is None:
        mn, mx = xyz.min(0), xyz.max(0)
        edge = np.max(mx - mn) * 1.05
        mid = (mx + mn) / 2
        space_min, space_max = mid - edge / 2, mid + edge / 2
    else:
        space_min = np.asarray(space_min, np.float64)
        space_max = np.asarray(space_max, np.float64)
        edge = space_max - space_min
    coords = np.floor((xyz - space_min) / (edge / vox_res)).astype(np.int32)
    return coords, space_min, space_max


def init_point_state_from_dataset(opt, dataset, device="cuda") -> Dict:
    """BRANCH C of the reference driver (train_ft.py:636-732) with the
    provided cloud (load_points 1): the dataset's points cropped to
    opt.ranges, voxel-downsampled, optionally resampled, then the
    per-point attributes (`_finish_point_state`), on `device`."""
    if opt.cloud_path:
        raise NotImplementedError("the pickled surface cloud (cloud_path) "
                                  "is not ported")
    if opt.load_points != 1:
        raise NotImplementedError(f"load_points {opt.load_points} is not "
                                  f"ported (sensor-depth points, ROADMAP "
                                  f"§1 item 7)")
    if opt.comb_file:
        raise NotImplementedError("comb_file is not ported (ROADMAP §1 "
                                  "item 7)")
    xyz = np.asarray(dataset.load_init_points())
    rgb = None
    path = os.path.join(opt.data_root, opt.scan,
                        "colmap_results/dense/fused.ply")
    if os.path.exists(path):
        _, rgb = read_ply_points(path)
        if rgb is not None and len(rgb) != len(xyz):
            rgb = None
    ranges = np.asarray(opt.ranges, np.float32)
    if ranges[0] > -99.0:
        keep = np.all((xyz >= ranges[:3]) & (xyz <= ranges[3:]), axis=-1)
        xyz = xyz[keep]
        rgb = rgb[keep] if rgb is not None else None
    if opt.vox_res > 0:
        xyz, idx = construct_vox_points_closest(xyz, opt.vox_res)
        rgb = rgb[idx] if rgb is not None else None
    if opt.resample_pnts > 0:
        # reference train_ft.py:698-704: 1 keeps the point nearest the
        # origin, N a random subsample of N points
        if opt.resample_pnts == 1:
            idx = np.argmin(np.linalg.norm(xyz, axis=-1))[None]
        else:
            idx = np.random.RandomState(opt.seed).permutation(
                len(xyz))[: opt.resample_pnts]
        xyz = xyz[idx]
        rgb = rgb[idx] if rgb is not None else None
    return _finish_point_state(opt, dataset, xyz, rgb, device)


def load_pretrained_mvsnet(path: str, device="cuda"):
    """The official-MVSNet depth-estimator checkpoint the reference
    finetune depends on (--pre_d_est MVSNet/model_000014.ckpt, reference
    mvs_points_model.py:51-73), read from the local file `path` (tensors
    only) into a new `MVSNet` on `device`."""
    from ..models.mvs.nets import MVSNet, import_official_mvsnet
    sd = torch.load(path, map_location="cpu", weights_only=True)
    net = MVSNet(torch.Generator()).to(device).eval().requires_grad_(False)
    return import_official_mvsnet(sd, net)


@torch.no_grad()
def gen_points_filter_embeddings(opt, dataset, mvs=None, device="cuda",
                                 stats: Optional[Dict] = None) -> Dict:
    """BRANCH B of the reference driver (run/train_ft.py:51-167): per view
    triplet, MVS depth → fusion → per-point embeddings (the kept rows), then
    a visual-hull alpha mask over the init views, a voxel downsample and
    the starting confidence; returns the padded point state on `device`
    (the card unless the caller names another).

    mvs: the nets (`MvsPoints`); built when None from a generator seeded
    with opt.seed, its MVSNet from opt.pre_d_est when that is set. The
    depth jitter (manual_std_depth > 0) draws from a generator of its own
    seeded with opt.seed. `stats`,
    if given, receives host seconds by phase (gen_points' mvs_s, fusion_s,
    embed_s over the triplets; hull_s, vox_s), the triplet count and the
    point counts after the keep (n_keep), the hull (n_hull) and the
    downsample (n_vox). A dataset with no view triplet (tt_ft) raises
    ValueError, as the JAX package's concatenation of no rows does."""
    from ..models.mvs import points_model as pm
    from ..models.mvs.fusion import alpha_masking

    if not dataset.view_id_list:
        raise ValueError(f"the MVS init (load_points 0) needs view triplets"
                         f" and dataset {opt.dataset_name} has none: use "
                         f"load_points 1")
    dev = torch.device(device)
    if mvs is None:
        mvs = pm.MvsPoints(opt, torch.Generator().manual_seed(opt.seed),
                           device=dev)
        if opt.pre_d_est:
            mvs.mvsnet = load_pretrained_mvsnet(opt.pre_d_est, dev)
    stats = {} if stats is None else stats
    jitter = torch.Generator().manual_seed(opt.seed)
    parts = {k: [] for k in ("xyz_w", "embedding", "color", "dir", "conf")}
    alphas, intr, w2cs = [], [], []
    n_trip = len(dataset.view_id_list)
    for ti in range(n_trip):
        sample = dataset.get_init_item(ti)
        out = pm.gen_points(mvs, opt, sample, generator=jitter, stats=stats)
        keep = out["keep"]
        for k in parts:
            parts[k].append(out[k][keep])
        del out
        alphas.append(sample["alphas"][0])
        intr.append(sample["intrinsics"][0])
        w2cs.append(sample["w2cs"][0])
    merged = {k: torch.cat(v, dim=0) for k, v in parts.items()}
    del parts
    stats.update(triplets=n_trip, n_keep=int(merged["xyz_w"].shape[0]))

    # visual hull over the init views (reference: train_ft.py:130-134)
    t0 = time.perf_counter()
    on = lambda a: torch.as_tensor(np.stack(a), device=dev)
    hull = alpha_masking(
        merged["xyz_w"], on(alphas), on(intr), on(w2cs),
        ranges=np.asarray(opt.ranges) if opt.ranges[0] > -99.0 else None)
    merged = {k: v[hull] for k, v in merged.items()}
    pm.synchronize(dev)
    t1 = time.perf_counter()
    stats["hull_s"] = t1 - t0
    stats["n_hull"] = int(merged["xyz_w"].shape[0])

    host = {k: v.cpu().numpy() for k, v in merged.items()}
    del merged
    if opt.vox_res > 0:
        _, idx = construct_vox_points_closest(host["xyz_w"], opt.vox_res)
        host = {k: v[idx] for k, v in host.items()}
    stats["vox_s"] = time.perf_counter() - t1
    stats["n_vox"] = int(host["xyz_w"].shape[0])
    if 0 < opt.default_conf <= 1.0:
        # uniform starting confidence (reference: neural_points.py:281-283)
        host["conf"] = np.full_like(host["conf"], opt.default_conf)
    return npc.create_point_cloud(
        host["xyz_w"], host["embedding"], host["color"],
        host["dir"][:, :3], host["conf"], device=dev)


def _finish_point_state(opt, dataset, xyz: np.ndarray,
                        rgb: Optional[np.ndarray], device="cuda") -> Dict:
    """Per-point attribute init (reference train_ft.py:706-732): the
    direction to the nearest train camera, embeddings by
    opt.feature_init_method from RandomState(opt.seed), conf
    opt.default_conf (0.3 if unset), colors from the ply or 0.5."""
    n = xyz.shape[0]
    campos, _ = dataset.get_campos_ray()
    d = xyz[:, None, :] - campos[None]                    # [N,V,3]
    nearest = np.argmin(np.linalg.norm(d, axis=-1), axis=-1)
    dirs = d[np.arange(n), nearest]
    dirs = dirs / (np.linalg.norm(dirs, axis=-1, keepdims=True) + 1e-6)

    method = opt.feature_init_method
    rng = np.random.RandomState(opt.seed)
    C = opt.point_features_dim
    if opt.point_init_emb_std > 0:
        emb = rng.normal(0, opt.point_init_emb_std, (n, C)).astype(np.float32)
    elif method == "zeros":
        emb = np.zeros((n, C), np.float32)
    elif method.startswith("gau"):
        emb = rng.normal(0, float(method.split("_")[1]), (n, C)).astype(
            np.float32)
    else:                                   # "rand" and the rest
        emb = rng.uniform(-0.5, 0.5, (n, C)).astype(np.float32)
    conf_val = opt.default_conf if opt.default_conf > 0 else 0.3
    conf = np.full((n, 1), conf_val, np.float32)
    color = rgb if rgb is not None else np.full((n, 3), 0.5, np.float32)
    return npc.create_point_cloud(xyz, emb, color, dirs.astype(np.float32),
                                  conf, device=device)


def chunks_of_item(item: Dict, chunk_rays: int):
    """Split a full-image item into fixed-size ray chunks (last chunk padded
    by repeating its last ray). Yields (sub_item, start, end)."""
    R = item["raydir"].shape[1]
    n_chunks = -(-R // chunk_rays)
    for ci in range(n_chunks):
        s = ci * chunk_rays
        e = min(s + chunk_rays, R)
        pad = chunk_rays - (e - s)
        sub = dict(item)
        for k in ("raydir", "pixel_idx", "gt_image", "bg_ray",
                  "gt_mask", "gt_depth"):
            if k in item:
                a = item[k][:, s:e]
                if pad:
                    a = np.concatenate([a, np.repeat(a[:, -1:], pad, axis=1)],
                                       axis=1)
                sub[k] = a
        yield sub, s, e


@torch.inference_mode()
def make_spec_and_grid(opt, state: Dict):
    """Grid spec from the live points' bounds, and the grid built on the
    points' device."""
    if opt.NN < 0:
        raise NotImplementedError("the NN<0 vox-grid query is not ported")
    mask = state["mask"].cpu().numpy()
    xyz = state["xyz"].cpu().numpy()[mask]
    spec = make_grid_spec(opt, points_min=xyz.min(0), points_max=xyz.max(0),
                          max_points=int(mask.sum()))
    return spec, build_grid(state["xyz"], state["mask"], spec)


@torch.inference_mode()
def render_image(ts: trainer.ServeState, grid, opt, spec, item: Dict,
                 keys: Tuple[str, ...] = ("coarse_raycolor", "ray_mask"),
                 group: int = 8, stats: Optional[Dict] = None,
                 prob: bool = False) -> Dict[str, np.ndarray]:
    """Chunked full-image render into [H,W,C] host maps (reference
    run/train_ft.py:283-322 test, :470-494 probe_hole).

    Chunks of random_sample_size² rays render `group` at a time as one wide
    eval_step over group·chunk rays. The probe render (`prob`, with
    keys=PROBE_KEYS) is uncompacted, so it renders chunk by chunk: one
    wide uncompacted group would gather [1, group·chunk, SR, K, 42] rows
    (≈390 MB a 3,600-ray chunk at lego widths). Eval never drops a
    valid shading row: a group whose compaction budget overflows is
    re-rendered up a static budget ladder (2x the budget, then compaction
    off), and the raised rung persists for the rest of the image.
    Rendering happens on the device that holds the points. On the frustum
    path (wcoord_query 0) `grid` may be None: the camera's perspective grid
    is then built once here and serves every group of the image (the
    reference rebuilds it per query_points call, query_point_indices.py:
    92-94). A `stats` dict, if given, receives the image's counters:
    sr_overflow (valid rows the first rung dropped, all re-rendered),
    occ_overflow and the group count; and where it builds the frustum
    grid, its host seconds (grid_s, the device synchronized) and occupied
    voxels (num_occ).
    """
    dev = ts.points["xyz"].device
    if opt.wcoord_query == 0 and (grid is None or "xyz_pers" not in grid):
        t0 = time.perf_counter()
        fgrid, xyz_pers = build_frustum_grid(
            ts.points["xyz"], ts.points["mask"],
            torch.as_tensor(np.asarray(item["camrotc2w"]), device=dev),
            torch.as_tensor(np.asarray(item["campos"]), device=dev), spec)
        grid = dict(fgrid, xyz_pers=xyz_pers)
        if stats is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            stats.update(grid_s=time.perf_counter() - t0,
                         num_occ=int(fgrid["num_occ"]))
    H, W = int(item["h"]), int(item["w"])
    chunk = opt.random_sample_size ** 2
    maps: Dict[str, np.ndarray] = {}
    pix = item["pixel_idx"][0].astype(np.int64)
    const_batch = {k: torch.as_tensor(np.asarray(item[k]), device=dev)
                   for k in CONST_BATCH_KEYS if k in item}
    const_batch["near"] = float(item["near"])
    const_batch["far"] = float(item["far"])
    group = max(1, int(group))

    S_chunk = chunk * opt.SR
    rungs = [opt]
    if int(opt.SR_budget) != 0:
        Nc_eff = effective_sr_budget(opt, S_chunk)
        if 0 < 2 * Nc_eff < S_chunk:
            rungs.append(opt.replace(SR_budget=2 * Nc_eff))
        rungs.append(opt.replace(SR_budget=0))
    rung = 0
    overflow = 0
    occ_overflow = 0
    n_groups = 0

    def run_group(pending, opt_used):
        stacked = {"raydir": torch.as_tensor(
            np.stack([p[0]["raydir"] for p in pending]), device=dev)}
        if int(opt_used.SR_budget) != 0 and not prob:
            # explicit budgets are per-chunk numbers: scale by the group
            if int(opt_used.SR_budget) > 0:
                opt_used = opt_used.replace(
                    SR_budget=int(opt_used.SR_budget) * len(pending))
            return trainer.eval_chunks_stacked(ts, grid, stacked, const_batch,
                                               opt_used, spec)
        # budget-off rung or probe: chunk-sized uncompacted renders
        return trainer.eval_chunks(ts, grid, stacked, const_batch, opt_used,
                                   spec, prob=prob)

    def finish(pending, rung_used):
        nonlocal rung, overflow, occ_overflow, n_groups
        outs = run_group(pending, rungs[rung_used])
        n_groups += 1
        while True:
            dropped = int(outs["sr_overflow"][: len(pending)].sum())
            if dropped == 0 or rung_used == len(rungs) - 1:
                break
            overflow += dropped
            rung_used += 1
            rung = max(rung, rung_used)
            outs = run_group(pending, rungs[rung_used])
        if "occ_overflow" in outs:
            occ_overflow += int(outs["occ_overflow"][: len(pending)].sum())
        host = {k: outs[k].cpu().numpy() for k in keys if k in outs}
        for ci, (_, s, e) in enumerate(pending):
            px, py = pix[s:e, 0], pix[s:e, 1]
            for key, full in host.items():
                arr = np.asarray(full[ci][0], np.float32)
                if arr.ndim == 1:
                    arr = arr[:, None]
                arr = arr[: e - s]
                if key not in maps:
                    maps[key] = np.zeros((H, W, arr.shape[-1]), np.float32)
                maps[key][py, px] = arr

    pending = []
    for sub, s, e in chunks_of_item(item, chunk):
        pending.append((sub, s, e))
        if len(pending) == group:
            finish(pending, rung)
            pending = []
    if pending:
        finish(pending, rung)
    if stats is not None:
        stats.update(sr_overflow=overflow, occ_overflow=occ_overflow,
                     groups=n_groups)
    if overflow > 0:
        print(f"[render_image] note: SR_budget overflow on {overflow} shading "
              f"rows; groups re-rendered up the budget ladder")
    return maps
