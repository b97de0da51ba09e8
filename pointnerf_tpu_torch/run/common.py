"""Shared driver machinery: CLI options, point-cloud init, full-image
rendering (port of `pointnerf_tpu/run/common.py`).

Reference anchors: run/train_ft.py:51-167 (BRANCH B, the MVS point
init), :636-732 (BRANCH C point loading: the provided cloud, sensor-depth
points and their merge, `comb_file`), :252-414 (chunked test render),
models/mvs/mvs_utils.py:484-561 (voxel partitions and downsamples),
models/neural_points/neural_points.py:240-262 (the pickled surface cloud,
`cloud_path`, snapped to a lattice for the NN < 0 vox-grid query).
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
from ..data.load_blender import apply_point_noise, load_blender_cloud
from ..data.ply import read_ply_points
from ..models import neural_points as npc
from ..models.renderer import effective_sr_budget, wide_budget
from ..ops.frustum import build_frustum_grid
from ..ops.grid import build_grid, make_grid_spec
from ..ops.voxgrid import construct_grid_points, derive_lattice
from ..train import trainer
from ..utils import profiling

RAY_CHUNK_KEYS = ("raydir", "gt_image", "bg_ray")
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


def _unique_rows(coords: np.ndarray):
    """np.unique(coords, axis=0, return_inverse=True) of int voxel coords
    [N, 3], through one int64 key a row: the key orders rows as the
    row-wise sort does, so the unique rows and the inverse are the same."""
    c = coords.astype(np.int64) - coords.min(0)
    dims = c.max(0) + 1
    key = (c[:, 0] * dims[1] + c[:, 1]) * dims[2] + c[:, 2]
    _, first, inv = np.unique(key, return_index=True, return_inverse=True)
    return coords[first], inv.reshape(-1).astype(np.int64)


def construct_vox_points_xyz(xyz: np.ndarray, vox_res: int,
                             space_min=None, space_max=None) -> np.ndarray:
    """Voxel downsample to per-voxel centroids (reference
    mvs_utils.construct_vox_points_xyz, mvs_utils.py:503-518; used by the
    ScanNet per-frame depth back-projection, scannet_ft_dataset.py:444)."""
    xyz = np.asarray(xyz, np.float64)
    coords, _, _ = _vox_partition(xyz, vox_res, space_min, space_max)
    _, inv = _unique_rows(coords)
    order = np.argsort(inv, kind="stable")
    inv_s = inv[order]
    starts = np.flatnonzero(np.concatenate([[True], inv_s[1:] != inv_s[:-1]]))
    counts = np.diff(np.concatenate([starts, [len(inv_s)]]))
    sums = np.add.reduceat(xyz[order], starts, axis=0)
    return (sums / counts[:, None]).astype(np.float32)


def construct_vox_points_ind(xyz: np.ndarray, vox_res: int,
                             space_min=None, space_max=None):
    """Voxel ids for the cross-cloud occupancy filter (reference
    mvs_utils.construct_vox_points_ind, mvs_utils.py:520-535): (unique
    voxel coords [V, 3] int32, each point's index into them [N],
    space_min, space_max)."""
    coords, smin, smax = _vox_partition(xyz, vox_res, space_min, space_max)
    uniq, inv = _unique_rows(coords)
    return uniq, inv, smin, smax


def filter_depth_by_pc_occupancy(pc_xyz: np.ndarray, depth_xyz: np.ndarray,
                                 filter_res: int = 100) -> np.ndarray:
    """The depth points whose voxel holds no point of the provided cloud,
    in one partition of both (reference run/train_ft.py:656-672: the
    load_points 3 merge, a dense 0/1 mask over the union of their voxel
    boxes)."""
    pc_gid, _, smin, smax = construct_vox_points_ind(pc_xyz, filter_res)
    d_gid, d_inv, _, _ = construct_vox_points_ind(
        depth_xyz, filter_res, space_min=smin, space_max=smax)
    all_g = np.concatenate([pc_gid, d_gid], 0).astype(np.int64)
    mn = all_g.min(0)
    dims = all_g.max(0) - mn + 1

    def lin(g):
        g = g.astype(np.int64) - mn
        return (g[:, 0] * dims[1] + g[:, 1]) * dims[2] + g[:, 2]

    occupied = np.zeros(int(dims.prod()), bool)
    occupied[lin(pc_gid)] = True
    keep = ~occupied[lin(d_gid)[d_inv]]
    return np.asarray(depth_xyz)[keep]


def init_point_state_from_dataset(opt, dataset, device="cuda") -> Dict:
    """BRANCH C of the reference driver (train_ft.py:636-732): the starting
    points by `load_points` (1: the dataset's cloud, with fused.ply colours
    where they match; 2: sensor-depth points back-projected per frame at
    vox_res 100; 3: the dataset's cloud plus the depth points, at per-frame
    vox_res 80, that lie in voxels the cloud leaves empty at 100; a dataset
    without depth points takes its cloud for 2 and 3), plus a `comb_file`
    cloud (its colours dropped); cropped to opt.ranges (for 3, each source
    alone, which drops the comb points, as the JAX package does),
    voxel-downsampled (for 3, source i at vox_res / 1.5^i), optionally
    resampled, then the per-point attributes (`_finish_point_state`), on
    `device`. A `cloud_path` pickle takes the place of all of it (JAX
    run/common.py:257-270): num_point samples drawn with replacement and
    the point_noise jitter, both from RandomState(opt.seed), then with
    construct_res > 0 the lattice of `construct_grid_points`; no crop,
    downsample or resample."""
    if opt.cloud_path:
        rng_cloud = np.random.RandomState(opt.seed)
        xyz, _ = load_blender_cloud(opt.cloud_path, opt.num_point, rng_cloud)
        xyz = apply_point_noise(xyz, opt.point_noise, rng_cloud)
        if opt.construct_res > 0:
            xyz, _ = construct_grid_points(xyz, opt.construct_res,
                                           opt.grid_res)
        return _finish_point_state(opt, dataset, xyz.astype(np.float32),
                                   None, device)
    rgb = None
    sources = None
    depth_points = getattr(dataset, "load_init_depth_points", None)
    if opt.load_points == 2 and depth_points is not None:
        xyz = np.asarray(depth_points(vox_res=100))
    elif opt.load_points == 3 and depth_points is not None:
        pts = np.asarray(dataset.load_init_points())
        depth = np.asarray(depth_points(vox_res=80))
        depth = filter_depth_by_pc_occupancy(pts, depth, filter_res=100)
        sources = [pts.astype(np.float32), depth.astype(np.float32)]
        xyz = np.concatenate(sources, 0)
    else:
        xyz = np.asarray(dataset.load_init_points())
        path = os.path.join(opt.data_root, opt.scan,
                            "colmap_results/dense/fused.ply")
        if os.path.exists(path):
            _, rgb = read_ply_points(path)
            if rgb is not None and len(rgb) != len(xyz):
                rgb = None
    if opt.comb_file:
        # reference nerf_synth360_ft_dataset load_init_points, :366-371
        extra = np.loadtxt(opt.comb_file, delimiter=";")
        xyz = np.concatenate([xyz, extra[:, :3].astype(np.float32)], axis=0)
        rgb = None
    ranges = np.asarray(opt.ranges, np.float32)
    if ranges[0] > -99.0:
        def inside(p):
            return np.all((p >= ranges[:3]) & (p <= ranges[3:]), axis=-1)
        if sources is not None:
            sources = [p[inside(p)] for p in sources]
            xyz = np.concatenate(sources, 0)
        else:
            keep = inside(xyz)
            xyz = xyz[keep]
            rgb = rgb[keep] if rgb is not None else None
    if opt.vox_res > 0:
        if sources is not None:
            xyz = np.concatenate(
                [construct_vox_points_closest(
                    p, max(1, int(opt.vox_res / 1.5 ** i)))[0]
                 for i, p in enumerate(sources) if len(p)], 0)
        else:
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
    points' device. NN < 0: the spec also carries the lattice (origin,
    pitch, dims) derived from the live points, and the grid its corner
    table (JAX run/common.py:374-384)."""
    mask = state["mask"].cpu().numpy()
    xyz = state["xyz"].cpu().numpy()[mask]
    spec = make_grid_spec(opt, points_min=xyz.min(0), points_max=xyz.max(0),
                          max_points=int(mask.sum()))
    if opt.NN < 0:
        mn, pitch, dims = derive_lattice(xyz)
        spec = dataclasses.replace(
            spec, vox_dim=tuple(int(d) for d in dims),
            vox_space_min=tuple(float(v) for v in mn), vox_gvs=pitch)
    return spec, build_grid(state["xyz"], state["mask"], spec)


@torch.inference_mode()
def render_image(ts: trainer.ServeState, grid, opt, spec, item: Dict,
                 keys: Tuple[str, ...] = ("coarse_raycolor", "ray_mask"),
                 group: int = 8, stats: Optional[Dict] = None,
                 prob: bool = False, runner=None) -> Dict[str, np.ndarray]:
    """Chunked full-image render into [H,W,C] host maps (reference
    run/train_ft.py:283-322 test, :470-494 probe_hole).

    Chunks of random_sample_size² rays render `group` at a time as one wide
    eval_step over group·chunk rays. The probe render (`prob`, with
    keys=PROBE_KEYS) is uncompacted, so it renders chunk by chunk: one
    wide uncompacted group would gather [1, group·chunk, SR, K, 42] rows
    (≈390 MB a 3,600-ray chunk at lego widths). Eval never drops a
    valid shading row: a group whose compaction budget overflows is
    re-rendered up the budget ladder: rung 0 the configured budget,
    rung 1 a budget sized from the overflow, rung 2 compaction off. A
    render at Ncb compaction rows and NtB wide-tier rows that drops d
    rows (its sr_overflow: c past the compaction, w past the wide tier)
    drops none at Ncb + d and NtB + d: the compaction needs at most
    Ncb + c rows, and the wide tier at most NtB + w + c, even if every
    row the compaction dropped is wide. Rung 1 is that budget: a
    per-chunk SR_budget rounded up to 128 rows (with comp_groups G, each
    group's Ncb grows by d, the budget by G·d) and a k_tier_wide_frac
    that gives the wide tier at least NtB + d. Only a sized budget that
    reaches the group's rows goes to rung 2. The raised rung persists for
    the rest of the image at the largest size it has needed: a later
    group that still drops rows is sized again from its own render.
    Rendering happens on the device that holds the points. On the frustum
    path (wcoord_query 0) `grid` may be None: the camera's perspective grid
    is then built once here and serves every group of the image (the
    reference rebuilds it per query_points call, query_point_indices.py:
    92-94). A `stats` dict, if given, receives the image's counters:
    sr_overflow (valid rows its renders dropped, all re-rendered),
    occ_overflow and the group count; per rung of the ladder, the groups
    that finished there (rung_groups, summing to groups) and the trunk
    rows with a valid neighbor and trunk slots its renders ran
    (trunk_rows, trunk_slots; `models.renderer`'s counts, every attempt's);
    sized_budget, rung 1's last per-chunk budget (0: never sized); and
    where it builds the frustum grid, its host seconds (grid_s, the
    device synchronized) and occupied voxels (num_occ).

    Traced (`utils.profiling`): spans ``render.image``, ``render.group``
    (one a render of a group, from stacking its chunks to the read of its
    overflow, which syncs: attrs rung, dropped, budget and wide, its
    compaction and wide-tier rows, 0 uncompacted) and ``render.readback``
    (the outputs to the host, into the maps); the row counts, read with
    the overflow in one transfer, add to the trace record's counters with
    ``render.groups.r<rung>`` and ``render.resized`` (renders whose budget
    was sized from an overflow).

    Mesh serving (a `parallel.MeshRunner`, every rank calling with its
    placed state and grid): the point shards and bucket tables are joined
    once per image; each group's wide batch splits over the ray shards
    (comp_groups set to their number unless the user set it, so each rank
    compacts and shades its own rays into its own budget slices; under
    NN < 0 the wide batch's one budget is shared across the ranks in ray
    order, `Mesh.row_prefix`; a chunk the shards do not divide raises
    ValueError), the uncompacted renders split each chunk, and the ray
    outputs are gathered, so every rank holds the image. The budget
    ladder reads the whole image's overflow (each rank's dropped rows,
    summed): every rank takes the same rung. The frustum query is
    single-device (ValueError), as in the JAX package.
    """
    plane = 1
    if runner is not None:
        if opt.wcoord_query == 0:
            raise ValueError("mesh serving needs the world-coordinate query: "
                             "the frustum path (wcoord_query 0) renders on "
                             "one device")
        mesh = runner.mesh
        plane = mesh.plane
        if (opt.random_sample_size ** 2) % plane:
            raise ValueError(f"a chunk of {opt.random_sample_size ** 2} rays "
                             f"does not split over {plane} ray shards "
                             f"(random_sample_size)")
        if int(getattr(opt, "comp_groups", 1)) == 1 and plane > 1:
            opt = opt.replace(comp_groups=plane)
        ts = runner.whole_points(ts)
        grid = runner.whole_grid(grid)
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
    # rung 1's options are sized from an overflow (`sized`), persisted here
    rungs = [opt, None, opt.replace(SR_budget=0)]
    # the compaction groups a budget splits over: comp_groups on the
    # world-coordinate KNN query; the frustum and vox-grid paths compact
    # each camera row into one budget
    G = max(1, int(getattr(opt, "comp_groups", 1))) \
        if opt.wcoord_query != 0 and opt.NN >= 0 else 1
    tiered = int(getattr(opt, "k_tier", 0)) != 0
    rung = 0
    overflow = 0
    occ_overflow = 0
    n_groups = 0
    rung_groups = [0] * len(rungs)
    trunk_rows = [0] * len(rungs)
    trunk_slots = [0] * len(rungs)

    def budgets(o, n):
        """(Ncb, NtB) of n chunks rendered at o: each compaction group's
        rows and its wide tier's; (0, 0) uncompacted."""
        Nc = int(o.SR_budget) * n if int(o.SR_budget) > 0 else \
            effective_sr_budget(o, n * S_chunk)
        if prob or not 0 < Nc < n * S_chunk:
            return 0, 0
        Ncb = -(-Nc // G)
        return Ncb, wide_budget(o, Ncb) if tiered else 0

    def sized(o, n, d):
        """The options under which n chunks that dropped d rows at o drop
        none, or None where the budget reaches their rows."""
        Ncb, NtB = budgets(o, n)
        per_chunk = -(-G * (Ncb + d) // (n * 128)) * 128
        if per_chunk >= S_chunk:
            return None
        up = o.replace(SR_budget=per_chunk)
        if tiered:
            Ncb_up = -(-per_chunk * n // G)
            up = up.replace(k_tier_wide_frac=(NtB + d) / Ncb_up)
            assert wide_budget(up, Ncb_up) >= NtB + d
        return up

    def run_group(pending, opt_used):
        stacked = {k: torch.as_tensor(np.stack([p[0][k] for p in pending]),
                                      device=dev)
                   for k in RAY_CHUNK_KEYS if k in pending[0][0]}
        if int(opt_used.SR_budget) != 0 and not prob:
            # explicit budgets are per-chunk numbers: scale by the group
            if int(opt_used.SR_budget) > 0:
                opt_used = opt_used.replace(
                    SR_budget=int(opt_used.SR_budget) * len(pending))
            if runner is None:
                return trainer.eval_chunks_stacked(
                    ts, grid, stacked, const_batch, opt_used, spec)
            out = trainer.eval_chunks_stacked(
                ts, grid, stacked, const_batch, opt_used, spec,
                part=mesh.shards(serving=True))
            return _join_wide(out, len(pending))
        # budget-off rung or probe: chunk-sized uncompacted renders
        if runner is None:
            return trainer.eval_chunks(ts, grid, stacked, const_batch,
                                       opt_used, spec, prob=prob)
        w = chunk // plane
        mine = {k: v[:, :, mesh.ray_index * w:(mesh.ray_index + 1) * w]
                for k, v in stacked.items()}
        return _join_chunks(trainer.eval_chunks(ts, grid, mine, const_batch,
                                                opt_used, spec, prob=prob))

    def _join_wide(out, n):
        """A rank's piece of the wide render → every chunk's [n,1,C,...]
        outputs, gathered over the ray shards; the overflow summed."""
        res = {}
        for k in keys:
            if k in out:
                g = mesh.gather_plane(out[k])          # [plane, 1, w, ...]
                res[k] = g.reshape((n, 1, chunk) + tuple(g.shape[3:]))
        for k in ("sr_overflow", "occ_overflow"):
            if k in out:
                res[k] = torch.zeros(n, dtype=out[k].dtype, device=dev)
                res[k][0] = mesh.plane_sum(out[k])
        return res

    def _join_chunks(out):
        """Each chunk's ray slices [n,1,C/plane,...] → [n,1,C,...]; the
        per-chunk counters [n] summed."""
        res = {}
        for k in keys:
            if k in out:
                g = mesh.gather_plane(out[k])   # [plane, n, 1, w, ...]
                g = g.movedim(0, 2)             # [n, 1, plane, w, ...]
                res[k] = g.reshape(g.shape[:2] + (chunk,)
                                   + tuple(g.shape[4:]))
        for k in ("sr_overflow", "occ_overflow"):
            if k in out:
                res[k] = mesh.plane_sum(out[k])
        return res

    def traced_group(pending, r):
        """The group rendered at rung r: (outputs, dropped rows, occupancy
        overflow), the counters and its row counts read in one transfer."""
        n = len(pending)
        Ncb, NtB = budgets(rungs[r], n)
        with profiling.span("render.group", rung=r, budget=G * Ncb,
                            wide=G * NtB) as sp, \
                profiling.tally() as t:
            outs = run_group(pending, rungs[r])
            heads = [outs[k][:n].sum().to(torch.int64)
                     for k in ("sr_overflow", "occ_overflow") if k in outs]
            counted = t.names()
            read = torch.stack(heads + [t.device[k] for k in counted]
                               ).tolist()
            sp.attrs["dropped"] = read[0]
        counts = {**dict(zip(counted, read[len(heads):])), **t.host}
        for k, v in counts.items():
            profiling.count(k, v)
            if k.startswith("trunk.rows."):
                trunk_rows[r] += v
            elif k.startswith("trunk.slots."):
                trunk_slots[r] += v
        return outs, read[0], read[1] if len(heads) > 1 else 0

    def finish(pending, rung_used):
        nonlocal rung, overflow, occ_overflow, n_groups
        n_groups += 1
        while True:
            outs, dropped, occ = traced_group(pending, rung_used)
            if dropped == 0 or rung_used == 2:
                break
            overflow += dropped
            up = sized(rungs[rung_used], len(pending), dropped)
            if up is None:
                rung_used = 2
            else:
                rungs[1], rung_used = up, 1
                profiling.count("render.resized", 1)
            rung = max(rung, rung_used)
        rung_groups[rung_used] += 1
        profiling.count(f"render.groups.r{rung_used}", 1)
        occ_overflow += occ
        with profiling.span("render.readback"):
            host = {k: outs[k].cpu().numpy() for k in keys if k in outs}
            for ci, (_, s, e) in enumerate(pending):
                px, py = pix[s:e, 0], pix[s:e, 1]
                for key, full in host.items():
                    arr = np.asarray(full[ci][0], np.float32)
                    if arr.ndim == 1:
                        arr = arr[:, None]
                    arr = arr[: e - s]
                    if key not in maps:
                        maps[key] = np.zeros((H, W, arr.shape[-1]),
                                             np.float32)
                    maps[key][py, px] = arr

    with profiling.span("render.image"):
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
                     groups=n_groups, rung_groups=rung_groups,
                     trunk_rows=trunk_rows, trunk_slots=trunk_slots,
                     sized_budget=0 if rungs[1] is None
                     else rungs[1].SR_budget)
    if overflow > 0 and (runner is None or runner.is_main):
        print(f"[render_image] note: SR_budget overflow on {overflow} shading "
              f"rows; groups re-rendered up the budget ladder")
    return maps
