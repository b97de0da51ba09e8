"""Per-scene finetune driver (port of `pointnerf_tpu/run/train_ft.py`).

Reference: run/train_ft.py (epoch loop :829-1011, probe_hole :417-530,
test :252-414). As in the JAX package, prune and grow are masked buffer
updates with no process restart; running out of free slots expands the
buffers and keeps the point-Adam moments; the voxel grid is rebuilt only
when points change. As in the JAX driver, up to steps_per_dispatch steps
run in one dispatch (`trainer.train_steps_scan`: on the card one train
step captured in a CUDA graph and replayed, `train.graph`), clamped to one
step before a prune, grow, print, save, test or grid-rebuild boundary;
their loss items come to the host in one transfer, the ray-miss ranking
and the loss log take them step by step, and the SR_budget rises once a
dispatch on its largest overflow. Each loss line carries the phase timer
(`utils.profiling.PhaseTimer`: host_data, device_step), and --profile_dir
writes a torch.profiler trace of the loop there, with the trace record's
counters (`utils.profiling.device_trace`). The numpy streams are the JAX
driver's (RandomState(seed) for frame choices, RandomState(seed + 9999) for
batches); the weights and the depth jitter come from torch generators, so a
run matches the JAX driver's by PSNR, not bit for bit.

The point cloud comes from the dataset's points (load_points 1), from
its sensor depths (load_points 2: every frame back-projected and
downsampled, ScanNet's `load_init_depth_points`), from both (load_points
3: the depth points that fall in voxels the dataset's points leave empty),
each with an optional `comb_file` cloud (`common.
init_point_state_from_dataset`), or from the MVS init (load_points 0:
MVSNet depth, fusion, per-point embeddings and the visual hull over the
train views, `common.gen_points_filter_embeddings`).

Plane backgrounds (datasets with the plane helpers, `dtu_ft`), as the JAX
driver wires them: `bgmodel planepoints` adds the plane's points to the
starting cloud, drawn from RandomState(seed) before any frame choice, and
keeps grow candidates off the plane; a bgmodel ending in `plane`
precomputes one background map per train and test frame from the init
views and the starting cloud (`models/mvs/bg.create_all_bg`), and every
train batch and test render carries its rays' `bg_ray`.

Multi-GPU (--n_devices, --gpu_ids, --mesh_points) runs the driver on
the ranks of `parallel.driver.launch`: the ray batch, and with
mesh_points > 1 the point buffers, shard over the ranks, and the host
events run on rank 0 on the gathered state; a runner's dispatch runs its
steps one after another. The MVS init takes ProbNet's learned depth
distribution with manual_depth_view -1 (`models/mvs/probnet.py`).
With gen_vid the run ends with a video of the render path
(`render_vid.render_vid`); a dataset with no render split skips it with a
line in the log, and any other failure raises (the JAX driver logs every
failure there and carries on).

Usage: python -m pointnerf_tpu_torch.run.train_ft --preset nerf_synth:lego \
           --data_root <dir> [--device cpu] [--flag value ...]
       python -m pointnerf_tpu_torch.run.train_ft \
           --preset scannet:scene0241_01 --data_root <dir>  # load_points 2
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..data import create_dataset, find_dataset_class_by_name
from ..data.loader import Prefetcher
from ..models import neural_points as npc
from ..models.networks import PlateauTracker
from ..models.renderer import effective_sr_budget
from ..parallel.driver import launch, world_size
from ..train import graph as step_graph
from ..train import trainer
from ..utils.checkpoint import latest_step, load_checkpoint, save_checkpoint
from ..utils.metrics import psnr as psnr_fn, report_metrics
from ..utils.profiling import PhaseTimer, device_trace
from ..utils.visualizer import Visualizer
from .common import (PROBE_KEYS, gen_points_filter_embeddings,
                     init_point_state_from_dataset, make_spec_and_grid,
                     render_image, run_cli)

BATCH_KEYS = ("raydir", "campos", "camrotc2w", "bg_color", "gt_image")


def bloat_mask(mask: np.ndarray, shift: int = 1) -> np.ndarray:
    """Dilate a [H,W] bool mask by ±shift pixels (reference bloat_inds,
    train_ft.py:532-540)."""
    out = mask.copy()
    H, W = mask.shape
    for dy in range(-shift, shift + 1):
        for dx in range(-shift, shift + 1):
            ys = slice(max(0, dy), min(H, H + dy))
            yd = slice(max(0, -dy), min(H, H - dy))
            xs = slice(max(0, dx), min(W, W + dx))
            xd = slice(max(0, -dx), min(W, W - dx))
            out[yd, xd] |= mask[ys, xs]
    return out


def probe_hole(ts, opt, dataset, frame_ids, visualizer,
               total_steps: int, runner=None) -> Dict[str, np.ndarray]:
    """Render probe frames and collect new point candidates where rays that
    hit border rays that miss (reference: train_ft.py:417-530). The probe
    query size comes from opt.prob_kernel_size by tier, so the probe
    renders on a grid of its own. Under NN < 0 it raises ValueError: grown
    points sit off the lattice the corner table indexes, and the JAX
    driver's probe stops there with a KeyError (its probe grid has no
    corner table; ROADMAP §3). Under a runner every rank builds the probe
    grid from the joined points and the probe renders by mesh serving, so
    every rank finds the same candidates."""
    if opt.NN < 0:
        raise ValueError("probe-and-grow does not run with the NN < 0 "
                         "vox-grid query (grown points leave the lattice): "
                         "set prob_freq 0")
    probe_opt = opt
    if len(opt.prob_kernel_size) >= 3:
        tier = int(np.sum(np.asarray(opt.prob_tiers) < total_steps))
        ks = opt.prob_kernel_size[tier * 3: tier * 3 + 3]
        if len(ks) == 3:
            probe_opt = opt.replace(query_size=tuple(int(k) for k in ks))
    probe_opt = probe_opt.replace(random_sample="no_crop")
    pstate = trainer.point_state_of(ts) if runner is None else \
        runner.whole_points(ts).points
    pspec, pgrid = make_spec_and_grid(probe_opt, pstate)
    if runner is not None:
        pgrid = runner.shard_grid(pgrid, pspec)

    cand: Dict[str, list] = {k: [] for k in
                             ("xyz", "embedding", "color", "dir", "conf")}
    for fid in frame_ids:
        item = dataset.get_item(int(fid), full_img=True)
        maps = render_image(ts, pgrid, probe_opt, pspec, item, prob=True,
                            keys=PROBE_KEYS, runner=runner)
        H, W = int(item["h"]), int(item["w"])
        gt = item["gt_image"][0].reshape(H, W, 3)
        bg = item["bg_color"][0]
        ray_mask = maps["ray_mask"][..., 0] > 0
        nonbg = np.linalg.norm(gt - bg, axis=-1) > 0.002
        neighboring = bloat_mask((~ray_mask) & nonbg, 1)
        if opt.far_thresh > 0 and "ray_max_far_dist" in maps:
            neighboring |= ray_mask \
                & (maps["ray_max_far_dist"][..., 0] > opt.far_thresh) \
                & (np.linalg.norm(gt - maps["coarse_raycolor"], axis=-1)
                   < 0.1)
        sel = ray_mask & neighboring & \
            (maps["ray_max_shading_opacity"][..., 0] > opt.prob_thresh)
        if not sel.any():
            continue
        cand["xyz"].append(maps["ray_max_sample_loc_w"][sel])
        cand["embedding"].append(maps["shading_avg_embedding"][sel])
        cand["color"].append(maps["shading_avg_color"][sel])
        cand["dir"].append(maps["shading_avg_dir"][sel])
        cand["conf"].append(maps["shading_avg_conf"][sel] * opt.prob_mul)
    if not cand["xyz"]:
        visualizer.print_details(f"probe_hole at {total_steps} found no "
                                 f"candidate points in frames "
                                 f"{[int(f) for f in frame_ids]}")
        return {}
    out = {k: np.concatenate(v, axis=0) for k, v in cand.items()}
    # planepoints: never grow onto the background plane (reference:
    # train_ft.py:524-527, filter_plane)
    if opt.bgmodel.startswith("planepoints") and \
            hasattr(dataset, "filter_plane"):
        keep = ~np.asarray(dataset.filter_plane(out["xyz"]))
        out = {k: v[keep] for k, v in out.items()}
        if not len(out["xyz"]):
            return {}
    visualizer.save_neural_points(f"prob{total_steps:04d}", out["xyz"], None)
    visualizer.print_details(
        f"probe_hole found {len(out['xyz'])} candidate points")
    return out


def grow_from_candidates(ts, opt, cand: Dict[str, np.ndarray]):
    """Masked grow, expanding the capacity first if the free slots run out
    (the reference exits the process here, train_ft.py:878-911). Returns
    (ts, n_dropped)."""
    state = trainer.point_state_of(ts)
    n_new = len(cand["xyz"])
    free = int((~state["mask"]).sum())
    if n_new > free:
        new_cap = npc.round_capacity(state["mask"].shape[0] + (n_new - free))
        ts = trainer.expand_capacity(ts, new_cap)
        state = trainer.point_state_of(ts)
    dev = state["xyz"].device
    on = lambda k: torch.as_tensor(np.asarray(cand[k], np.float32),
                                   device=dev)
    _, dropped = npc.grow(state, on("xyz"), on("embedding"), on("color"),
                          on("dir"), on("conf"),
                          torch.ones(n_new, dtype=torch.bool, device=dev))
    return ts, dropped


def prune_points(ts, opt):
    npc.prune(trainer.point_state_of(ts), opt.prune_thresh)
    return ts


def _test_loss_items(opt, img, gt, ray_mask):
    """Per-image test losses for opt.test_color_loss_items (the reference
    logs the masked/miss/plain MSE triplet at test,
    base_rendering_model.py:533-662)."""
    items = {}
    mask = ray_mask.astype(bool).reshape(-1)
    d2 = np.square(img.reshape(-1, 3) - gt.reshape(-1, 3))
    for name in opt.test_color_loss_items:
        if name.startswith("ray_masked"):
            v = float(d2[mask].mean()) if mask.any() else 0.0
        elif name.startswith("ray_miss"):
            v = float(d2[~mask].sum()) / 3.0
        else:
            v = float(d2.mean())
        items["loss_" + name] = v
    return items


def _visual_maps(opt, maps, gt):
    """The maps opt.visual_items asks for; ray_masked/ray_miss variants are
    the render masked to hit/miss rays."""
    rm = maps["ray_mask"].astype(bool)
    out = {}
    for name in opt.visual_items:
        if name == "gt_image":
            out[name] = gt
        elif name in maps:
            out[name] = maps[name]
        elif name.startswith("ray_masked") and \
                name[len("ray_masked") + 1:] in maps:
            out[name] = np.where(rm, maps[name[len("ray_masked") + 1:]], 1.0)
        elif name.startswith("ray_miss") and \
                name[len("ray_miss") + 1:] in maps:
            out[name] = np.where(rm, 1.0, maps[name[len("ray_miss") + 1:]])
    return out


def with_bg_ray(item: Dict, bg_map: Optional[np.ndarray]) -> Dict:
    """The item with its rays' colours of a [H, W, 3] background map as
    `bg_ray` [1, R, 3] (none without a map)."""
    if bg_map is not None:
        pix = item["pixel_idx"][0].astype(np.int64)
        item["bg_ray"] = bg_map[pix[:, 1], pix[:, 0]][None]
    return item


def test(ts, grid, opt, spec, dataset, visualizer, total_steps: int,
         max_images: Optional[int] = None, write_images: bool = True,
         bg_maps=None, runner=None) -> float:
    """Render the held-out split, with the frames' background maps where
    given (by mesh serving under a runner); mean PSNR over the images
    (reference: train_ft.py:252-414)."""
    n = len(dataset) if max_images is None else min(max_images, len(dataset))
    psnrs = []
    agg_items: Dict[str, list] = {}
    for i in range(n):
        item = with_bg_ray(dataset.get_item(i, full_img=True),
                           None if bg_maps is None else bg_maps[i])
        maps = render_image(ts, grid, opt.replace(random_sample="no_crop"),
                            spec, item, keys=("coarse_raycolor", "ray_mask"),
                            runner=runner)
        H, W = int(item["h"]), int(item["w"])
        gt = item["gt_image"][0].reshape(H, W, 3)
        img = maps["coarse_raycolor"]
        psnrs.append(psnr_fn(gt, img))
        for k, v in _test_loss_items(opt, img, gt, maps["ray_mask"]).items():
            agg_items.setdefault(k, []).append(v)
        if write_images:
            visualizer.display_current_results(
                _visual_maps(opt, maps, gt), i, subdir=f"test_{total_steps}")
    mean_psnr = float(np.mean(psnrs))
    detail = "  ".join(f"{k}: {np.mean(v):.6f}" for k, v in
                       sorted(agg_items.items()))
    visualizer.print_details(f"test at {total_steps}: PSNR {mean_psnr:.3f} "
                             f"over {n} images  {detail}")
    return mean_psnr


def score_test_images(visualizer, total_steps: int, opt, device) -> Dict:
    """PSNR, SSIM, RMSE and LPIPS (alex and vgg from opt.lpips_alex_path /
    lpips_vgg_path, on `device`; SKIPPED without a file) of the test
    renders in images/test_{total_steps}/, with scores.txt there
    (reference: run/test_ft.py:331-345)."""
    img_dir = os.path.join(visualizer.image_dir, f"test_{total_steps}")
    return report_metrics(
        img_dir, img_dir, img_dir, ("psnr", "ssim", "rmse", "lpips",
                                    "vgglpips"),
        lpips_weights={"lpips": opt.lpips_alex_path,
                       "vgglpips": opt.lpips_vgg_path}, device=device)


def initial_points(opt, train_ds, dev) -> Dict:
    """The starting point state: the dataset's cloud, its sensor-depth
    points or both (load_points 1, 2, 3) or the MVS init (load_points 0,
    weights seeded with opt.seed). The MVS
    embeddings must be point_features_dim wide: without the premlp they
    are the raw FPN features, 8 + 16 + 32 = 56 channels a view, which the
    aggregator cannot take (the JAX driver fails there in its first train
    step)."""
    if opt.load_points >= 1:
        return init_point_state_from_dataset(opt, train_ds, device=dev)
    state = gen_points_filter_embeddings(opt, train_ds, device=dev)
    width = state["embedding"].shape[1]
    if width != opt.point_features_dim:
        raise ValueError(
            f"the MVS init made {width}-wide point embeddings and "
            f"point_features_dim is {opt.point_features_dim}: set "
            f"shading_feature_mlp_layer0 >= 1, so that the premlp maps the "
            f"63 init features to point_features_dim")
    return state


def add_plane_points(state: Dict, plane, dev) -> Dict:
    """The live points of `state` followed by the background plane's
    points (`plane` = get_plane_param_points' xyz, embedding, dir, color,
    conf), as a new cloud on `dev` (reference: the bgmodel planepoints
    wiring; the embeddings cut to the cloud's width)."""
    bx, bemb, bdir, bcol, bconf = plane
    mask = state["mask"].cpu().numpy()

    def cat(k, extra):
        return np.concatenate([state[k].detach().cpu().numpy()[mask], extra],
                              axis=0)
    return npc.create_point_cloud(
        cat("xyz", bx), cat("embedding",
                            bemb[:, :state["embedding"].shape[1]]),
        cat("color", bcol), cat("dir", bdir), cat("conf", bconf), device=dev)


def has_plane_background(opt, dataset) -> bool:
    """A bgmodel ending in `plane` on a dataset with init views and the
    plane helpers (the JAX driver's test)."""
    return bool(opt.bgmodel.endswith("plane")
                and getattr(dataset, "view_id_list", None)
                and hasattr(dataset, "get_plane_param"))


def plane_background(opt, train_ds, test_ds, init_state: Dict, dev,
                     visualizer):
    """(train maps, test maps, seconds): one [H, W, 3] background map per
    frame of each split, from the init views (images on `dev`) and the
    starting cloud's live points, for a bgmodel ending in `plane` on a
    dataset with the plane helpers; (None, None, 0.0) otherwise
    (reference: train_ft.py:788-798, create_all_bg)."""
    if not has_plane_background(opt, train_ds):
        return None, None, 0.0
    from ..models.mvs import bg as bgmod
    t0 = time.perf_counter()
    views = bgmod.collect_bg_views(train_ds, opt.init_view_num, device=dev)
    fg_xyz = init_state["xyz"].detach().cpu().numpy()[
        init_state["mask"].cpu().numpy()]
    plane_params = train_ds.get_plane_param()
    bg_train = bgmod.create_all_bg(train_ds, views, fg_xyz, plane_params)
    bg_test = bgmod.create_all_bg(test_ds, views, fg_xyz, plane_params)
    seconds = time.perf_counter() - t0
    visualizer.print_details(
        f"plane background precomputed for {len(bg_train)} train / "
        f"{len(bg_test)} test frames in {seconds:.2f} s")
    return bg_train, bg_test, seconds


def main(opt, max_steps: Optional[int] = None, device="cuda") -> Dict:
    """Train one scene from opt (resuming from the newest checkpoint of
    checkpoints_dir/experiment if there is one), on `device` (the card
    unless the caller names another); with load_points 0 the cloud comes
    from the MVS init (`initial_points`). Returns the counters, the final and
    best PSNR, the metric scores, the video's path (gen_vid, else None),
    the state, the grid and spec, the test split's background maps
    (`bg_test`, None without a plane background), and
    `timing`: host seconds in train dispatches (the batches' upload, the
    steps, the fetch of their items), in prunes, probe-and-grows, test
    renders, checkpoint writes and the plane background's precompute
    (`bg_s`), the number of steps run, the length of each dispatch
    (`chunks`) and the step graph's captures and replays, the points
    before and after each prune and grow, and the plane points added
    (`plane_points`).

    Options that ask for more than one device (--n_devices, --gpu_ids,
    --mesh_points; `parallel.driver.world_size`) run the driver on that
    many ranks (`parallel.driver.launch`), and rank 0's result comes back:
    the state is then the final ServeState and the grid the whole grid,
    both on the CPU when the ranks were processes of their own."""
    if opt.timestamp:
        opt = opt.replace(timestamp=False, experiment=opt.experiment
                          + time.strftime("_%m%d_%H%M%S"))
    n = world_size(opt, device)
    if n:
        return launch(_train, (opt, max_steps), n, opt.mesh_points, device,
                      os.path.join(opt.checkpoints_dir, opt.experiment))
    return _train(opt, max_steps, device)


def _start(opt, train_ds, test_ds, dev, visualizer, ckpt_dir, resume,
           plane, plateau) -> Dict:
    """The run's starting state on one device: the train state (the
    starting cloud with its plane points, or the newest checkpoint), the
    resumed counters and options, the plane background, its grid spec and
    grid."""
    init_state = initial_points(opt, train_ds, dev) \
        if not resume or has_plane_background(opt, train_ds) else None
    n_plane = 0
    if plane is not None and init_state is not None:
        init_state = add_plane_points(init_state, plane, dev)
        n_plane = len(plane[0])
        visualizer.print_details(f"added {n_plane} background plane points")
    start = {"total_steps": 0, "best_psnr": 0.0, "best_iter": 0,
             "opt": opt, "plateau": None, "n_plane": n_plane}
    if resume:
        ts, counters = load_checkpoint(ckpt_dir, opt, device=dev)
        start.update(total_steps=counters["total_steps"],
                     best_psnr=counters.get("best_PSNR", 0.0),
                     best_iter=counters.get("best_iter", 0))
        if "lr" in counters:
            start["opt"] = opt.replace(lr=counters["lr"], plr=counters["plr"])
        if plateau is not None:
            plateau.load_state_dict(counters)
            start["plateau"] = plateau.state_dict()
        visualizer.print_details(f"resumed at step {start['total_steps']}")
    else:
        ts = trainer.create_train_state(
            opt, init_state, torch.Generator().manual_seed(opt.seed))
    start["bg_train"], start["bg_test"], start["bg_s"] = plane_background(
        opt, train_ds, test_ds, init_state, dev, visualizer)
    start["spec"], start["grid"] = make_spec_and_grid(
        opt, trainer.point_state_of(ts))
    n_active = int(npc.num_active(trainer.point_state_of(ts)))
    visualizer.print_details(
        f"start: {n_active} active points, grid {start['spec'].vdim}, steps "
        f"{start['total_steps']}")
    start["ts"] = ts
    return start


def _train(opt, max_steps: Optional[int], device, runner=None) -> Dict:
    """The driver on one device, or on a rank of `launch` (runner): every
    rank draws the same batches and frames and takes the same decisions
    from the same loss items; rank 0 starts the run and runs the host
    events on the gathered state (`MeshRunner.host_event`), and writes
    every file."""
    dev = torch.device(device)
    main_rank = runner is None or runner.is_main
    rng = np.random.RandomState(opt.seed)
    ckpt_dir = os.path.join(opt.checkpoints_dir, opt.experiment)
    os.makedirs(ckpt_dir, exist_ok=True)
    resume = latest_step(ckpt_dir) is not None
    if runner is not None:
        resume = runner.mesh.broadcast_object(resume)
    if main_rank:
        if opt.verbose:
            print(opt.to_json())
        with open(os.path.join(ckpt_dir, "opt.json"), "w") as f:
            f.write(opt.to_json())
    visualizer = Visualizer(opt) if runner is None else \
        runner.visualizer(lambda: Visualizer(opt))
    train_ds = create_dataset(opt, split="train")
    test_ds = create_dataset(opt, split="test")

    plateau = PlateauTracker(mode="max") if opt.lr_policy == "plateau" \
        else None
    plane = None
    if opt.bgmodel.startswith("planepoints") and \
            hasattr(train_ds, "get_plane_param_points"):
        # drawn from rng before any frame choice, resumed or not
        plane = train_ds.get_plane_param_points(rng)
    start = _start(opt, train_ds, test_ds, dev, visualizer, ckpt_dir,
                   resume, plane, plateau) if main_rank else None
    if runner is None:
        ts, grid = start["ts"], start["grid"]
    else:
        visualizer.print_details(runner.describe())
        ts = runner.place_state(start and start.pop("ts"), opt)
        grid_whole = start and start.pop("grid")
        start = runner.mesh.broadcast_object(start)
        grid = runner.place_grid(grid_whole, start["spec"])
        if plateau is not None and start["plateau"] is not None:
            plateau.load_state_dict(start["plateau"])
    opt, spec = start["opt"], start["spec"]
    total_steps = start["total_steps"]
    best_psnr, best_iter = start["best_psnr"], start["best_iter"]
    bg_train, bg_test = start["bg_train"], start["bg_test"]

    def extra_counters():
        out = {"lr": opt.lr, "plr": opt.plr}
        if plateau is not None:
            out.update(plateau.state_dict())
        return out

    def event(fn):
        """fn(whole ts) -> (ts, grid, info) on the whole state: here, or
        on rank 0 with the result placed on every rank. The step graph
        and its memory go first (the event replaces what it captured)."""
        step_graph.drop(ts)
        if runner is None:
            return fn(ts)
        return runner.host_event(ts, grid, spec, opt, fn)

    def whole():
        """The whole train state (on rank 0 under a runner, else None)."""
        return ts if runner is None else runner.gather_state(ts, opt)

    timing = {"train_s": 0.0, "prune_s": 0.0, "grow_s": 0.0, "test_s": 0.0,
              "save_s": 0.0, "bg_s": start["bg_s"], "steps": 0, "chunks": [],
              "captures": 0, "replays": 0, "prune": [], "grow": [],
              "plane_points": start["n_plane"]}

    # ray-miss frame ranking (reference: mvs_points_volumetric_model.py:
    # 134-166)
    num_probe = max(1, len(train_ds) // max(1, opt.prob_num_step))
    top_miss_loss = np.zeros(num_probe + 1, np.float32)
    top_miss_ids = np.arange(num_probe + 1, dtype=np.int64) % len(train_ds)
    stop_at = min(opt.maximum_step, total_steps + max_steps) if max_steps \
        else opt.maximum_step
    t_start = time.time()
    timer = PhaseTimer()
    data_rng = np.random.RandomState(opt.seed + 9999)

    def produce():
        fid = int(data_rng.randint(len(train_ds)))
        return fid, with_bg_ray(train_ds.get_item(fid, rng=data_rng),
                                None if bg_train is None else bg_train[fid])
    batch_keys = BATCH_KEYS + (("bg_ray",) if bg_train is not None else ())

    def pruned(st):
        before = int(npc.num_active(trainer.point_state_of(st)))
        st = prune_points(st, opt)
        after = int(npc.num_active(trainer.point_state_of(st)))
        return st, trainer.rebuild_grid(st, spec), (before, after)

    def grown(st):
        before = int(npc.num_active(trainer.point_state_of(st)))
        st, dropped = grow_from_candidates(st, opt, cand)
        after = int(npc.num_active(trainer.point_state_of(st)))
        return st, trainer.rebuild_grid(st, spec), (before, after, dropped)

    scan = trainer.train_steps_scan if runner is None else \
        runner.train_steps_scan

    def dispatch(hosts):
        """The steps of `hosts` (one item each) in one dispatch, the state
        updated in place: train_steps_scan on the stacked items, each
        step with its item's near and far. Returns each step's loss items
        as host floats."""
        batch = {k: torch.as_tensor(np.stack([h[k] for h in hosts]),
                                    device=dev) for k in batch_keys}
        batch.update({k: [float(h[k]) for h in hosts]
                      for k in ("near", "far")})
        _, items = scan(ts, grid, batch, opt, spec)
        return [{k: float(v[s]) for k, v in items.items()}
                for s in range(len(hosts))]

    prefetcher = Prefetcher(produce, depth=max(1, opt.prefetch_depth)
                            * max(1, opt.steps_per_dispatch))
    miss_key = "loss_ray_miss_coarse_raycolor"
    trace = device_trace(opt.profile_dir)
    trace.__enter__()
    try:
        while total_steps < stop_at:
            if opt.prune_iter > 0 and 0 < total_steps <= opt.prune_max_iter \
                    and total_steps % opt.prune_iter == 0:
                t0 = time.perf_counter()
                ts, grid, (before, after) = event(pruned)
                timing["prune_s"] += time.perf_counter() - t0
                timing["prune"].append((total_steps, before, after))
                visualizer.print_details(
                    f"prune at {total_steps}: {before} -> {after} points")

            if opt.prob_freq > 0 and 0 < total_steps < opt.maximum_step - 1 \
                    and total_steps % opt.prob_freq == 0 and \
                    (top_miss_loss[0] > 1e-5 or opt.prob_mode != 0
                     or opt.far_thresh > 0):
                # frame choice (reference probe_hole :440-455, prob_mode):
                # 0 + prob_top the top ray-miss train frames, 1 test frames,
                # otherwise random train frames
                t0 = time.perf_counter()
                probe_ds = train_ds
                if opt.prob_mode == 1:
                    probe_ds = test_ds
                    frame_ids = rng.permutation(len(test_ds))[:num_probe]
                elif opt.prob_mode == 0 and opt.prob_top == 1:
                    frame_ids = top_miss_ids[:-1][top_miss_loss[:-1] > 0][
                        :num_probe]
                    if len(frame_ids) == 0:
                        frame_ids = rng.permutation(len(train_ds))[:num_probe]
                else:
                    frame_ids = rng.permutation(len(train_ds))[:num_probe]
                step_graph.drop(ts)     # the probe renders need its memory
                cand = probe_hole(ts, opt, probe_ds, frame_ids, visualizer,
                                  total_steps, runner=runner)
                if cand:
                    ts, grid, (before, after, dropped) = event(grown)
                    timing["grow"].append((total_steps, before, after))
                    visualizer.print_details(
                        f"grow at {total_steps}: {before} -> {after} points"
                        f" (dropped {dropped})")
                top_miss_loss[:] = 0
                top_miss_ids[:] = np.arange(num_probe + 1) % len(train_ds)
                timing["grow_s"] += time.perf_counter() - t0

            # up to steps_per_dispatch steps in one dispatch, clamped to
            # one so that prune, grow, print, save, test and rebuild
            # boundaries land exactly (JAX train_ft.py:402-415)
            boundaries = [stop_at]
            for freq in (opt.prune_iter, opt.prob_freq, opt.print_freq,
                         opt.save_iter_freq, opt.test_freq,
                         opt.save_point_freq,
                         opt.grid_rebuild_every if opt.xyz_grad > 0 else 0):
                if freq > 0:
                    boundaries.append((total_steps // freq + 1) * freq)
            spd = max(1, opt.steps_per_dispatch)
            chunk = spd if min(boundaries) - total_steps >= spd else 1
            with timer.phase("host_data"):
                pulled = [prefetcher.get() for _ in range(chunk)]
            t0 = time.perf_counter()
            with timer.phase("device_step"):
                step_items = dispatch([host for _, host in pulled])
            timing["train_s"] += time.perf_counter() - t0
            timing["steps"] += chunk
            timing["chunks"].append(chunk)
            total_steps += chunk

            if opt.grid_rebuild_every > 0 and opt.xyz_grad > 0 and \
                    total_steps % opt.grid_rebuild_every == 0:
                ts, grid, _ = event(
                    lambda st: (st, trainer.rebuild_grid(st, spec), None))
            for (fid, _), items in zip(pulled, step_items):
                if opt.prob_freq > 0 and miss_key in items:
                    loss_miss = items[miss_key]
                    hit = np.flatnonzero(top_miss_ids == fid)
                    if len(hit):
                        top_miss_loss[hit] = np.maximum(top_miss_loss[hit],
                                                        loss_miss)
                    else:
                        top_miss_ids[-1] = fid
                        top_miss_loss[-1] = loss_miss
                    order = np.argsort(-top_miss_loss, kind="stable")
                    top_miss_loss = top_miss_loss[order]
                    top_miss_ids = top_miss_ids[order]
                visualizer.accumulate_losses(items)

            # sr_overflow > 0: valid shading rows were rendered empty in
            # the dispatch; raise the compaction budget 1.5x on its
            # largest overflow
            overflow = max(it.get("sr_overflow", 0.0) for it in step_items)
            if overflow > 0:
                rows = opt.random_sample_size ** 2 * opt.SR
                cur = effective_sr_budget(opt, rows)
                new = min(rows, -(-int(cur * 1.5) // 128) * 128)
                if 0 < cur < new:
                    step_graph.drop(ts)
                    opt = opt.replace(SR_budget=new)
                    visualizer.print_details(
                        f"SR_budget overflow at {total_steps} "
                        f"({int(overflow)} rows dropped): budget "
                        f"{cur} -> {new}")
            if total_steps % opt.print_freq == 0:
                visualizer.print_losses(total_steps, extra=timer.summary())
                timer.reset()
            if opt.save_point_freq > 0 and \
                    total_steps % opt.save_point_freq == 0:
                st = whole()
                if st is not None:
                    st = {k: (None if v is None else v.detach().cpu().numpy())
                          for k, v in trainer.point_state_of(st).items()}
                    visualizer.save_neural_points(total_steps, st["xyz"],
                                                  st["color"], st["conf"],
                                                  st["mask"])
            if total_steps % opt.save_iter_freq == 0:
                t0 = time.perf_counter()
                st = whole()
                if st is not None:
                    save_checkpoint(ckpt_dir, total_steps, st, opt,
                                    best_psnr, best_iter,
                                    extra_counters=extra_counters())
                timing["save_s"] += time.perf_counter() - t0
            if opt.test_freq > 0 and total_steps % opt.test_freq == 0:
                t0 = time.perf_counter()
                step_graph.drop(ts)
                cur = test(ts, grid, opt, spec, test_ds, visualizer,
                           total_steps, max_images=opt.test_num,
                           bg_maps=bg_test, runner=runner)
                timing["test_s"] += time.perf_counter() - t0
                if cur > best_psnr:
                    best_psnr, best_iter = cur, total_steps
                if plateau is not None and plateau.update(cur):
                    step_graph.drop(ts)
                    opt = opt.replace(lr=opt.lr * plateau.factor,
                                      plr=opt.plr * plateau.factor)
                    visualizer.print_details(
                        f"plateau: lr -> {opt.lr:.3e}, plr -> {opt.plr:.3e}")
    finally:
        trace.__exit__(None, None, None)
        prefetcher.close()
        step_graph.drop(ts)
    if ts.dispatch is not None:
        timing.update(captures=ts.dispatch.captures,
                      replays=ts.dispatch.replays)

    t0 = time.perf_counter()
    final_state = whole()
    if final_state is not None:
        save_checkpoint(ckpt_dir, total_steps, final_state, opt, best_psnr,
                        best_iter, extra_counters=extra_counters())
    timing["save_s"] += time.perf_counter() - t0
    t0 = time.perf_counter()
    final_psnr = test(ts, grid, opt, spec, test_ds, visualizer, total_steps,
                      bg_maps=bg_test, runner=runner)
    timing["test_s"] += time.perf_counter() - t0
    if final_psnr > best_psnr:
        best_psnr, best_iter = final_psnr, total_steps
    visualizer.print_details(
        f"done: {total_steps} steps in {time.time() - t_start:.1f}s, "
        f"final PSNR {final_psnr:.3f}, best {best_psnr:.3f}@{best_iter}")
    scores = score_test_images(visualizer, total_steps, opt, dev) \
        if main_rank else None
    video = None
    if opt.gen_vid:
        # the final video over the render path (reference: train_ft.py:
        # 1014-1033)
        if hasattr(find_dataset_class_by_name(opt.dataset_name),
                   "get_dummyrot_item"):
            from .render_vid import render_vid
            video = render_vid(ts, grid, opt, spec,
                               create_dataset(opt, split="render"),
                               visualizer, total_steps,
                               runner=runner)["video"]
        else:
            visualizer.print_details(f"gen_vid skipped: dataset "
                                     f"{opt.dataset_name} has no render "
                                     f"split")
    if runner is not None:
        grid = runner.whole_grid(grid)
    return {"total_steps": total_steps, "final_psnr": final_psnr,
            "best_psnr": best_psnr, "best_iter": best_iter, "scores": scores,
            "video": video, "state": final_state, "grid": grid, "spec": spec,
            "bg_test": bg_test,
            "timing": timing}


def cli(argv=None) -> Dict:
    """The command line: --device (default cuda) and the Options flags."""
    return run_cli(main, argv)


if __name__ == "__main__":
    cli()
