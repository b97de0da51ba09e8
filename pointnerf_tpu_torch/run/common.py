"""Full-image rendering (port of the serving half of `pointnerf_tpu/run/common.py`)."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models.renderer import effective_sr_budget
from ..ops.grid import build_grid, make_grid_spec
from ..train import trainer

CONST_BATCH_KEYS = ("campos", "camrotc2w", "bg_color")


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
                 group: int = 8, stats: Optional[Dict] = None
                 ) -> Dict[str, np.ndarray]:
    """Chunked full-image render into [H,W,C] host maps (reference
    run/train_ft.py:283-322).

    Chunks of random_sample_size² rays render `group` at a time as one wide
    eval_step over group·chunk rays. Eval never drops a
    valid shading row: a group whose compaction budget overflows is
    re-rendered up a static budget ladder (2x the budget, then compaction
    off), and the raised rung persists for the rest of the image.
    Rendering happens on the device that holds `grid`. A `stats` dict, if
    given, receives the image's counters: sr_overflow (valid rows the first
    rung dropped, all re-rendered), occ_overflow and the group count.
    """
    dev = grid["coor_occ_rows"].device
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
        if int(opt_used.SR_budget) != 0:
            # explicit budgets are per-chunk numbers: scale by the group
            if int(opt_used.SR_budget) > 0:
                opt_used = opt_used.replace(
                    SR_budget=int(opt_used.SR_budget) * len(pending))
            return trainer.eval_chunks_stacked(ts, grid, stacked, const_batch,
                                               opt_used, spec)
        # budget-off rung: chunk-sized uncompacted renders
        return trainer.eval_chunks(ts, grid, stacked, const_batch, opt_used,
                                   spec)

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
