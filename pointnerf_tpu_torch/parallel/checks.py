"""Rank-side checks of the sharded steps and of mesh serving.

The parity tests, chip_smoke and the multichip benchmark run these on the
ranks of `driver.launch` (`run_jobs` as the launched function). A job
arrives as numpy and plain values (the options as JSON, the whole
flattened train state, the whole grid or None and its spec, the batch,
the draws), builds its own `MeshRunner` at its mesh_points on every rank,
and returns numpy: the caller holds the results against the
single-device step on the same inputs. The options pick the query: the
world-coordinate one, the frustum (wcoord_query 0: the spec is a frustum
spec and there is no grid, each step builds the camera's from the whole
points; `priorities`, the whole row's NN ≤ 0 priorities, may come with
it) or the vox-grid one (NN < 0: the grid holds the corner table).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import Options
from ..models.renderer import render_query
from ..ops import kernels
from ..ops.grid import build_grid
from ..run.common import render_image
from .dp import (_with_comp_groups, make_dp_eval_step,
                 make_dp_train_step, sharded_grads)
from .driver import MeshRunner
from .mesh import shard_batch, shard_rays
from .points import make_mp_eval_step, make_mp_train_step


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _batch(batch: Dict, device) -> Dict:
    return {k: (torch.as_tensor(v, device=device)
                if isinstance(v, np.ndarray) else v)
            for k, v in batch.items()}


def _placed(job: Dict, device):
    """The job's runner, this rank's state and grid. A job without a grid
    has every rank build it from the whole points (build_grid is
    deterministic: the same tables on every rank and in the caller),
    except on the frustum path, whose camera grid each step builds."""
    opt = Options.from_json(job["opt"])
    runner = MeshRunner(job["points"], device)
    ts = runner.state_from_arrays(job["state"], opt)
    if opt.wcoord_query == 0:
        grid = None
    elif job.get("grid") is None:
        pts = runner.whole_points(ts).points
        grid = build_grid(pts["xyz"], pts["mask"], job["spec"])
    else:
        grid = {k: torch.as_tensor(v, device=runner.device)
                for k, v in job["grid"].items()}
    return opt, runner, ts, runner.shard_grid(grid, job["spec"])


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _peak(device) -> Optional[int]:
    """This process's peak device bytes since the reset (None off CUDA)."""
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return None



def step_job(job: Dict, device) -> Dict:
    """compute_grads of the sharded step on draws[0], then one sharded
    train step per draw. Returns the items, the whole gradients (point
    gradients joined from the shards), the compaction map's shape on this
    rank and the rows it shades, the at-rest shard shapes and bytes, each
    step's items and seconds, the net weights and the joined point
    buffers after the steps, the kernel launches of this process and its
    peak device bytes."""
    opt, runner, ts, grid = _placed(job, device)
    mesh, spec = runner.mesh, job["spec"]
    batch = _batch(job["batch"], runner.device)
    draws = [None if u is None else torch.as_tensor(u, device=runner.device)
             for u in job["draws"]]
    pri = None if job.get("priorities") is None else \
        torch.as_tensor(job["priorities"], device=runner.device)
    sharded = runner.points > 1
    out = {"rank": mesh.rank, "ray_index": mesh.ray_index,
           "point_index": mesh.point_index}
    _reset_peak(runner.device)
    items, g_net, g_pts = sharded_grads(ts, grid, batch, opt, spec, mesh,
                                        draws[0], sharded, pri)
    out["items"] = {k: float(v) for k, v in items.items()}
    out["g_net"] = {k: _np(v) for k, v in g_net.items()}
    out["g_pts"] = {k: _np(mesh.gather_points(v) if sharded else v)
                    for k, v in g_pts.items()}
    with torch.no_grad():
        q = render_query(runner.whole_points(ts).points,
                         runner.whole_grid(grid), spec,
                         _with_comp_groups(opt, mesh),
                         shard_batch(batch, mesh), is_train=True,
                         u=None if draws[0] is None
                         else shard_rays(draws[0], mesh),
                         shards=mesh.shards(), priorities=pri)
    out["comp_shape"] = None if q.comp is None else tuple(q.comp[0].shape)
    # the compaction rows this rank shades (the vox-grid compacts on the
    # shade side, into its share's buffer)
    out["rows"] = out["comp_shape"][1] if q.comp is not None else \
        q.share.rows if q.share is not None else None
    out["shapes"] = {
        **{f"pt/{k}": tuple(v.shape) for k, v in
           {**ts.pt_static, **ts.pt_train}.items() if v is not None},
        **{f"grid/{k}": tuple(v.shape) for k, v in (grid or {}).items()},
        **{f"adam/{i}": tuple(st["exp_avg"].shape) for i, st in
           enumerate(ts.opt_pts.state.values())}}
    out["bytes"] = runner.at_rest_bytes(ts, grid)
    step = (make_mp_train_step if sharded else make_dp_train_step)(
        opt, spec, mesh)
    before = {k.name: k.launches for k in kernels.KERNELS}
    out["step_items"], out["step_s"] = [], []
    for u in draws:
        _sync(runner.device)
        t0 = time.perf_counter()
        ts, it = step(ts, grid, batch, u=u, priorities=pri)
        vals = {k: float(v) for k, v in it.items()}
        _sync(runner.device)
        out["step_s"].append(time.perf_counter() - t0)
        out["step_items"].append(vals)
    out["launches"] = {k.name: k.launches - before[k.name]
                       for k in kernels.KERNELS}
    out["peak_bytes"] = _peak(runner.device)
    out["net_after"] = {k: _np(v) for k, v in
                        ts.aggregator.named_parameters()}
    out["points_after"] = {k: _np(mesh.gather_points(v.detach())
                                  if sharded else v)
                           for k, v in ts.pt_train.items()}
    return out


def scan_job(job: Dict, device) -> Dict:
    """`MeshRunner.train_steps_scan` on the job's batch repeated `steps`
    times with its draws [steps, ...]: the items of every step, the net
    weights and the joined point buffers after them."""
    opt, runner, ts, grid = _placed(job, device)
    batch = _batch(job["batch"], runner.device)
    batches = {k: (torch.stack([v] * job["steps"]) if torch.is_tensor(v)
                   else v) for k, v in batch.items()}
    ts, items = runner.train_steps_scan(
        ts, grid, batches, opt, job["spec"],
        torch.as_tensor(job["draws"], device=runner.device))
    sharded = runner.points > 1
    return {"items": {k: _np(v) for k, v in items.items()},
            "net_after": {k: _np(v) for k, v in
                          ts.aggregator.named_parameters()},
            "points_after": {k: _np(runner.mesh.gather_points(v.detach())
                                    if sharded else v)
                             for k, v in ts.pt_train.items()}}


def serve_job(job: Dict, device) -> Dict:
    """One image by mesh serving: the maps, its counters and seconds."""
    opt, runner, ts, grid = _placed(job, device)
    stats: Dict = {}
    _sync(runner.device)
    _reset_peak(runner.device)
    t0 = time.perf_counter()
    maps = render_image(ts, grid, opt, job["spec"], job["item"],
                        keys=tuple(job.get("keys", ("coarse_raycolor",
                                                    "ray_mask"))),
                        group=job.get("group", 8), stats=stats,
                        prob=job.get("prob", False), runner=runner)
    _sync(runner.device)
    return {"rank": runner.mesh.rank, "maps": maps, "stats": stats,
            "seconds": time.perf_counter() - t0,
            "peak_bytes": _peak(runner.device)}


def eval_job(job: Dict, device) -> Dict:
    """The sharded eval step (`make_dp_eval_step`, or `make_mp_eval_step`
    with point shards) on the job's batch: the whole batch's outputs."""
    opt, runner, ts, grid = _placed(job, device)
    make = make_mp_eval_step if runner.points > 1 else make_dp_eval_step
    _sync(runner.device)
    _reset_peak(runner.device)
    t0 = time.perf_counter()
    out = make(opt, job["spec"], runner.mesh)(
        ts, grid, _batch(job["batch"], runner.device))
    _sync(runner.device)
    res = {k: _np(v) for k, v in out.items()}
    res.update(seconds=time.perf_counter() - t0,
               peak_bytes=_peak(runner.device))
    return res


JOBS = {"step": step_job, "scan": scan_job, "serve": serve_job,
        "eval": eval_job}


def run_jobs(jobs: List[Dict], device=None, runner=None) -> List[Dict]:
    """Every job in order on this rank (the function `launch` runs), each
    result with this process's kernel launches in it (a step job's: its
    timed steps'). A job with `all_ranks` returns every rank's result as a
    list, gathered through the group; the others this rank's (rank 0's
    reach the caller)."""
    out = []
    for job in jobs:
        before = {k.name: k.launches for k in kernels.KERNELS}
        res = JOBS[job["kind"]](job, device)
        res.setdefault("launches", {k.name: k.launches - before[k.name]
                                    for k in kernels.KERNELS})
        if job.get("all_ranks"):
            box = [None] * runner.mesh.size
            dist.all_gather_object(box, res)
            res = box
        out.append(res)
    return out
