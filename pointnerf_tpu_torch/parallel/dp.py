"""Ray-sharded train and eval steps (port of
`pointnerf_tpu/parallel/dp.py`).

Each rank renders its shard of the ray batch (`mesh.shard_batch`) and the
shards' results combine into exactly the whole batch's step, as the JAX
package's GSPMD step equals its single-device step:

* every loss is a ratio of sums over the whole batch, so each rank's
  numerators, denominators and counters are summed over the ray shards,
  all in one collective (`models.losses.over_shards`: forward the sum,
  backward the identity), before they are divided; the gradients the
  ranks then compute sum to the whole batch's (a mean of per-rank means,
  as DataParallel takes, would not);
* the world query's compaction budget reads the whole batch's row count
  and splits over comp_groups groups, set to the ray shards unless the
  user set it, so a rank's groups are the single-device run's groups of
  its rays (`models.renderer.comp_budget`);
* the frustum query (wcoord_query 0) and the vox-grid query (NN < 0)
  compact each camera row into one budget, which comp_groups does not
  split: a rank keeps its valid rows that follow fewer than the budget's
  rows of its camera row, counted over the ray shards before it
  (`Mesh.row_prefix`, one all-gather), into a buffer sized to the rows
  it keeps, and the wide K tier's budget is shared the same way; each
  rank counts the rows it drops, so the counts sum to the whole row's
  (`models.renderer.RowShare`);
* every rank draws the whole batch's jitter (and the frustum's NN ≤ 0
  priorities) from the same generator state and takes its slice;
* the net and point gradients are summed over the ray shards, once each
  (the ranks that share a ray index compute the same shard), and every
  rank runs the same Adam update, so the net weights stay equal.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..train import trainer
from . import points as pts
from .mesh import Mesh, shard_batch, shard_rays, unshard_rays


def _with_comp_groups(opt, mesh: Mesh):
    """comp_groups set to the ray shards per camera row (JAX's mesh
    "rays" axis) unless the user set it: each rank then compacts its own
    rays into its own budget slices, and the shade phase runs on the
    rank's rows only."""
    g = mesh.rays
    if int(getattr(opt, "comp_groups", 1)) != 1 or g <= 1:
        return opt
    return opt.replace(comp_groups=g)


def _sum_tensors(mesh: Mesh, d: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """Each tensor of d summed over the ray shards, in one collective."""
    if not d:
        return d
    keys = list(d)
    flat = mesh.plane_sum(torch.cat([d[k].reshape(-1) for k in keys]))
    out, off = {}, 0
    for k in keys:
        n = d[k].numel()
        out[k] = flat[off:off + n].reshape(d[k].shape)
        off += n
    return out


def sharded_grads(ts, grid, batch: Dict, opt, spec, mesh: Mesh,
                  u: Optional[torch.Tensor], points_sharded: bool = False,
                  priorities: Optional[torch.Tensor] = None):
    """(items, net grads, point grads) of the whole batch: the items and
    net gradients are the same on every rank, the point gradients are
    this rank's rows (its shard when points_sharded, else the whole
    buffers). batch and u (`trainer.jitter_draws`) are the whole batch's;
    priorities the whole row's (the frustum's NN ≤ 0, drawn when None)."""
    view = pts.full_view(ts, mesh) if points_sharded else ts
    g = pts.full_grid(grid, mesh) if points_sharded else grid
    items, g_net, g_pts = trainer.compute_grads(
        view, g, shard_batch(batch, mesh), _with_comp_groups(opt, mesh), spec,
        None if u is None else shard_rays(u, mesh), shards=mesh.shards(),
        reduce=mesh.plane_sum, priorities=priorities)
    if points_sharded:
        return items, _sum_tensors(mesh, g_net), mesh.sum_rows(g_pts)
    both = _sum_tensors(mesh, {**{("net", k): v for k, v in g_net.items()},
                               **{("pts", k): v for k, v in g_pts.items()}})
    return items, {k: both[("net", k)] for k in g_net}, \
        {k: both[("pts", k)] for k in g_pts}


def sharded_train_step(ts, grid, batch: Dict, opt, spec, mesh: Mesh,
                       u=None, points_sharded: bool = False,
                       priorities=None):
    """One step of the whole batch from this rank's shard, in place (the
    sharded `trainer.train_step`). u: the whole batch's draws; None draws
    them from ts.generator, the same on every rank."""
    if u is None:
        u = trainer.jitter_draws(ts, batch, opt)
    items, g_net, g_pts = sharded_grads(ts, grid, batch, opt, spec, mesh, u,
                                        points_sharded, priorities)
    return trainer.apply_grads(ts, g_net, g_pts, opt), items


@torch.inference_mode()
def sharded_eval_step(ts, grid, batch: Dict, opt, spec, mesh: Mesh,
                      prob: bool = False, points_sharded: bool = False
                      ) -> Dict:
    """The whole batch's eval outputs from each rank's shard: the per-ray
    outputs ([B, R, ...]) joined over the ray shards, the counters summed;
    the compact-form loss leaves are left out."""
    if points_sharded:
        ts = trainer.ServeState(ts.aggregator, pts.full_points(ts, mesh))
        grid = pts.full_grid(grid, mesh)
    local = shard_batch(batch, mesh)
    Bl, Rl = local["raydir"].shape[:2]
    out = trainer.eval_step(ts, grid, local, _with_comp_groups(opt, mesh),
                            spec, prob=prob, shards=mesh.shards())
    full = {}
    for k, v in out.items():
        if v is None or k in trainer.COMPACT_KEYS:
            continue
        if v.dim() == 0:
            full[k] = mesh.plane_sum(v)
        elif v.dim() >= 2 and tuple(v.shape[:2]) == (Bl, Rl):
            full[k] = unshard_rays(v, mesh)
    return full


def make_dp_train_step(opt, spec, mesh: Mesh):
    """step(ts, grid, batch, u=None, priorities=None) -> (ts, items) with
    the state and the grid whole on every rank and the batch split over
    the ray shards."""
    def step(ts, grid, batch, u=None, priorities=None):
        return sharded_train_step(ts, grid, batch, opt, spec, mesh, u=u,
                                  priorities=priorities)
    return step


def make_dp_eval_step(opt, spec, mesh: Mesh, prob: bool = False):
    """eval(ts, grid, batch) -> the whole batch's outputs, with the state
    and grid whole on every rank."""
    def ev(ts, grid, batch):
        return sharded_eval_step(ts, grid, batch, opt, spec, mesh, prob=prob)
    return ev
