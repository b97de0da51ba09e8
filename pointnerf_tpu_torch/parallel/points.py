"""Point-axis sharding (port of `pointnerf_tpu/parallel/points.py`).

With mesh_points M > 1 each rank holds, at rest, cap / M rows of every
capacity buffer (the point buffers, trainable or not, and the points-side
Adam moments) and max_o / M rows of the voxel bucket tables (`occ_2_xyz`,
`super_xyz`); the dense voxel maps (`coor_2_occ`, `coor_occ_rows`,
`coor_slot`, the vox-grid's `vox_table`) and the aggregator stay whole on
every rank. Shard p of a buffer is its rows [p·n, (p+1)·n), n = cap / M,
held by the ranks of point index p.

A step joins the shards into transient full buffers over the ranks that
share its ray index (the query reads any table row, the shade phase any
point), computes its ray shard on them, and reduces the full-buffer point
gradient back to its rows over the ranks that share its point index
(`Mesh.sum_rows`): K6 still scatters into the full-capacity gradient
first. The Adam update is elementwise, so each rank updates only its rows
and nothing reshards between steps. The JAX package lets GSPMD insert the
same gathers and reduction.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..train import trainer
from .mesh import Mesh

# the flattened train state's capacity leaves (utils/checkpoint's layout)
CAPACITY_PREFIXES = (".pt_train/", ".pt_static/", ".opt_state_pts/0/.mu/",
                     ".opt_state_pts/0/.nu/")
BUCKET_KEYS = ("occ_2_xyz", "super_xyz")


def _rows(a, n_shards: int, index: int, what: str):
    if a.shape[0] % n_shards:
        raise ValueError(f"{what} of {a.shape[0]} rows does not split over "
                         f"--mesh_points {n_shards}")
    n = a.shape[0] // n_shards
    return a[index * n:(index + 1) * n]


def capacity(flat: Dict[str, np.ndarray]) -> int:
    return int(flat[".pt_static/mask"].shape[0])


def is_capacity_key(key: str, value, cap: int) -> bool:
    return key.startswith(CAPACITY_PREFIXES) and np.ndim(value) >= 1 \
        and value.shape[0] == cap


def shard_state_arrays(flat: Dict[str, np.ndarray], mesh: Mesh
                       ) -> Dict[str, np.ndarray]:
    """This rank's rows of every capacity leaf of a flattened train state
    (`utils.checkpoint.train_state_arrays`); the rest whole. ValueError
    naming the capacity if M does not divide it."""
    cap = capacity(flat)
    return {k: (_rows(v, mesh.points, mesh.point_index, "a point capacity")
                if is_capacity_key(k, v, cap) else v)
            for k, v in flat.items()}


def shard_grid(grid: Dict[str, torch.Tensor], spec, mesh: Mesh
               ) -> Dict[str, torch.Tensor]:
    """This rank's rows of the bucket tables (max_o rows); the dense
    voxel maps whole. ValueError naming max_o if M does not divide it. No
    grid (the frustum path's, built per camera) stays None."""
    if mesh.points == 1 or grid is None:
        return grid
    return {k: (_rows(v, mesh.points, mesh.point_index, "max_o")
                if k in BUCKET_KEYS else v) for k, v in grid.items()}


def full_grid(grid: Dict[str, torch.Tensor], mesh: Mesh
              ) -> Dict[str, torch.Tensor]:
    """The bucket tables joined from the point shards (transient)."""
    if mesh.points == 1 or grid is None:
        return grid
    return {k: (mesh.gather_points(v) if k in BUCKET_KEYS else v)
            for k, v in grid.items()}


def _shard_cap(ts) -> int:
    pts = ts.pt_static if isinstance(ts, trainer.TrainState) else ts.points
    return int(pts["mask"].shape[0])


def full_points(ts, mesh: Mesh) -> Dict[str, Optional[torch.Tensor]]:
    """Every point buffer joined from the point shards (transient, no
    gradient)."""
    pts = trainer.point_state_of(ts)
    cap = _shard_cap(ts)
    return {k: (None if v is None else
                mesh.gather_points(v.detach()) if v.dim() >= 1
                and v.shape[0] == cap else v) for k, v in pts.items()}


def full_view(ts: trainer.TrainState, mesh: Mesh) -> trainer.TrainState:
    """A train state over the joined buffers for a step's forward and
    backward: the trainable buffers are fresh leaves, whose gradients are
    the full-buffer gradients that `Mesh.sum_rows` reduces."""
    if mesh.points == 1:
        return ts
    cap = _shard_cap(ts)
    join = lambda v: v if v is None or v.dim() == 0 or v.shape[0] != cap \
        else mesh.gather_points(v.detach())
    return trainer.TrainState(
        aggregator=ts.aggregator,
        pt_train={k: join(v).requires_grad_(True)
                  for k, v in ts.pt_train.items()},
        pt_static={k: join(v) for k, v in ts.pt_static.items()},
        opt_net=ts.opt_net, opt_pts=ts.opt_pts, step=ts.step,
        generator=ts.generator)


def at_rest_bytes(ts: trainer.TrainState, grid: Dict[str, torch.Tensor]
                  ) -> Dict[str, int]:
    """This rank's bytes of the capacity buffers (point buffers and their
    Adam moments) and of the bucket tables."""
    cap = _shard_cap(ts)
    buf = sum(v.numel() * v.element_size() for v in
              list(ts.pt_train.values()) + list(ts.pt_static.values())
              if v is not None and v.dim() >= 1 and v.shape[0] == cap)
    for st in ts.opt_pts.state.values():
        buf += sum(st[k].numel() * st[k].element_size()
                   for k in ("exp_avg", "exp_avg_sq") if k in st)
    tables = sum(grid[k].numel() * grid[k].element_size()
                 for k in BUCKET_KEYS if grid is not None and k in grid)
    return {"capacity_bytes": int(buf), "bucket_bytes": int(tables)}


def make_mp_train_step(opt, spec, mesh: Mesh):
    """step(ts, grid, batch, u=None, priorities=None) -> (ts, items) over
    point-sharded state and grid (`parallel.dp.sharded_train_step`)."""
    from .dp import sharded_train_step

    def step(ts, grid, batch, u=None, priorities=None):
        return sharded_train_step(ts, grid, batch, opt, spec, mesh, u=u,
                                  points_sharded=True, priorities=priorities)
    return step


def make_mp_eval_step(opt, spec, mesh: Mesh, prob: bool = False):
    """eval(ts, grid, batch) -> the whole batch's outputs, over
    point-sharded state and grid."""
    from .dp import sharded_eval_step

    def ev(ts, grid, batch):
        return sharded_eval_step(ts, grid, batch, opt, spec, mesh, prob=prob,
                                 points_sharded=True)
    return ev
