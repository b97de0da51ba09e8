"""Multi-GPU training and serving on `torch.distributed` (port of
`pointnerf_tpu/parallel/`).

The JAX package shards its steps with GSPMD over a ("batch", "rays"[,
"points"]) device mesh: rays are independent, so the ray batch splits
over the mesh (`dp.py`), and with `--mesh_points` the point buffers, the
voxel bucket tables and their Adam moments split over a "points" axis
(`points.py`). Here each device is a rank of a process group and the same
placement is explicit: `mesh.py` lays the ranks out as JAX lays out its
devices and holds the collectives, and `driver.py` runs the drivers on the
ranks. Each sharded step equals the single-device step: its losses are
sums over the whole batch, and its compaction blocks per ray shard
(`opt.comp_groups`).
"""

from .mesh import Mesh, layout, make_mesh, replicate, shard_batch
from .dp import (make_dp_eval_step, make_dp_train_step, sharded_eval_step,
                 sharded_train_step)
from .points import (make_mp_eval_step, make_mp_train_step, shard_grid,
                     shard_state_arrays)
from .driver import MeshRunner, launch, make_runner, world_size

__all__ = [
    "Mesh", "layout", "make_mesh", "replicate", "shard_batch",
    "make_dp_train_step", "make_dp_eval_step", "sharded_train_step",
    "sharded_eval_step", "make_mp_train_step", "make_mp_eval_step",
    "shard_grid", "shard_state_arrays", "MeshRunner", "launch",
    "make_runner", "world_size",
]
