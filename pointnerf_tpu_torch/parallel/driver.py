"""The drivers' multi-GPU runner: the `--n_devices` / `--gpu_ids` /
`--mesh_points` semantics (port of `pointnerf_tpu/parallel/driver.py`).

The reference engages DataParallel from `--gpu_ids`; the JAX package
builds a device mesh from `--n_devices` (which `config.validate_options`
maps multi-id `--gpu_ids` onto) and routes every device interaction of
its drivers through a `MeshRunner`. Here the devices are the ranks of a
`torch.distributed` group, one process per card:

* `world_size(opt, device)` is JAX's `make_runner` rule: 0 (no runner)
  for n_devices ∈ {0, 1} with mesh_points ≤ 1, else the rank count: -1,
  or 0 with mesh_points > 1, means every local device. A CUDA machine
  counts its cards. The CPU counts one device, as a JAX CPU backend does
  without its virtual-device flag, so -1 is one rank there; an explicit
  N > 1 on the CPU runs N gloo processes (the CPU's ranks are processes,
  a deliberate deviation). More ranks than cards, or a mesh_points that
  does not divide the ranks, raises ValueError.
* `launch` runs a driver on the ranks: one rank in the calling process
  (a world-size-1 group), more as spawned processes, one per card, on
  NCCL (gloo on the CPU). The store is a file under the run's directory.
  There is no fallback: a failed init, a rank that dies or a collective
  that fails raises and ends the run; rank 0's result comes back.
* `MeshRunner` holds the mesh. The ray batch shards over the ranks
  (`dp.py`); with mesh_points > 1 the capacity buffers, their Adam
  moments and the bucket tables shard too (`points.py`). Rare host events
  (prune, probe-and-grow, checkpoints) gather the state, run the
  single-device code on rank 0 and place the result on every rank again
  (`host_event`), so every rank leaves the event with the same state.
  Only rank 0 writes logs, images and checkpoints, the single-device
  files.
"""

from __future__ import annotations

import os
import pickle
import uuid
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..models.aggregator import Aggregator
from ..train import trainer
from ..utils.checkpoint import train_state_arrays, train_state_from_arrays
from . import points as pts
from .dp import sharded_train_step
from .mesh import Mesh, make_mesh, replicate

_GENERATOR = "__generator_state"


def local_devices(device) -> int:
    """The devices a runner may use: the cards on CUDA, one CPU."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return 1


def world_size(opt, device) -> int:
    """The ranks the options ask for on `device`'s kind; 0 for one device
    without a runner."""
    if opt.n_devices in (0, 1) and opt.mesh_points <= 1:
        return 0
    avail = local_devices(device)
    n = opt.n_devices
    if n in (0, -1):
        n = avail
    if torch.device(device).type == "cuda" and n > avail:
        raise ValueError(f"--n_devices {n} exceeds the {avail} available "
                         f"devices")
    if n < 1 or n % opt.mesh_points:
        raise ValueError(f"--mesh_points {opt.mesh_points} must divide the "
                         f"{n} devices (--n_devices {opt.n_devices})")
    return n


class _Quiet:
    """The visualizer of a rank other than 0: writes and prints nothing."""

    def __init__(self, image_dir: str):
        self.image_dir = image_dir

    def __getattr__(self, name):
        return lambda *a, **k: None


class MeshRunner:
    """The mesh of the current process group and the runner's steps."""

    def __init__(self, points: int = 1, device=None):
        if not dist.is_initialized():
            raise RuntimeError("a MeshRunner runs inside the ranks of "
                               "parallel.driver.launch")
        self.points = int(points)
        self.mesh: Mesh = make_mesh(None, 1, self.points, device)
        self.n_devices = self.mesh.size
        self.device = self.mesh.device

    @property
    def is_main(self) -> bool:
        return self.mesh.rank == 0

    def describe(self) -> str:
        return (f"mesh {self.mesh.shape} over {self.n_devices} ranks "
                f"({self.mesh.backend})"
                + (" (point buffers sharded)" if self.points > 1 else ""))

    def visualizer(self, make):
        """make() on rank 0; a silent stand-in elsewhere."""
        if self.is_main:
            return make()
        return _Quiet("")

    # -------------------------------------------------------------- placement
    def place_state(self, ts: Optional[trainer.TrainState], opt
                    ) -> trainer.TrainState:
        """rank 0's whole train state (None elsewhere) on every rank: the
        capacity leaves sharded when mesh_points > 1, the jitter
        generator's state the same everywhere."""
        flat = None
        if self.is_main:
            flat = train_state_arrays(ts)
            flat[_GENERATOR] = ts.generator.get_state().numpy()
        flat = self.mesh.broadcast_arrays(flat)
        gen = flat.pop(_GENERATOR)
        return self.state_from_arrays(flat, opt, torch.from_numpy(gen))

    def state_from_arrays(self, flat: Dict[str, np.ndarray], opt,
                          generator_state: Optional[torch.Tensor] = None
                          ) -> trainer.TrainState:
        """This rank's train state from the whole flattened state
        (`utils.checkpoint.train_state_arrays`) every rank holds."""
        if self.points > 1:
            flat = pts.shard_state_arrays(flat, self.mesh)
        state = train_state_from_arrays(flat, opt, self.device)
        if generator_state is not None:
            state.generator.set_state(generator_state)
        return state

    def place_grid(self, grid: Optional[Dict], spec) -> Dict:
        """rank 0's whole grid (None elsewhere) on every rank, its bucket
        tables sharded when mesh_points > 1."""
        return pts.shard_grid(replicate(grid, self.mesh), spec, self.mesh)

    def gather_state(self, ts: trainer.TrainState, opt
                     ) -> Optional[trainer.TrainState]:
        """The whole train state on rank 0 (None elsewhere), for the
        single-device host code; every rank calls it."""
        flat = train_state_arrays(ts)
        if self.points > 1:
            cap = pts.capacity(flat)
            for k, v in flat.items():
                if pts.is_capacity_key(k, v, cap):
                    t = torch.from_numpy(np.ascontiguousarray(v))
                    flat[k] = self.mesh.gather_points(
                        t.to(self.device)).cpu().numpy()
        if not self.is_main:
            return None
        state = train_state_from_arrays(flat, opt, self.device)
        state.generator.set_state(ts.generator.get_state())
        return state

    def host_event(self, ts, grid, spec, opt, fn: Callable):
        """fn(whole ts) -> (ts, grid, info) run on rank 0 on the gathered
        state; the resulting state and grid placed on every rank and info
        sent to every rank. Returns (ts, grid, info)."""
        whole = self.gather_state(ts, opt)
        out = fn(whole) if self.is_main else (None, None, None)
        info = self.mesh.broadcast_object(out[2])
        return self.place_state(out[0], opt), self.place_grid(out[1], spec), \
            info

    def whole_points(self, ts) -> trainer.ServeState:
        """The aggregator and every point buffer joined (transient)."""
        return trainer.ServeState(ts.aggregator,
                                  pts.full_points(ts, self.mesh))

    def whole_grid(self, grid: Dict) -> Dict:
        return pts.full_grid(grid, self.mesh)

    def shard_grid(self, grid: Dict, spec) -> Dict:
        """This rank's part of a whole grid every rank holds."""
        return pts.shard_grid(grid, spec, self.mesh)

    def at_rest_bytes(self, ts, grid) -> Dict[str, int]:
        return pts.at_rest_bytes(ts, grid)

    # ------------------------------------------------------------------ steps
    def train_step(self, ts, grid, batch: Dict, opt, spec, u=None):
        """One step of the whole batch (the same on every rank) from this
        rank's shard; items are the whole batch's."""
        return sharded_train_step(ts, grid, batch, opt, spec, self.mesh, u=u,
                                  points_sharded=self.points > 1)

    def train_steps_scan(self, ts, grid, batches: Dict, opt, spec, u=None):
        """S steps of stacked batches [S, ...] (JAX driver.py:135-138),
        each sharded by ray as `train_step` shards one; the items are the
        whole batch's, read back once. They run one after another, not
        graphed: their collectives are not captured (`train.graph`)."""
        return trainer.steps_in_turn(
            lambda st, b, us: self.train_step(st, grid, b, opt, spec, us),
            ts, batches, u)


def make_runner(opt, device="cuda") -> Optional[MeshRunner]:
    """A MeshRunner over the current process group when the options ask
    for more than one device, else None (the drivers' one decision
    point; `launch` starts the group)."""
    n = world_size(opt, device)
    if n == 0:
        return None
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(f"the options ask for {n} ranks: run the driver "
                           f"through parallel.driver.launch")
    return MeshRunner(opt.mesh_points, device)


# ------------------------------------------------------------------ launch
def _portable(obj):
    """A rank's result as the parent can take it: tensors, modules and
    states on the CPU, the train state as its ServeState."""
    if isinstance(obj, trainer.TrainState):
        obj = trainer.ServeState(obj.aggregator, obj.points)
    if isinstance(obj, trainer.ServeState):
        return trainer.ServeState(
            obj.aggregator.cpu(),
            {k: (None if v is None else v.detach().cpu())
             for k, v in obj.points.items()})
    if isinstance(obj, (torch.Tensor, Aggregator)):
        return obj.detach().cpu() if isinstance(obj, torch.Tensor) \
            else obj.cpu()
    if isinstance(obj, dict):
        return {k: _portable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields"):
        return type(obj)(_portable(v) for v in obj)
    return obj


def _rank_device(device, rank: int, shared: bool) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", 0 if shared else rank)


def _rank_main(rank, n, backend, store, device, shared, points, threads,
               queue):
    """A spawned rank: join the group, run the launched function with the
    runner, send rank 0's result to the parent. The function and its
    arguments come from a file beside the store: passed through the spawn
    pipe, they would start the ranks one after another (the parent waits
    on each child's imports while it writes them)."""
    torch.set_num_threads(threads)
    with open(store + ".call", "rb") as f:
        fn, args, kwargs = pickle.load(f)
    dev = _rank_device(device, rank, shared)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="file://" + store,
                            world_size=n, rank=rank)
    try:
        res = fn(*args, **kwargs, device=dev,
                 runner=MeshRunner(points, dev))
        if rank == 0:
            # plain bytes: torch's queue would share tensors through file
            # descriptors that die with this process
            queue.put(pickle.dumps(_portable(res)))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, args: tuple, n: int, points: int, device,
           run_dir: str, kwargs: Optional[Dict] = None,
           backend: Optional[str] = None, shared: bool = False,
           threads: Optional[int] = None):
    """fn(*args, **kwargs, device=<the rank's device>, runner=<its
    MeshRunner>) on n ranks; returns rank 0's result.

    n == 1 runs in this process (over a world-size-1 group it starts,
    unless one is running); n > 1 spawns n processes (torch.multiprocessing,
    "spawn"), each on its own card on CUDA. backend: NCCL on CUDA, gloo on
    the CPU, unless given; shared puts every rank on card 0 (only gloo
    takes several ranks on one card). threads: each spawned rank's torch
    threads (this process's share by default). The group's store is a
    file under run_dir, removed afterwards. A rank's failure raises here,
    and the other ranks are stopped."""
    kwargs = dict(kwargs or {})
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    os.makedirs(run_dir, exist_ok=True)
    store = os.path.abspath(os.path.join(
        run_dir, f".dist_store_{uuid.uuid4().hex}"))
    try:
        if n == 1:
            own = not dist.is_initialized()
            if own:
                dist.init_process_group(backend, init_method="file://" + store,
                                        world_size=1, rank=0)
            try:
                if dev.type == "cuda" and dev.index is None:
                    dev = torch.device("cuda", torch.cuda.current_device())
                return fn(*args, **kwargs, device=dev,
                          runner=MeshRunner(points, dev))
            finally:
                if own:
                    dist.destroy_process_group()
        ctx = mp.get_context("spawn")
        queue = ctx.SimpleQueue()
        threads = threads or max(1, torch.get_num_threads() // n)
        with open(store + ".call", "wb") as f:
            pickle.dump((fn, args, kwargs), f)
        procs = mp.start_processes(
            _rank_main, args=(n, backend, store, str(dev), shared, points,
                              threads, queue),
            nprocs=n, join=False, start_method="spawn")
        res = None
        while True:
            if res is None and not queue.empty():
                res = queue.get()
            if procs.join(timeout=0.2):
                break
        if res is None and not queue.empty():
            res = queue.get()
        if res is None:
            raise RuntimeError("rank 0 ended without a result")
        return pickle.loads(res)
    finally:
        for path in (store, store + ".call"):
            if os.path.exists(path):
                os.remove(path)
