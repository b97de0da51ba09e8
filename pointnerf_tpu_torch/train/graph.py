"""The train step as a CUDA graph: the card's form of the JAX package's
multi-step dispatch (`trainer.train_steps_scan`, a lax.scan of S train
steps in one program, pointnerf_tpu/train/trainer.py:291-309, driven by
`steps_per_dispatch`).

The scan amortises the TPU's dispatch cost. On the card the cost is the
host's: an eager train step launches about 1,100 kernels from Python
(PERF.md §5). Here one train step, `trainer.compute_grads` then
`trainer.apply_grads` with every kernel they launch (K1, K2, K3, K6; K4
and K5 under fused_shade, K1b and K2b under trunk_dtype bfloat16), is
captured once and replayed S times a dispatch (`graphed_steps`):

* The graph reads static buffers: one step's batch leaves, its draws,
  its depth samples (`models.renderer.ray_depths` of the step's near and
  far, which a dataset may set per view, in their place) and its knobs
  (net_on, pts_on, lr, plr: the alter_step gates and the scheduled lrs,
  which an eager step takes as Python numbers), and writes its loss items
  into one vector. Before each replay the step's leaves, depths and knobs
  are copied in on the device; after it the items, and the step's row
  counts (`trainer.step_row`), go into the dispatch's [S, n_items +
  n_counts] buffer, which reaches the host in one copy
  (`trainer.read_rows`).
* The draws are not captured: before each replay the step's draws are
  drawn from state.generator (`trainer.jitter_draws`) into the static
  buffer, in step order, so the generator's stream is the eager loop's.
* A new key's first step runs eagerly on the capture stream (the
  warm-up: the optimizers' lazy state, the kernels' build, cuBLAS's
  workspace for that stream, the cached constants of `ops.grid.
  host_const`), and the next step is captured from the state it leaves.
* The key is every shape, the options, the spec and the address of every
  tensor the step reads or writes: the aggregator's weights, the point
  buffers, the Adam state and lr, the grid's tables. A host event that
  replaces one (a prune or grow rebuilds the grid, `expand_capacity` the
  buffers, a budget raise or a plateau changes the options) changes the
  key; the old graph and its memory pool are dropped before the next
  capture (the driver drops them at the event, `drop`). A train state
  holds one graph at a time, with its capture stream and its counts of
  captures and replays (`Dispatch`, `TrainState.dispatch`).
* The capture runs under `torch.cuda.set_sync_debug_mode("error")`, so a
  host read inside the step raises; so does any other failure of the
  capture or of a replay. Nothing gives way to the eager steps.

The Python launch counters (`ops.kernels.Kernel.launches`) count what the
capture records once; every replay adds the captured step's launches
again, so the counts equal the eager loop's.

`graph_route(opt)` is the one rule for which configurations of one device
run graphed; `config.py` states it beside steps_per_dispatch. A runner's
sharded steps (`parallel.driver.MeshRunner.train_steps_scan`) run in turn:
their collectives are not captured (gloo stages CUDA tensors through host
memory, and an NCCL capture is not built).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models import renderer
from ..ops import kernels
from ..utils import profiling
from . import trainer


def graph_route(opt) -> str:
    """"graphed" or "eager": how `trainer.train_steps_scan` runs a
    dispatch of this configuration on the card (the CPU always runs the
    steps in turn). Eager, with the host read that keeps it out: the
    frustum query (wcoord_query 0), whose step builds the camera's grid
    from the points (`ops.grid.build_grid` keeps the occupied voxels by a
    boolean select, whose size the host reads). Every other configuration
    runs graphed."""
    return "eager" if opt.wcoord_query == 0 else "graphed"


class StepGraph:
    """One captured train step, its static buffers and its key; its row
    (`trainer.step_row`: the items `names`, the device counts `counted`)
    and the host counts of one step (`host`)."""

    def __init__(self, key, names: List[str], counted: List[str]):
        self.key = key
        self.names = names
        self.counted = counted
        self.graph = torch.cuda.CUDAGraph()
        self.batch: Dict = {}
        self.u: Optional[torch.Tensor] = None
        self.knobs: Optional[torch.Tensor] = None
        self.items: Optional[torch.Tensor] = None
        self.host: Dict[str, int] = {}
        self.launches: List[Tuple[kernels.Kernel, int]] = []


class Dispatch:
    """A train state's graphed dispatch: its capture stream (one, so that
    the cuBLAS workspace of that stream is made by the first warm-up,
    outside any capture), the live graph, and the captures and replays
    made."""

    def __init__(self, dev: torch.device):
        self.stream = torch.cuda.Stream(device=dev)
        self.graph: Optional[StepGraph] = None
        self.captures = 0
        self.replays = 0

    def replay(self, state, batch: Dict, u, knobs: torch.Tensor) -> None:
        """One step through the live graph: this step's leaves, draws and
        knobs in, the replay, and the host's step counts and launch
        counters advanced."""
        g = self.graph
        for k, buf in g.batch.items():
            if torch.is_tensor(buf):
                buf.copy_(batch[k])
        if g.u is not None:
            g.u.copy_(u)
        g.knobs.copy_(knobs)
        g.graph.replay()
        self.replays += 1
        state.step += 1
        state.opt_net.count += 1
        state.opt_pts.count += 1
        for k, n in g.launches:
            k.launches += n

    def drop(self) -> None:
        """Drop the live graph, its static buffers and its memory pool."""
        g, self.graph = self.graph, None
        if g is not None:
            g.graph.reset()
            del g           # its static buffers too, before the cache goes
            torch.cuda.empty_cache()


def drop(state) -> None:
    """Drop the state's graph and its memory (a host event replaces what
    it captured); a no-op without one."""
    if getattr(state, "dispatch", None) is not None:
        state.dispatch.drop()


def _sig(t: torch.Tensor) -> tuple:
    return (t.data_ptr(), tuple(t.shape), tuple(t.stride()), t.dtype)


def step_key(state, grid, batch: Dict, u, opt, spec) -> tuple:
    """What a captured step bakes in: the options, the spec, the shapes,
    the batch's Python values and the address of every tensor of the state
    and the grid."""
    tensors = [*state.aggregator.parameters(), *state.pt_train.values(),
               *(v for v in state.pt_static.values() if v is not None)]
    for optim in (state.opt_net, state.opt_pts):
        tensors += [g["lr"] for g in optim.param_groups]
        for st in optim.state.values():
            tensors += [st[k] for k in ("step", "exp_avg", "exp_avg_sq")]
    return (opt, spec, tuple(_sig(t) for t in tensors),
            tuple((k, _sig(v) if torch.is_tensor(v) else v)
                  for k, v in sorted((grid or {}).items())),
            tuple((k, (tuple(v.shape), v.dtype) if torch.is_tensor(v)
                   else v) for k, v in sorted(batch.items())),
            None if u is None else (tuple(u.shape), u.dtype))


@contextlib.contextmanager
def _syncs_raise():
    """Any host sync inside the block raises (the sync debug mode)."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def capture(state, grid, batch: Dict, u, opt, spec, key, names: List[str],
            counted: List[str], stream: torch.cuda.Stream) -> StepGraph:
    """Capture one train step from `state` on `stream` (nothing runs; the
    host's step counts and launch counters are put back afterwards).
    Raises if the capture fails or the step syncs with the host."""
    g = StepGraph(key, names, counted)
    g.batch = {k: (v.clone() if torch.is_tensor(v) else v)
               for k, v in batch.items()}
    g.u = None if u is None else u.clone()
    g.knobs = torch.zeros(4, dtype=torch.float32,
                          device=batch["raydir"].device)
    knobs = tuple(g.knobs[i] for i in range(4))
    before = [(k, k.launches) for k in kernels.KERNELS]
    counts = (state.step, state.opt_net.count, state.opt_pts.count)
    try:
        with torch.cuda.graph(g.graph, stream=stream):
            with _syncs_raise(), profiling.tally() as t:
                items, g_net, g_pts = trainer.compute_grads(
                    state, grid, g.batch, opt, spec, g.u)
                trainer.apply_grads(state, g_net, g_pts, opt, knobs)
                g.items = trainer.step_row(items, names, t, counted)
        g.host = t.host
    finally:
        state.step, state.opt_net.count, state.opt_pts.count = counts
        g.launches = [(k, k.launches - n) for k, n in before
                      if k.launches > n]
        for k, n in before:
            k.launches = n
    return g


def graphed_steps(state, grid, batches: Dict, opt, spec,
                  u: Optional[torch.Tensor] = None, launched=lambda: None):
    """`trainer.train_steps_scan` on the card: S steps in place through
    the state's live graph, or, under a new key, a first step run eagerly
    on the capture stream and the rest through a graph captured from the
    state it leaves; the items read back in one copy. `launched` is called
    once the first step is launched (the first replay), or as the eager
    first step starts. Returns (state, items by name as float32 CPU
    tensors [S])."""
    S = next(v for v in batches.values() if torch.is_tensor(v)).shape[0]
    steps = [trainer.stacked_step(batches, s) for s in range(S)]
    dev = steps[0]["raydir"].device

    def on_card(rows):
        return torch.tensor(np.stack(rows), dtype=torch.float32
                            ).pin_memory().to(dev, non_blocking=True)
    with profiling.span("train.inputs"):
        knobs = on_card([trainer.step_knobs(state, opt, s)
                         for s in range(S)])
        depths = on_card([renderer.ray_depths(opt, st["near"], st["far"])
                          for st in steps])
    steps = [dict({k: v for k, v in st.items() if k not in ("near", "far")},
                  depths=depths[s]) for s, st in enumerate(steps)]
    if state.dispatch is None:
        state.dispatch = Dispatch(dev)
    disp = state.dispatch

    def draws(s):
        return trainer.jitter_draws(state, steps[s], opt) if u is None \
            else u[s]

    s0, u0 = 0, draws(0)
    host: Dict[str, int] = {}
    with profiling.span("train.key"):
        live = disp.graph is not None and disp.graph.key == step_key(
            state, grid, steps[0], u0, opt, spec)
    if live:
        names, counted = disp.graph.names, disp.graph.counted
        out = torch.empty((S, len(names) + len(counted)),
                          dtype=torch.float64, device=dev)
    else:
        disp.drop()
        disp.stream.wait_stream(torch.cuda.current_stream(dev))
        launched()
        with torch.cuda.stream(disp.stream):
            with profiling.tally() as t:
                _, first = trainer.train_step(state, grid, steps[0], opt,
                                              spec, u0)
            names, counted, host = sorted(first), t.names(), dict(t.host)
            out = torch.empty((S, len(names) + len(counted)),
                              dtype=torch.float64, device=dev)
            out[0] = trainer.step_row(first, names, t, counted)
        torch.cuda.current_stream(dev).wait_stream(disp.stream)
        s0 = 1
    for s in range(s0, S):
        us = u0 if s == 0 else draws(s)
        if disp.graph is None:
            with profiling.span("train.capture"):
                disp.graph = capture(
                    state, grid, steps[s], us, opt, spec,
                    step_key(state, grid, steps[s], us, opt, spec), names,
                    counted, disp.stream)
            disp.captures += 1
            profiling.count("train.captures", 1)
        disp.replay(state, steps[s], us, knobs[s])
        launched()
        out[s] = disp.graph.items
        for k, n in disp.graph.host.items():
            host[k] = host.get(k, 0) + n
    return state, trainer.read_rows(out, names, counted, host)
