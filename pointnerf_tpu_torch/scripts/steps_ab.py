"""Eager train steps against the graphed dispatch on the card, in turns.

The dispatch (`trainer.train_steps_scan`) replays one train step captured
in a CUDA graph (`train.graph`); the eager loop launches the same kernels
from Python step by step. For each configuration, from twin train states
(one seed) with the same draws:

* S eager `train_step`s against one S-step dispatch: every step's loss
  items within ITEM_RTOL, each weight and point buffer within STATE_REL
  in norm after them (K6's float atomics, carried by Adam), and the same
  launches of each port kernel;
* each route's peak device memory in that first run (the graphed one
  captures the step: its graph's pool holds one step's activations);
* then eager, graphed, graphed, eager, --reps times: ms per step (host
  clock, synced), and the device's busy share of a further S steps of
  each under torch.profiler (`utils.profiling.device_busy`).

Configurations: `lego` (bench.py's 100,000-point cloud and 3,600-ray batch
at the lego preset's widths), `fused_shade`, `trunk_bf16`, `remat`,
`ray_chunk` (900), each shading envelope of `run.workload.ENVELOPES`, and
`voxgrid` (NN -1 on a 101 x 101 x 4 lattice slab). With --finetune also
the finetune of chip_smoke.py's finetune phase (`train_ft.main` on a
400x400 plate scene at the lego widths: 150 steps, a prune, a
probe-and-grow) at steps_per_dispatch 1 and 8 in turns: ms per step and
wall seconds.

Run:  python -m pointnerf_tpu_torch.scripts.steps_ab [--steps 8] [--reps 2]
          [--only lego,trunk_bf16] [--finetune]
Prints one JSON line per configuration and last the card's name and power
limit (nvidia-smi).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from ..models import neural_points as npc
from ..ops import kernels
from ..run import common
from ..run.workload import (ENVELOPES, envelope_options, lego_options,
                            make_cloud, make_train_batch)
from ..train import graph, trainer
from ..utils.profiling import device_busy

ITEM_RTOL = 1e-5     # loss items: the same kernels on the same inputs
STATE_REL = 1e-3     # ||graphed - eager|| / ||eager|| per weight and buffer


def lattice_slab(opt, dev):
    """The vox-grid configuration: a 101 x 101 x 4 lattice (pitch 0.008)
    with random attributes, its spec and grid, under NN -1."""
    g = np.arange(-0.4, 0.4001, 0.008, dtype=np.float32)
    z = np.array([-0.016, -0.008, 0.0, 0.008], np.float32)
    xyz = np.stack(np.meshgrid(g, g, z, indexing="ij"), -1).reshape(-1, 3)
    vopt = opt.replace(NN=-1, agg_distance_kernel="trilinear",
                       agg_weight_norm=0, xyz_grad=0, k_tier=0)
    rng = np.random.RandomState(0)
    n = len(xyz)
    state = npc.create_point_cloud(
        xyz, rng.uniform(-0.5, 0.5, (n, opt.point_features_dim)
                         ).astype(np.float32),
        rng.uniform(0, 1, (n, 3)).astype(np.float32),
        np.tile(np.float32([[0, 0, 1]]), (n, 1)),
        np.full((n, 1), 0.8, np.float32), device=dev)
    return (vopt, state) + common.make_spec_and_grid(vopt, state)


def configurations(dev):
    """label -> (opt, point state, spec, grid) of every configuration."""
    opt = lego_options()
    state = npc.create_point_cloud(*make_cloud(opt), device=dev)
    spec, grid = common.make_spec_and_grid(opt, state)
    out = {"lego": opt, "fused_shade": opt.replace(fused_shade=1),
           "remat": opt.replace(remat=1),
           "ray_chunk": opt.replace(ray_chunk=900)}
    out.update({name: envelope_options(name, opt) for name in ENVELOPES})
    out = {k: (o, state, spec, grid) for k, o in out.items()}
    out["voxgrid"] = lattice_slab(opt, dev)
    return out


def _launches():
    return {k.name: k.launches for k in kernels.KERNELS}


def _delta(before):
    return {k: v - before[k] for k, v in _launches().items()
            if v - before[k]}


def compare(opt, state, spec, grid, steps: int, reps: int, dev) -> dict:
    """S eager steps against one graphed S-step dispatch from twin states
    (see the module docstring); raises where they differ."""
    batch = make_train_batch(opt, dev)
    stacked = {k: (torch.stack([v] * steps) if torch.is_tensor(v) else v)
               for k, v in batch.items()}
    holder = SimpleNamespace(
        generator=torch.Generator(device=dev).manual_seed(1))
    draws = torch.stack([trainer.jitter_draws(holder, batch, opt)
                         for _ in range(steps)])
    seed = lambda: trainer.create_train_state(
        opt, state, torch.Generator().manual_seed(0))
    eager_st, graph_st = seed(), seed()

    def eager():
        out = [trainer.train_step(eager_st, grid, batch, opt, spec, u)[1]
               for u in draws]
        return {k: torch.stack([o[k].float() for o in out]).cpu()
                for k in out[0]}

    def graphed():
        return trainer.train_steps_scan(graph_st, grid, stacked, opt, spec,
                                        draws)[1]

    def first(run):
        """run()'s result, its launches and its peak GiB (the graphed
        route's first dispatch captures: its pool's peak is in it)."""
        before = _launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = run()
        torch.cuda.synchronize()
        return out, _delta(before), torch.cuda.max_memory_allocated() / 2**30

    want, eager_launches, eager_peak = first(eager)
    got, graph_launches, graph_peak = first(graphed)
    items_rel = max(float(((got[k] - v).abs() / v.abs().clamp(min=1e-30))
                          .max()) for k, v in want.items())
    pairs = list(zip(graph_st.aggregator.parameters(),
                     eager_st.aggregator.parameters()))
    pairs += [(graph_st.pt_train[k], v) for k, v in eager_st.pt_train.items()]
    state_rel = max(float((p.detach() - q.detach()).norm()
                          / q.detach().norm().clamp(min=1e-30))
                    for p, q in pairs)
    if not items_rel <= ITEM_RTOL or not state_rel <= STATE_REL:
        raise AssertionError(f"the graphed dispatch differs from the eager "
                             f"steps: items {items_rel:.3e} (bar "
                             f"{ITEM_RTOL}), state {state_rel:.3e} (bar "
                             f"{STATE_REL})")
    if graph_launches != eager_launches:
        raise AssertionError(f"launches differ: graphed {graph_launches}, "
                             f"eager {eager_launches}")
    times = {"eager": [], "graphed": []}
    for _ in range(reps):
        for route in ("eager", "graphed", "graphed", "eager"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (eager if route == "eager" else graphed)()
            torch.cuda.synchronize()
            times[route].append(1e3 * (time.perf_counter() - t0) / steps)
    busy = {route: device_busy(fn) for route, fn in
            (("eager", eager), ("graphed", graphed))}
    graph.drop(graph_st)
    return {"route": graph.graph_route(opt), "steps": steps,
            "items_rel": items_rel, "state_rel": state_rel,
            "eager_ms": times["eager"], "graphed_ms": times["graphed"],
            "eager_busy": busy["eager"][1] / busy["eager"][0],
            "graphed_busy": busy["graphed"][1] / busy["graphed"][0],
            "eager_peak_gib": eager_peak, "graphed_peak_gib": graph_peak,
            "launches": eager_launches}


def finetune_options(root, steps_per_dispatch: int, tag: str):
    """chip_smoke.py's finetune phase: the lego preset on a 400x400 plate
    scene, 150 steps, a prune at 75, a probe-and-grow at 110."""
    from ..config import nerf_synth_preset
    return nerf_synth_preset("lego").replace(
        data_root=root, scan="plate", img_wh=(400, 400), load_points=1,
        checkpoints_dir=os.path.join(root, "checkpoints"),
        experiment=f"plate_{tag}", maximum_step=150, prune_iter=75,
        prune_max_iter=75, prob_freq=110, print_freq=100,
        save_iter_freq=1500, save_point_freq=0, test_freq=0, test_num=1,
        prob_thresh=-0.7, steps_per_dispatch=steps_per_dispatch)


def finetune_ab(reps: int) -> list:
    """train_ft.main at steps_per_dispatch 1 and 8 in turns (1, 8, 8, 1
    per rep): ms per step, wall seconds, the graph's captures and
    replays."""
    from ..run import train_ft
    from ..run.workload import make_plate_scene
    rows = []
    with tempfile.TemporaryDirectory() as root:
        make_plate_scene(root, wh=(400, 400))
        for rep in range(reps):
            for i, spd in enumerate((1, 8, 8, 1)):
                opt = finetune_options(root, spd, f"{rep}_{i}")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = train_ft.main(opt)
                wall = time.perf_counter() - t0
                tm = res["timing"]
                rows.append({
                    "steps_per_dispatch": spd, "steps": tm["steps"],
                    "ms_per_step": 1e3 * tm["train_s"] / tm["steps"],
                    "wall_s": wall, "final_psnr": res["final_psnr"],
                    "captures": tm["captures"], "replays": tm["replays"]})
                print(json.dumps({"config": "finetune", **rows[-1]}),
                      flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--only", default="",
                    help="comma-separated configurations (default: all)")
    ap.add_argument("--finetune", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("steps_ab needs a CUDA device")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    configs = configurations(dev)
    only = [c for c in args.only.split(",") if c] or list(configs)
    for label in only:
        row = compare(*configs[label], args.steps, args.reps, dev)
        print(json.dumps({"config": label, **row}), flush=True)
        torch.cuda.empty_cache()
    if args.finetune:
        finetune_ab(max(1, args.reps // 2))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
