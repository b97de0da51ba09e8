"""The sharded train step at bench shapes (port of
scripts/multichip_bench.py).

Runs the point-sharded and ray-sharded train step (superset query,
SR_budget compaction, the lego aggregator) at bench.py's workload: R =
3,600 rays, the 100k-point cloud, max_o 280,000, superset_P 64, over
`--ranks` ranks with `--mesh_points` point shards (parallel.driver.launch:
gloo processes on the CPU, NCCL on the cards, or gloo ranks sharing one
card with --shared). Records, as the JAX script records on its virtual
CPU mesh:

* the sharded step's loss against the single-device step's, from the same
  state and jitter draws (the single-device step runs first, in this
  process);
* each rank's at-rest bytes of the point-axis shards (the capacity
  buffers with their Adam moments, the bucket tables) against the whole;
* the host seconds of a step (relative on the CPU, not a device number).

Run: python -m pointnerf_tpu_torch.scripts.multichip_bench [--ranks 4]
         [--mesh_points 2] [--rays 3600] [--points 100000]
         [--superset_P 64] [--device cpu] [--shared] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import tempfile
import time

import numpy as np
import torch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--mesh_points", type=int, default=2)
    ap.add_argument("--rays", type=int, default=3600)
    ap.add_argument("--points", type=int, default=100000)
    ap.add_argument("--superset_P", type=int, default=64)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--shared", action="store_true",
                    help="every rank on card 0, over gloo")
    ap.add_argument("--out", default="",
                    help="also write the JSON record to this file")
    args = ap.parse_args(argv)

    from ..models import neural_points as npc
    from ..parallel import checks
    from ..parallel.driver import launch
    from ..parallel.points import BUCKET_KEYS, capacity, is_capacity_key
    from ..run.common import make_spec_and_grid
    from ..run.workload import lego_options, make_cloud, make_train_batch
    from ..train import trainer
    from ..utils.checkpoint import train_state_arrays

    dev = torch.device(args.device)
    opt = lego_options().replace(random_sample_size=math.isqrt(args.rays),
                                 superset_P=args.superset_P)
    state = npc.create_point_cloud(*make_cloud(opt, args.points), device=dev)
    spec, grid = make_spec_and_grid(opt, state)
    ts = trainer.create_train_state(opt, state,
                                    torch.Generator().manual_seed(0))
    # copies: on the CPU the arrays would alias the buffers the step updates
    flat = {k: np.array(v) for k, v in train_state_arrays(ts).items()}
    batch = make_train_batch(opt, dev)
    R = batch["raydir"].shape[1]
    u = torch.rand((1, R, opt.z_depth_dim),
                   generator=torch.Generator().manual_seed(1)).to(dev)
    nr = args.ranks // args.mesh_points
    ref_opt = opt.replace(comp_groups=nr) if nr > 1 else opt
    t0 = time.perf_counter()
    _, ref = trainer.train_step(ts, grid, batch, ref_opt, spec, u=u)
    ref_s = time.perf_counter() - t0
    cap = capacity(flat)
    whole = {"capacity_bytes": int(sum(
        v.nbytes for k, v in flat.items() if is_capacity_key(k, v, cap))),
        "bucket_bytes": int(sum(grid[k].numel() * grid[k].element_size()
                                for k in BUCKET_KEYS if k in grid))}
    del ts, grid

    job = dict(kind="step", opt=opt.to_json(), points=args.mesh_points,
               state=flat, grid=None, spec=spec, all_ranks=True,
               batch={k: (v.cpu().numpy() if torch.is_tensor(v) else v)
                      for k, v in batch.items()},
               draws=[u.cpu().numpy()])
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as run_dir:
        ranks = launch(checks.run_jobs, ([job],), args.ranks, 1, dev,
                       run_dir, backend="gloo" if args.shared else None,
                       shared=args.shared)[0]
    wall = time.perf_counter() - t0
    ref_loss = float(ref["loss_total"])
    losses = [r["items"]["loss_total"] for r in ranks]
    rel = max(abs(v - ref_loss) / abs(ref_loss) for v in losses)
    out = {
        "mesh": {"batch": 1, "rays": nr, "points": args.mesh_points},
        "ranks": args.ranks, "rays": R, "points": args.points,
        "superset_P": args.superset_P, "max_o": spec.max_o,
        "capacity": cap,
        "backend": (f"{args.device}, "
                    + ("gloo, ranks sharing card 0" if args.shared else
                       "gloo processes" if dev.type == "cpu" else "nccl")),
        "device": (torch.cuda.get_device_name(0) if dev.type == "cuda"
                   else "cpu (host seconds are relative, not a device "
                        "number)"),
        "single_device_step_s": ref_s,
        "rank_step_s": [r["step_s"][0] for r in ranks],
        "launch_wall_s": wall,
        "loss_single_device": ref_loss,
        "loss_mesh": losses,
        "loss_rel_diff": rel,
        "loss_match": bool(rel <= 2e-5),
        "sr_overflow": [r["items"]["sr_overflow"] for r in ranks],
        "at_rest_bytes_whole": whole,
        "at_rest_bytes_per_rank": [r["bytes"] for r in ranks],
        "shard_shapes_rank0": {k: list(v) for k, v in
                               ranks[0]["shapes"].items()
                               if k.startswith(("pt/", "grid/occ",
                                                "grid/super"))},
    }
    print(json.dumps(out, indent=1))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(json.dumps(out) + "\n")
    return out


if __name__ == "__main__":
    main()
