"""Times the port's kernels of one tree on the card, for a before-and-after
comparison on one GPU.

    python3 small_kernels_ab.py [--root DIR] [--label NAME]
                                [--set small|trunk|all|paths] [--reps N]

Imports `pointnerf_tpu_torch` from DIR (default: this checkout; a
`git archive` of another commit unpacked there gives that commit's kernels,
built into DIR/build/kernels) and runs this checkout's chip_smoke.py checks
on it: K3 on the serving group that holds the image's center, K6 at
scatter_pallas.py's shape and at the wide tier of one train step from the
initial state, K7 at occ_micro3's shape (the `small` set), each timed with
its plain version and library call from CUDA graphs of captured calls
(chip_smoke.graph_time), K3 in mask mode, in select mode (where the tree
has it: the serving group and a jittered train batch) and the query's
route before the select moved into K3, with the SASS subroutine calls of
the tree's K3 library; and the trunk kernels (the `trunk` set) at
chip_smoke's tier shapes, orders 1 and 2: K1, K4 and K1b at one serving
group's, K2, K5 and K2b at one train step's, timed with their plain
versions over eager loops (chip_smoke.timed_pair), K1b and K2b in turns
with K1 and K2 from CUDA events over many launches (chip_smoke.turns),
with their bounds. Each check holds the
kernel against its plain version. The `paths` set times the main paths
end to end instead, as chip_smoke times them: serving ms per 800x800 image
and train ms per step, in the default and the fused_shade configuration,
N times each (--reps). TF32 is off in cuBLAS and cuDNN, as in chip_smoke.
Prints one JSON line per kernel and shape (or path and configuration),
tagged with NAME, and last the card's name and power limit. To compare two
trees, run them in turns on one card: parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def load_chip_smoke():
    """This checkout's chip_smoke.py as a module (not the one under
    --root, which may predate its timing helper)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_ab", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def trunk_rows(cs, opt, agg, dev):
    """K1, K4 and K1b at one serving group's tier shapes, K2, K5 and K2b at
    one train step's (chip_smoke's checks, each row a tier, an order and,
    for K1 and K2, a distance mode; agg and the mode-0 and mode-30
    aggregators seeded as chip_smoke seeds them)."""
    import torch
    from pointnerf_tpu_torch.models.aggregator import init_aggregator_params
    group = cs.GROUP * opt.random_sample_size ** 2 * opt.SR
    step = opt.random_sample_size ** 2 * opt.SR
    agg0 = init_aggregator_params(opt.replace(agg_dist_pers=0),
                                  torch.Generator().manual_seed(5), device=dev)
    agg30 = init_aggregator_params(opt.replace(agg_dist_pers=30),
                                   torch.Generator().manual_seed(6),
                                   device=dev)
    out = []
    with torch.inference_mode():
        out += [("K1 trunk_fwd", r) for r in cs.check_trunk(
            agg, agg30, opt, *cs.tier_shapes(opt, group))]
        out += [("K4 shade_fwd", r) for r in cs.check_shade(
            {20: agg, 0: agg0}, opt, *cs.tier_shapes(opt, group))]
        out += [("K1b trunk_fwd_bf16", r) for r in cs.check_trunk_bf16(
            agg, opt, *cs.tier_shapes(opt, group))]
    out += [("K2 trunk_bwd", r) for r in cs.check_trunk_bwd(
        agg, agg30, opt, *cs.tier_shapes(opt, step))]
    out += [("K5 shade_bwd", r) for r in cs.check_shade_bwd(
        agg, opt, *cs.tier_shapes(opt, step))]
    out += [("K2b trunk_bwd_bf16", r) for r in cs.check_trunk_bwd_bf16(
        agg, opt, *cs.tier_shapes(opt, step))]
    torch.cuda.empty_cache()
    return [dict(kernel=name, shape=f"{r['tier']} order {r['order']} dist "
                 f"mode {r.get('mode', 20)}", **r) for name, r in out]


def small_rows(cs, opt, state, spec, grid, item, dev):
    """K3 on a serving group (both modes, the route before) and a train
    batch, K6 at scatter_pallas.py's shape and at one train step's wide
    tier, K7 at occ_micro3's."""
    import torch
    from pointnerf_tpu_torch.run.workload import make_train_batch
    from pointnerf_tpu_torch.scripts.scatter_pallas import script_inputs
    from pointnerf_tpu_torch.train import trainer
    from pointnerf_tpu_torch.ops import kernels
    from pointnerf_tpu_torch.ops import query as tq
    print(f"K3 subroutine calls (cuobjdump -sass, by callee): "
          f"{cs.sass_calls(kernels.OCCUPANCY)}", flush=True)
    rays = cs.GROUP * opt.random_sample_size ** 2
    with torch.inference_mode():
        if hasattr(tq, "occupancy_select"):
            k3 = cs.check_occupancy(item, grid, spec, opt, rays)["rows"]
        else:   # a tree from before K3 selected: mask mode and the route
            k3 = cs.check_occupancy_mask(*cs.serving_group(item, opt, rays),
                                         grid, spec, opt.SR)
    rows = [("K3 occupancy", shape, r) for shape, r in k3]
    idx, upd = script_inputs(**cs.SCATTER_SCRIPT)
    rows.append(("K6 scatter_rows", "scatter_pallas.py", cs.check_scatter(
        "scatter_pallas.py shapes (dup 6)", torch.as_tensor(idx, device=dev),
        torch.as_tensor(upd, device=dev), cs.SCATTER_SCRIPT["cap"])))
    del idx, upd
    st = trainer.create_train_state(opt, state,
                                    torch.Generator().manual_seed(0))
    batch = make_train_batch(opt, dev)
    with cs.ScatterRecorder() as rec:
        trainer.compute_grads(st, grid, batch, opt, spec,
                              trainer.jitter_draws(st, batch, opt))
    rows.append(("K6 scatter_rows", "train step wide tier", cs.check_scatter(
        "one train step's wide tier",
        *max(rec.calls, key=lambda c: c[0].shape[0]))))
    del st, rec, batch
    torch.cuda.empty_cache()
    rows.append(("K7 row_select", "occ_micro3 int8 Rt 16",
                 cs.check_row_select(dev)))
    return [dict(kernel=name, shape=shape, **r) for name, shape, r in rows]


def path_rows(cs, opt, state, spec, grid, ts, item, reps: int):
    """Serving ms per image and train ms per step, in the default and the
    fused_shade configuration, timed as chip_smoke's serve_path and
    train_path time them: host clock ending in torch.cuda.synchronize(),
    one 800x800 render_image after a warm-up one, TRAIN_STEPS train_steps
    on bench.py's batch after a warm-up step; `reps` times each."""
    import torch
    from pointnerf_tpu_torch.run import common
    from pointnerf_tpu_torch.run.workload import make_train_batch
    from pointnerf_tpu_torch.train import trainer

    def timed(fn, n=1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n

    rows = []
    for fused in (0, 1):
        o = opt.replace(fused_shade=fused)
        config = "fused_shade" if fused else "default"
        render = lambda: common.render_image(ts, grid, o, spec, item,
                                             group=cs.GROUP)
        render()
        ms = [timed(render) for _ in range(reps)]
        rows.append(dict(path="serving ms/image", config=config, ms=ms,
                         median_ms=statistics.median(ms)))
        st = trainer.create_train_state(o, state,
                                        torch.Generator().manual_seed(0))
        batch = make_train_batch(o, torch.device("cuda"))
        step = lambda: trainer.train_step(st, grid, batch, o, spec)
        step()
        ms = [timed(step, cs.TRAIN_STEPS) for _ in range(reps)]
        rows.append(dict(path="train ms/step", config=config, ms=ms,
                         median_ms=statistics.median(ms)))
        del st, batch
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--set", default="all",
                    choices=("small", "trunk", "all", "paths"))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("small_kernels_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    cs = load_chip_smoke()
    import pointnerf_tpu_torch
    if os.path.dirname(os.path.dirname(
            os.path.abspath(pointnerf_tpu_torch.__file__))) != root:
        raise RuntimeError(f"pointnerf_tpu_torch came from "
                           f"{pointnerf_tpu_torch.__file__}, not {root}")
    from pointnerf_tpu_torch.ops import kernels
    kernels.library()
    dev = torch.device("cuda")
    opt, state, spec, grid, agg, ts, item, _ = cs.build_workload(dev)
    rows = []
    if args.set in ("trunk", "all"):
        rows += trunk_rows(cs, opt, agg, dev)
    if args.set in ("small", "all"):
        rows += small_rows(cs, opt, state, spec, grid, item, dev)
    if args.set == "paths":
        rows += path_rows(cs, opt, state, spec, grid, ts, item, args.reps)
    for r in rows:
        print(json.dumps({"tree": args.label,
                          **{k: v for k, v in r.items() if k != "err"}}),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
