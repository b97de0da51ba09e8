"""Times the port's kernels of one tree on the card, for a before-and-after
comparison on one GPU.

    python3 small_kernels_ab.py [--root DIR] [--label NAME]
                                [--set small|trunk|all]

Imports `pointnerf_tpu_torch` from DIR (default: this checkout; a
`git archive` of another commit unpacked there gives that commit's kernels,
built into DIR/build/kernels) and runs this checkout's chip_smoke.py checks
on it: K3 on the serving group that holds the image's center, K6 at
scatter_pallas.py's shape and at the wide tier of one train step from the
initial state, K7 at occ_micro3's shape (the `small` set), each timed with
its plain version and library call from CUDA graphs of captured calls
(chip_smoke.graph_time); and the trunk kernels (the `trunk` set) at
chip_smoke's tier shapes, orders 1 and 2: K1 and K4 at one serving group's,
K2 and K5 at one train step's, timed with their plain versions over eager
loops (chip_smoke.timed_pair), with both bounds. Each check holds the
kernel against its plain version. TF32 is off in cuBLAS and cuDNN, as in
chip_smoke. Prints one JSON line per kernel and shape, tagged with NAME,
and last the card's name and power limit. To compare two trees, run them
in turns on one card: parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

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
    """K1, K4 at one serving group's tier shapes, K2, K5 at one train
    step's (chip_smoke's checks, each row a tier and an order)."""
    import torch
    from pointnerf_tpu_torch.models.aggregator import init_aggregator_params
    group = cs.GROUP * opt.random_sample_size ** 2 * opt.SR
    step = opt.random_sample_size ** 2 * opt.SR
    agg0 = init_aggregator_params(opt.replace(agg_dist_pers=0),
                                  torch.Generator().manual_seed(5), device=dev)
    out = []
    with torch.inference_mode():
        out += [("K1 trunk_fwd", r) for r in cs.check_trunk(
            agg, opt, *cs.tier_shapes(opt, group))]
        out += [("K4 shade_fwd", r) for r in cs.check_shade(
            {20: agg, 0: agg0}, opt, *cs.tier_shapes(opt, group))]
    out += [("K2 trunk_bwd", r) for r in cs.check_trunk_bwd(
        agg, opt, *cs.tier_shapes(opt, step))]
    out += [("K5 shade_bwd", r) for r in cs.check_shade_bwd(
        agg, opt, *cs.tier_shapes(opt, step))]
    torch.cuda.empty_cache()
    return [(name, f"{r['tier']} order {r['order']} dist mode "
             f"{r.get('mode', 20)}", r) for name, r in out]


def small_rows(cs, opt, state, spec, grid, item, dev):
    """K3 on a serving group, K6 at scatter_pallas.py's shape and at one
    train step's wide tier, K7 at occ_micro3's."""
    import torch
    from pointnerf_tpu_torch.run.workload import make_train_batch
    from pointnerf_tpu_torch.scripts.scatter_pallas import script_inputs
    from pointnerf_tpu_torch.train import trainer
    rows = []
    with torch.inference_mode():
        rows.append(("K3 occupancy", "serving group", cs.check_occupancy(
            item, grid, spec, opt, cs.GROUP * opt.random_sample_size ** 2)))
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
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--set", default="all", choices=("small", "trunk", "all"))
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
    opt, state, spec, grid, agg, _, item, _ = cs.build_workload(dev)
    rows = []
    if args.set in ("trunk", "all"):
        rows += trunk_rows(cs, opt, agg, dev)
    if args.set in ("small", "all"):
        rows += small_rows(cs, opt, state, spec, grid, item, dev)
    for name, shape, r in rows:
        print(json.dumps({"tree": args.label, "kernel": name, "shape": shape,
                          **{k: v for k, v in r.items() if k != "err"}}),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
