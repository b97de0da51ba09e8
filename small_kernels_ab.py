"""Times the port's sub-millisecond kernels (K3, K6, K7) of one tree on the
card, for a before-and-after comparison on one GPU.

    python3 small_kernels_ab.py [--root DIR] [--label NAME]

Imports `pointnerf_tpu_torch` from DIR (default: this checkout; a
`git archive` of another commit unpacked there gives that commit's kernels,
built into DIR/build/kernels) and runs this checkout's chip_smoke.py checks
on it: K3 on the serving group that holds the image's center, K6 at
scatter_pallas.py's shape and at the wide tier of one train step from the
initial state, K7 at occ_micro3's shape. Each check holds the kernel
against its plain version and times the kernel, the plain version and the
library call from CUDA graphs of captured calls (chip_smoke.graph_time).
Prints one JSON line per kernel and shape, tagged with NAME, and last the
card's name and power limit. To compare two trees, run them in turns in one
session on one card: parent, change, change, parent.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("small_kernels_ab: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    cs = load_chip_smoke()
    import pointnerf_tpu_torch
    if os.path.dirname(os.path.dirname(
            os.path.abspath(pointnerf_tpu_torch.__file__))) != root:
        raise RuntimeError(f"pointnerf_tpu_torch came from "
                           f"{pointnerf_tpu_torch.__file__}, not {root}")
    from pointnerf_tpu_torch.ops import kernels
    from pointnerf_tpu_torch.run.workload import make_train_batch
    from pointnerf_tpu_torch.scripts.scatter_pallas import script_inputs
    from pointnerf_tpu_torch.train import trainer
    kernels.library()
    dev = torch.device("cuda")
    opt, state, spec, grid, agg, _, item, _ = cs.build_workload(dev)
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
