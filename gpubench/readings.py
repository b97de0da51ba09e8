"""The readings a cell's limits are set from, in one process on the card:

    python -m gpubench.readings --workload lego.train --seeds 12 \\
        --control 3 --faults 3 --first-seed 1000003

For each of --seeds seeds a short run of the program (its window as long
as --seconds) and its check numbers; for --control seeds the control
(the reference in TF32 in the program's place); for --faults seeds each
fault of the cell's mix planted in the timed path. Prints one JSON line
per reading and a summary: the largest program reading and the smallest
control and fault readings of each number.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2 ** 31 + 1)
    ap.add_argument("--seconds", type=float, default=0.5)
    args = ap.parse_args(argv)
    spec = run.load_cell(args.workload)
    faults = run.load_mix(spec["mixes"], spec["traffic"]["kind"]).FAULTS
    plan = [("program", None, False, args.first_seed + 7919 * i)
            for i in range(args.seeds)]
    plan += [("control", None, True, args.first_seed + 104729 * (i + 1))
             for i in range(args.control)]
    plan += [(f"fault:{f}", f, False, args.first_seed + 1299709 * (i + 1))
             for f in faults for i in range(args.faults)]
    summary = {}
    for what, fault, control, seed in plan:
        out = run.run_cell(spec, seed, args.seconds, False, "cuda:0",
                           fault=fault, control=control)
        nums = {k: c["value"] for k, c in out["checks"].items()}
        print(json.dumps({"reading": what, "seed": seed,
                          "correct": out["correct"], "numbers": nums}),
              flush=True)
        for k, v in nums.items():
            key = (what, k)
            pick = max if what == "program" else min
            summary[key] = v if key not in summary else pick(summary[key], v)
    for (what, k), v in sorted(summary.items()):
        print(f"{args.workload} {what} {k} "
              f"{'largest' if what == 'program' else 'smallest'} {v!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
