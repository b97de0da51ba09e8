"""One run of one cell of the benchmark of `pointnerf_tpu_torch` on NVIDIA
cards, from the root of a checkout:

    python -m gpubench.run --workload lego.train --seed 12345 \\
        --seconds 30 --trace 0

A cell (BENCHMARK.json's `workloads`) names a configuration (its file
under gpubench/configs/) and a traffic mix (gpubench/traffic/<mix>.json),
whose `kind` names the module that drives it: gpubench/mixes/<kind>.py
(what the loop here reads from it: gpubench/mix.py). Its limits are
gpubench/limits/<cell>.json and each per-layer metric is read by
gpubench/metrics/<metric>.py. All of them are found by name.

A run makes its inputs and weights from --seed on the card, builds the
program around them, warms up, measures for --seconds (with --trace 1
profiling a steady slice of that window and reporting the per-layer
metrics in place of the end-to-end ones), then holds what the program
produced against the plain reference (gpubench/reference/) and prints
one JSON line. It exits non-zero, printing no result, without a card, or
if JAX or the JAX package was loaded. --fault and --control exist to
show that the comparison fails where it must (PERF.md); the benchmark's
own runs never pass them.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pointnerf_tpu")


def process_start() -> float:
    """This process's start, seconds since the epoch (from /proc)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        btime = next(int(line.split()[1]) for line in f
                     if line.startswith("btime"))
    return btime + ticks / os.sysconf("SC_CLK_TCK")


def load_cell(workload: str, root: Path = ROOT) -> Dict:
    """The cell's entry, configuration, traffic, limits and metrics."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    bench_dir = root / "gpubench"
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return {"cell": cell, "cfg": json.loads((root / conf["file"]).read_text()),
            "traffic": json.loads((bench_dir / "traffic"
                                   / f"{cell['traffic']}.json").read_text()),
            "limits": json.loads((bench_dir / "limits"
                                  / f"{workload}.json").read_text()),
            "end_to_end": e2e, "per_layer": layer,
            "readers": bench_dir / "metrics", "mixes": bench_dir / "mixes"}


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_metric(readers: Path, name: str, ctx: Dict) -> Optional[float]:
    return _load(readers / f"{name}.py",
                 "gpubench_metric_" + name.replace(".", "_")).read(ctx)


def load_mix(mixes: Path, kind: str):
    """The module of a traffic kind, gpubench/mixes/<kind>.py."""
    return _load(mixes / f"{kind}.py",
                 "gpubench_mix_" + kind.replace(".", "_"))


class Card:
    """The device a run measures on, and what only a card can say."""

    def __init__(self, device):
        import torch
        self.torch = torch
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize(self.device)

    def peak(self) -> int:
        return self.torch.cuda.max_memory_allocated(self.device) \
            if self.cuda else 0

    def reset_peak(self):
        if self.cuda:
            self.torch.cuda.reset_peak_memory_stats(self.device)

    def describe(self) -> Dict:
        if not self.cuda:
            return {"platform": "cpu", "kind": "cpu", "count": 1}
        out = {"platform": "gpu",
               "kind": self.torch.cuda.get_device_name(self.device),
               "count": 1}
        try:
            q = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                                "--format=csv,noheader,nounits", "-i",
                                str(self.device.index or 0)],
                               capture_output=True, text=True, timeout=30)
            out["power_limit_w"] = float(q.stdout.strip().splitlines()[0])
        except (OSError, ValueError, IndexError,
                subprocess.SubprocessError):
            out["power_limit_w"] = None
        return out


def run_cell(spec: Dict, seed: int, seconds: float, trace: bool, device,
             fault: Optional[str] = None, control: bool = False,
             t_start: Optional[float] = None) -> Dict:
    """One run of a cell on `device`; returns the result line's object."""
    import torch
    from .mix import span
    from .trace import Slice
    t_start = time.time() if t_start is None else t_start
    card = Card(device)
    kind = spec["traffic"]["kind"]
    mod = load_mix(spec["mixes"], kind)
    if fault is not None and fault not in mod.FAULTS:
        raise ValueError(f"no fault {fault!r} in a {kind} mix")
    torch.set_num_threads(4)
    if control:
        return _result(spec, mod.control(spec, seed, card), 0, 0, {}, card,
                       0, None)

    mix = mod.MIX(spec, seed, card, fault)
    card.sync()
    setup_s = time.time() - t_start
    process_peak = card.peak()
    card.reset_peak()
    window: List[int] = []      # the window's units, by input index
    traced: List[int] = []      # the traced slice's, among them
    traced_s = 0.0              # the slice's time, profiler and reduction
    attempted = failed = 0
    sl = Slice(card.sync) if trace else None
    trace_at = float(spec["traffic"]["trace_after"]) * seconds
    t0 = time.perf_counter()
    with span("window"):
        while True:
            if sl is not None and not traced \
                    and time.perf_counter() - t0 >= trace_at:
                t1 = time.perf_counter()
                with sl.run(card.cuda):
                    for _ in range(int(spec["traffic"]["trace_units"])):
                        i, n, bad = mix.unit()
                        traced.append(i)
                        window.append(i)
                        attempted, failed = attempted + n, failed + bad
                traced_s = time.perf_counter() - t1
            else:
                i, n, bad = mix.unit()
                window.append(i)
                attempted, failed = attempted + n, failed + bad
            if time.perf_counter() - t0 >= seconds and (sl is None
                                                          or traced):
                break
    card.sync()
    window_s = time.perf_counter() - t0
    window_peak = card.peak()
    mix.free()
    t = sorted(mix.seconds)
    print(f"gpubench: {len(t)} {mod.UNIT}, median {t[len(t) // 2]!r} s, "
          f"max {t[-1]!r} s", file=sys.stderr)
    print(f"gpubench: {mix.notes()}", file=sys.stderr)
    t_check = time.perf_counter()
    numbers = mod.check(mix, window, seed)
    print(f"gpubench: the reference took "
          f"{time.perf_counter() - t_check!r} s", file=sys.stderr)

    e2e = {"setup_s": (setup_s, "s")}
    for m in spec["end_to_end"]:
        if m["name"] != "setup_s":      # rays of the steps or images done
            e2e[m["name"]] = (mix.rays * attempted / window_s, m["unit"])
    metrics = {k: {"value": v, "unit": u} for k, (v, u) in e2e.items()}
    device_extra = {}
    breakdown = None
    if trace:
        ctx = _context(spec, mod, mix, sl, window, traced,
                       window_s - traced_s, window_peak)
        metrics = {}
        for m in spec["per_layer"]:
            v = read_metric(spec["readers"], m["name"], ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_extra = {"busy_s": sl.busy_s, "window_s": sl.wall_s}
        breakdown = sl.breakdown()
    return _result(spec, numbers, attempted, failed, metrics, card,
                   max(process_peak, window_peak), breakdown, device_extra)


def _context(spec, mod, mix, sl, window, traced, window_s, window_peak):
    """What the per-layer readers read. The window's units and time are
    those outside the traced slice, which the profiler slows: `window_s`
    comes without the slice."""
    from collections import Counter
    rows = mix.rows(window)
    window = list((Counter(window) - Counter(traced)).elements())
    per = mod.per_entry(mix)

    def sum_rows(units, which="shaded"):
        return tuple(sum(rows[i][which][j] for i in units) for j in (0, 1))
    print(f"gpubench: (neighbor, shading) rows of the window outside the "
          f"slice: needed {sum_rows(window, 'needed')}, shaded "
          f"{sum_rows(window)}", file=sys.stderr)
    return {"kind": spec["traffic"]["kind"], "window_s": window_s,
            "window_units": per * len(window),
            "window_rows": sum_rows(window),
            "slice_units": per * len(traced), "slice_rows": sum_rows(traced),
            "slice": {"wall_s": sl.wall_s, "busy_s": sl.busy_s,
                      "families": sl.families},
            **mod.model(spec["cfg"]),
            "ladder_rows": getattr(mix, "ladder", None),
            "window_peak_bytes": window_peak}


def _result(spec, numbers, attempted, failed, metrics, card, peak,
            breakdown, device_extra=None) -> Dict:
    from . import check
    limits = spec["limits"]
    out = {"correct": check.judge(numbers, limits) and failed == 0,
           "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": dict(card.describe(), memory_peak_bytes=peak,
                          **(device_extra or {}))}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                     for k in limits}
    return out


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    build = ROOT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ["USE_FLAX"] = "0"
    spec = load_cell(args.workload)
    import torch
    need = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"gpubench: {args.workload} needs {need} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda:0",
                   args.fault, args.control, t_start)
    bad = forbidden_modules()
    if bad:
        print(f"gpubench: the run loaded {bad}", file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
