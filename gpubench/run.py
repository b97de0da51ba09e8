"""One run of one cell of the benchmark of `pointnerf_tpu_torch` on NVIDIA
cards, from the root of a checkout:

    python -m gpubench.run --workload lego.train --seed 12345 \\
        --seconds 30 --trace 0

A cell (BENCHMARK.json's `workloads`) names a configuration (its file
under gpubench/configs/) and a traffic mix (gpubench/traffic/<mix>.json,
read by the one generator here: `train` or `render` loops); its limits
are gpubench/limits/<cell>.json and each per-layer metric is read by
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

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pointnerf_tpu")
TRAIN_FAULTS = ("frozen", "half", "loss", "stale", "points")
RENDER_FAULTS = ("pixels", "half")


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
            "readers": bench_dir / "metrics"}


def read_metric(readers: Path, name: str, ctx: Dict) -> Optional[float]:
    spec = importlib.util.spec_from_file_location(
        "gpubench_metric_" + name.replace(".", "_"), readers / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


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


def _span(name: str):
    import torch
    return torch.profiler.record_function("gpubench." + name)


def _sub(d: Dict, a: int, b: int) -> Dict:
    """Steps a..b-1 of a dispatch."""
    return dict(d, batches={k: (v[a:b] if hasattr(v, "shape") else v)
                            for k, v in d["batches"].items()}, steps=(a, b))


class Train:
    """The train mix: dispatches of S graphed steps through
    `train_steps_scan`, from a seeded pool of views, cycled.

    Set-up drives the check's steps through the window's own call and
    feed (`check_steps`): the first step alone, so that its gradient can
    be read from Adam's state, then two whole dispatches, the first of
    which captures the graph (its first step eager, the rest replays) and
    the second replays it throughout, as every dispatch of the window
    does. The reference follows all of them."""

    def __init__(self, spec: Dict, seed: int, card: Card,
                 fault: Optional[str]):
        import torch
        from . import inputs, system
        self.spec, self.seed, self.card, self.fault = spec, seed, card, fault
        cfg, traffic = spec["cfg"], spec["traffic"]
        dev = card.device
        if card.cuda:
            system.build_kernels()
        self.opt = system.options(cfg)
        self.pool = inputs.train_pool(cfg, traffic, seed, dev)
        self.S = int(traffic["steps_per_dispatch"])
        self.rays = cfg["options"]["random_sample_size"] ** 2
        self.u = torch.empty((self.S, 1, self.rays,
                              cfg["options"]["z_depth_dim"]), device=dev)
        cloud = inputs.cloud(cfg, seed, dev)
        state = system.point_state(cloud)
        del cloud
        self.grid_spec, self.grid = system.grid(self.opt, state)
        agg = system.aggregator(self.opt, inputs.weights(cfg, seed, dev), dev)
        self.ts = system.train_state(self.opt, agg, state)
        calls = self.check_calls()
        items = [self.call(calls[0])]
        self.g1 = {k: v.detach().cpu().clone()
                   for k, v in system.first_gradients(self.ts).items()}
        items += [self.call(d) for d in calls[1:]]
        self.after = {k: v.detach().cpu().clone()
                      for k, v in system.leaves(self.ts).items()}
        self.losses = [float(x) for it in items for x in it["loss_total"]]
        self.overflow: List[float] = []
        self.seconds: List[float] = []
        self.next = len(calls) - 1

    def check_calls(self) -> List[Dict]:
        """The set-up's calls that the reference follows: step 0 of the
        pool's last dispatch, then its first two dispatches whole."""
        return [_sub(self.pool[-1], 0, 1), self.pool[0], self.pool[1]]

    def call(self, d: Dict) -> Dict:
        import torch
        from . import inputs, system
        from .reference.train import POINT_LEAVES
        a, b = d.get("steps", (0, self.S))
        u = inputs.draws(d, self.u)[a:b]
        if self.fault == "half":
            half = u.shape[2] // 2
            d = {"batches": {k: (v[:, :, :half] if k in ("raydir",
                                                          "gt_image") else v)
                             for k, v in d["batches"].items()}}
            u = u[:, :, :half]
        if self.fault == "stale":
            d = {"batches": {k: (v[:1].expand_as(v).contiguous()
                                 if torch.is_tensor(v) else v)
                             for k, v in d["batches"].items()}}
            u = u[:1].expand_as(u).contiguous()
        if self.fault in ("frozen", "points"):
            before = {k: v.detach().clone()
                      for k, v in system.leaves(self.ts).items()
                      if self.fault == "frozen" or k in POINT_LEAVES}
        with _span("dispatch"):
            items = system.dispatch(self.ts, self.grid, self.grid_spec,
                                    self.opt, dict(d, u=u))
        if self.fault in ("frozen", "points"):
            with torch.no_grad():
                for k, v in system.leaves(self.ts).items():
                    if k in before:
                        v.copy_(before[k])
            for optim in ((self.ts.opt_net, self.ts.opt_pts)
                          if self.fault == "frozen" else ()):
                for st in optim.state.values():
                    st["exp_avg"].zero_()
                    st["exp_avg_sq"].zero_()
        if self.fault == "loss":
            items["loss_total"] = items["loss_total"] * 1.01
        return items

    def unit(self) -> tuple:
        """One dispatch of the window: (pool index, steps, failed steps)."""
        i = self.next % len(self.pool)
        self.next += 1
        t0 = time.perf_counter()
        items = self.call(self.pool[i])
        self.seconds.append(time.perf_counter() - t0)
        self.overflow.extend(float(x) for x in items["sr_overflow"])
        return i, self.S, int(np.sum(~np.isfinite(items["loss_total"])))

    def free(self):
        import torch
        del self.ts, self.grid
        torch.cuda.empty_cache() if self.card.cuda else None

    def notes(self) -> str:
        o = self.overflow
        return (f"sr_overflow in the window: largest {max(o, default=0)!r}, "
                f"{sum(x > 0 for x in o)} of {len(o)} steps above 0")

    def check_batches(self):
        """The reference's batches and draws of the check's steps."""
        import torch
        from . import inputs
        batches, u = [], []
        buf = torch.empty_like(self.u)
        for d in self.check_calls():
            inputs.draws(d, buf)
            a, b = d.get("steps", (0, self.S))
            for s in range(a, b):
                batches.append(inputs.step_of(d, s))
                u.append(buf[s, 0].clone())
        return batches, u

    def reference(self, control: bool = False) -> Dict[str, float]:
        """The reference's steps on the same inputs, against the
        program's (or, for the control, against the reference's own in
        TF32)."""
        from . import check, inputs
        from .reference import tf32, train as rtrain
        from .reference.train import POINT_LEAVES
        cfg, dev = self.spec["cfg"], self.card.device
        cloud, spec, g = _reference_scene(self.spec, self.seed, dev)
        W = inputs.weights(cfg, self.seed, dev)
        batches, draws = self.check_batches()
        start = {**W, **{k: cloud[k] for k in POINT_LEAVES}}

        def follow():
            items, g1, after = rtrain.run_steps(W, cloud, cfg["options"], g,
                                                spec, batches, draws)
            return ([i["loss_total"] for i in items],
                    {k: v.cpu() for k, v in g1.items()},
                    {k: (after[k] - start[k]).cpu() for k in after})
        ref = follow()
        if control:
            with tf32.Emulate():
                prog = follow()
        else:
            n = cloud["xyz"].shape[0]
            cut = lambda k, v: v[:n] if k in POINT_LEAVES else v
            prog = (self.losses,
                    {k: cut(k, v) for k, v in self.g1.items()},
                    {k: cut(k, self.after[k]) - start[k].cpu()
                     for k in self.after})
        return check.train_numbers(prog[0], ref[0], prog[1], ref[1],
                                   prog[2], ref[2])

    def rows(self, units: List[int]) -> Dict[int, Dict[str, tuple]]:
        """What each pool dispatch in `units` asks of the trunk, by the
        reference's count (`model.count_rows`): needed and shaded
        (neighbor rows, shading rows)."""
        import torch
        from . import inputs
        from .reference import model
        o = self.spec["cfg"]["options"]
        _, spec, g = _reference_scene(self.spec, self.seed, self.card.device)
        buf = torch.empty_like(self.u)
        out = {}
        for i in sorted(set(units)):
            d = self.pool[i]
            inputs.draws(d, buf)
            tot = {"needed": (0, 0), "shaded": (0, 0)}
            for s in range(self.S):
                b = inputs.step_of(d, s)
                c = model.count_rows(o, g, spec, b["campos"], b["raydir"],
                                     buf[s, 0], b["near"], b["far"])
                tot = {k: (tot[k][0] + c[k][0], tot[k][1] + c[k][1])
                       for k in tot}
            out[i] = tot
        return out


class Render:
    """The render mix: whole images through `render_image`, one after
    another, from a seeded path of poses, cycled."""

    def __init__(self, spec: Dict, seed: int, card: Card,
                 fault: Optional[str]):
        from . import inputs, system
        self.spec, self.seed, self.card, self.fault = spec, seed, card, fault
        cfg, traffic = spec["cfg"], spec["traffic"]
        dev = card.device
        if card.cuda:
            system.build_kernels()
        self.opt = system.options(cfg)
        self.path = inputs.render_path(cfg, traffic, seed, dev)
        self.items = [self._item(p) for p in self.path]
        cloud = inputs.cloud(cfg, seed, dev)
        state = system.point_state(cloud)
        del cloud
        self.grid_spec, self.grid = system.grid(self.opt, state)
        agg = system.aggregator(self.opt, inputs.weights(cfg, seed, dev), dev)
        self.ss = system.serve_state(agg, state)
        self.group = int(traffic["group"])
        W, H = cfg["cameras"]["wh"]
        self.rays = W * H
        self.images: List[np.ndarray] = []
        self.ladder: List[int] = []
        self.seconds: List[float] = []
        # warm-up: the view at azimuth 0 for every seed, so that set-up
        # does the same work whatever the order (views differ in work)
        self.call(self.items[[p["view"] for p in self.path].index(0)])
        self.next = 0

    def _item(self, pose: Dict) -> Dict:
        cam, o = self.spec["cfg"]["cameras"], self.spec["cfg"]["options"]
        W, H = cam["wh"]
        py, px = np.meshgrid(np.arange(H, dtype=np.float32),
                             np.arange(W, dtype=np.float32), indexing="ij")
        return {"h": H, "w": W,
                "pixel_idx": np.stack([px, py], -1).reshape(1, -1, 2),
                "raydir": pose["raydir"].cpu().numpy()[None],
                "campos": pose["campos"].cpu().numpy()[None],
                "camrotc2w": pose["camrotc2w"].cpu().numpy()[None],
                "near": np.float32(o["near_plane"]),
                "far": np.float32(o["far_plane"]),
                "bg_color": np.ones((1, 3), np.float32)}

    def call(self, item: Dict):
        from . import system
        if self.fault == "half":
            n = item["raydir"].shape[1] // 2
            item = dict(item, raydir=item["raydir"][:, :n],
                        pixel_idx=item["pixel_idx"][:, :n])
        stats: Dict = {}
        with _span("render_image"):
            maps = system.render(self.ss, self.grid, self.grid_spec,
                                 self.opt, item, self.group, stats)
        img = maps["coarse_raycolor"]
        if self.fault == "pixels":
            img[:60, :60] += 0.05
        return img, stats

    def unit(self) -> tuple:
        """One image of the window: (pose index, images, failed)."""
        i = self.next % len(self.items)
        self.next += 1
        t0 = time.perf_counter()
        img, stats = self.call(self.items[i])
        self.seconds.append(time.perf_counter() - t0)
        self.images.append(img)
        self.ladder.append(int(stats["sr_overflow"]))
        return i, 1, int(not np.all(np.isfinite(img)))

    def notes(self) -> str:
        return f"rows up the budget ladder, by image: {self.ladder}"

    def free(self):
        import torch
        del self.ss, self.grid
        torch.cuda.empty_cache() if self.card.cuda else None

    def reference(self, control: bool = False, sample: List[int] = ()
                  ) -> Dict[str, float]:
        """The reference's render of the sampled images of the window
        (their pose indices in `sample`), against the program's (or, for
        the control, against the reference's own in TF32)."""
        import torch
        from . import check, inputs
        from .reference import model, tf32
        cfg, dev = self.spec["cfg"], self.card.device
        o = cfg["options"]
        W, H = cfg["cameras"]["wh"]
        cloud, spec, g = _reference_scene(self.spec, self.seed, dev)
        Wt = inputs.weights(cfg, self.seed, dev)
        bg = torch.ones((1, 3), device=dev)

        def ref_image(pose):
            return model.render(Wt, o, cloud, g, spec, pose["campos"],
                                pose["camrotc2w"], pose["raydir"], bg
                                ).reshape(H, W, 3).cpu().numpy()
        prog, ref = [], []
        for k, n in sample:
            pose = self.path[n]
            ref.append(ref_image(pose))
            if control:
                with tf32.Emulate():
                    prog.append(ref_image(pose))
            else:
                prog.append(self.images[k])
        return check.render_numbers(prog, ref)

    def rows(self, units: List[int]) -> Dict[int, Dict[str, tuple]]:
        """What each pose in `units` asks of the trunk
        (`model.count_rows`)."""
        from .reference import model
        o = self.spec["cfg"]["options"]
        _, spec, g = _reference_scene(self.spec, self.seed, self.card.device)
        return {i: model.count_rows(o, g, spec, self.path[i]["campos"],
                                    self.path[i]["raydir"], None,
                                    o["near_plane"], o["far_plane"])
                for i in sorted(set(units))}


def _ones(cloud):
    import torch
    return torch.ones(cloud["xyz"].shape[0], dtype=torch.bool,
                      device=cloud["xyz"].device)


def _reference_scene(spec: Dict, seed: int, device):
    """The cloud made again from the seed, and the reference's grid of it:
    (cloud, grid spec, grid)."""
    from . import inputs
    from .reference import grid as rgrid
    cloud = inputs.cloud(spec["cfg"], seed, device)
    gspec = rgrid.make_spec(spec["cfg"]["options"], cloud["xyz"])
    return cloud, gspec, rgrid.build(cloud["xyz"], _ones(cloud), gspec)


def run_cell(spec: Dict, seed: int, seconds: float, trace: bool, device,
             fault: Optional[str] = None, control: bool = False,
             t_start: Optional[float] = None) -> Dict:
    """One run of a cell on `device`; returns the result line's object."""
    import torch
    from .trace import Slice
    t_start = time.time() if t_start is None else t_start
    card = Card(device)
    kind = spec["traffic"]["kind"]
    cls = {"train": Train, "render": Render}[kind]
    if fault is not None and fault not in (TRAIN_FAULTS if kind == "train"
                                           else RENDER_FAULTS):
        raise ValueError(f"no fault {fault!r} in a {kind} mix")
    torch.set_num_threads(4)
    if control:
        mix = cls.__new__(cls)
        _control_setup(mix, spec, seed, card)
        numbers = mix.reference(control=True, **(
            {"sample": [(0, i) for i in range(
                int(spec["traffic"]["check_images"]))]}
            if kind == "render" else {}))
        return _result(spec, numbers, 0, 0, {}, card, 0, None)

    mix = cls(spec, seed, card, fault)
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
    with _span("window"):
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
    print(f"gpubench: {len(t)} {'images' if kind == 'render' else 'dispatches'}"
          f", median {t[len(t) // 2]!r} s, max {t[-1]!r} s", file=sys.stderr)
    print(f"gpubench: {mix.notes()}", file=sys.stderr)
    t_check = time.perf_counter()
    if kind == "render":
        rng = np.random.RandomState(seed % (2 ** 32))
        k = min(int(spec["traffic"]["check_images"]), len(window))
        picks = sorted(rng.choice(len(window), k, replace=False))
        numbers = mix.reference(sample=[(j, window[j]) for j in picks])
    else:
        numbers = mix.reference()
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
        ctx = _context(spec, mix, kind, sl, window, traced,
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


def _control_setup(mix, spec, seed, card):
    """What a mix's reference needs, without the program: the control
    puts the reference in TF32 in the program's place."""
    from . import inputs
    mix.spec, mix.seed, mix.card = spec, seed, card
    cfg, traffic = spec["cfg"], spec["traffic"]
    if spec["traffic"]["kind"] == "train":
        import torch
        mix.pool = inputs.train_pool(cfg, dict(traffic, pool_dispatches=3),
                                     seed, card.device)
        mix.S = int(traffic["steps_per_dispatch"])
        mix.u = torch.empty((mix.S, 1, cfg["options"]["random_sample_size"]
                             ** 2, cfg["options"]["z_depth_dim"]),
                            device=card.device)
    else:
        mix.path = inputs.render_path(cfg, traffic, seed, card.device)


def _context(spec, mix, kind, sl, window, traced, window_s, window_peak):
    """What the per-layer readers read. The window's units and time are
    those outside the traced slice, which the profiler slows: `window_s`
    comes without the slice."""
    from collections import Counter
    from .reference import model
    o = spec["cfg"]["options"]
    rows = mix.rows(window)
    window = list((Counter(window) - Counter(traced)).elements())
    per = mix.S if kind == "train" else 1

    def sum_rows(units, which="shaded"):
        return tuple(sum(rows[i][which][j] for i in units) for j in (0, 1))
    print(f"gpubench: (neighbor, shading) rows of the window outside the "
          f"slice: needed {sum_rows(window, 'needed')}, shaded "
          f"{sum_rows(window)}", file=sys.stderr)
    return {"kind": kind, "window_s": window_s,
            "window_units": per * len(window),
            "window_rows": sum_rows(window),
            "slice_units": per * len(traced), "slice_rows": sum_rows(traced),
            "slice": {"wall_s": sl.wall_s, "busy_s": sl.busy_s,
                      "families": sl.families},
            "trunk_macs": model.trunk_macs(o), "head_macs": model.head_macs(o),
            "point_features": o["point_features_dim"],
            "trunk_width": o["shading_feature_num"],
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
