"""A traced slice of the window: torch.profiler's CPU and CUDA activity
over a few steady dispatches or images, reduced in memory to device time
by family, the device's busy time, and the idle gaps by what the host
was doing. Nothing is written to disk.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from typing import Dict, List, Tuple

from .layers import family

SPAN = "gpubench."        # prefix of the benchmark's own host spans


def union_s(intervals) -> Tuple[float, List[Tuple[float, float]]]:
    """(total length of the union of (start, end) intervals in µs, in
    seconds; the merged intervals) — `utils/profiling.union_ms`'s
    arithmetic, copied."""
    total, merged = 0.0, []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                total += e - merged[-1][1]
                merged[-1] = (merged[-1][0], e)
        else:
            total += e - s
            merged.append((s, e))
    return total / 1e6, merged


class Slice:
    """Profile the block: `with Slice(device) as sl: ...`; then sl.wall_s,
    sl.busy_s, sl.families {family: s}, sl.kernels {name: s},
    sl.idle_by_host {host activity: s}."""

    def __init__(self, sync):
        self.sync = sync
        self.wall_s = self.busy_s = 0.0
        self.families: Dict[str, float] = {}
        self.kernels: Dict[str, float] = {}
        self.idle_by_host: Dict[str, float] = {}

    @contextlib.contextmanager
    def run(self, cuda: bool):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        self.sync()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            yield self
            self.sync()
            self.wall_s = time.perf_counter() - t0
        self._reduce(prof)

    def _reduce(self, prof) -> None:
        from torch.autograd import DeviceType
        dev, host = [], []
        for e in prof.events():
            if getattr(e, "is_user_annotation", False) \
                    and e.device_type == DeviceType.CUDA:
                continue
            (dev if e.device_type == DeviceType.CUDA else host).append(e)
        spans = [(e.time_range.start, e.time_range.end) for e in dev]
        self.busy_s, merged = union_s(spans)
        for e in dev:
            s = e.time_range.elapsed_us() / 1e6
            fam = family(e.name)
            self.families[fam] = self.families.get(fam, 0.0) + s
            self.kernels[e.name] = self.kernels.get(e.name, 0.0) + s
        # each gap between busy intervals, named by the innermost host
        # activity at its midpoint, under the innermost benchmark span
        gaps = [(a, b) for (_, a), (b, _) in zip(merged, merged[1:])]
        mids = [0.5 * (a + b) for a, b in gaps]
        inner = [None] * len(gaps)
        span = [None] * len(gaps)
        for e in host:
            lo = bisect.bisect_left(mids, e.time_range.start)
            hi = bisect.bisect_right(mids, e.time_range.end)
            d = e.time_range.elapsed_us()
            best = span if e.name.startswith(SPAN) else inner
            for i in range(lo, hi):
                if best[i] is None or d < best[i][0]:
                    best[i] = (d, e.name)
        for (a, b), s, h in zip(gaps, span, inner):
            name = (s[1] + ": " if s else "") + \
                (h[1] if h else "no host activity")
            self.idle_by_host[name] = self.idle_by_host.get(name, 0.0) \
                + (b - a) / 1e6

    def breakdown(self) -> Dict[str, list]:
        """The ten device operations that took most time (by family, a
        kernel of no family by its name) and the ten host activities the
        device waited longest on."""
        ops: Dict[str, float] = {}
        for name, s in self.kernels.items():
            fam = family(name)
            key = name[:80] if fam == "rest" else fam
            ops[key] = ops.get(key, 0.0) + s
        top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                                   key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(ops), "idle_gaps": top(self.idle_by_host)}
