"""Profiling (port of `pointnerf_tpu/utils/profiling.py`): a device trace of
the train loop and the per-phase wall-clock timer the finetune driver
prints with every loss line.

`device_trace(log_dir)` records the loop with `torch.profiler` (host and
CUDA activity) and writes one Chrome trace, ``<log_dir>/train_loop.
pt.trace.json`` (open it in chrome://tracing or Perfetto); the JAX package
writes a jax.profiler trace there. `PhaseTimer` is a copy of JAX's, with
the same `summary()` text. `device_busy(run)` gives the device's busy
time in a call (the measurement scripts' busy share).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator, Optional, Tuple

TRACE_FILE = "train_loop.pt.trace.json"


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Trace the block's host and CUDA activity into
    ``log_dir/train_loop.pt.trace.json``. No-op when log_dir is falsy."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


class PhaseTimer:
    """Accumulates wall-clock per named phase; read via summary()."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        parts = [f"{k}: {self.totals[k]:.2f}s/{self.counts[k]}"
                 for k in sorted(self.totals)]
        return "phases[" + ", ".join(parts) + "]"

    def reset(self):
        self.totals.clear()
        self.counts.clear()


def union_ms(intervals) -> float:
    """Total length of the union of (start, end) intervals given in
    microseconds, in milliseconds."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total, end = total + e - s, e
        elif e > end:
            total, end = total + e - end, e
    return total / 1e3


def device_busy(run: Callable[[], object]) -> Tuple[float, float]:
    """(wall ms, busy ms) of run() on the card under torch.profiler: the
    host clock around run() and the synchronize after it, and the union
    of the CUDA kernel and copy intervals it records (the spans of
    record_function annotations it also puts on the device are left out:
    they cover kernels already counted). Only CUDA activity is recorded,
    so the host runs at its own pace. Raises when it records no device
    activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False)]
    if not spans:
        raise RuntimeError("the profiler recorded no device activity")
    return wall, union_ms(spans)
