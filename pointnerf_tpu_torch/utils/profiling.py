"""Profiling (port of `pointnerf_tpu/utils/profiling.py`): a device trace of
the train loop, the per-phase wall-clock timer the finetune driver prints
with every loss line, and the port's trace record.

`device_trace(log_dir)` records the loop with `torch.profiler` (host and
CUDA activity) and writes one Chrome trace, ``<log_dir>/train_loop.
pt.trace.json`` (open it in chrome://tracing or Perfetto), and the trace
record's counters beside it (``train_loop.counters.json``); the JAX
package writes a jax.profiler trace there. `PhaseTimer` is a copy of
JAX's, with the same `summary()` text; each phase is a span too.
`device_busy(run)` gives the device's busy time in a call (the
measurement scripts' busy share).

The trace record (`RECORD`): `span(name, **attrs)` marks a stretch of
host code as ``pnt.<name>`` on the profiler's timeline
(`torch.profiler.record_function`), and `count(name, n)` adds host
integers to named counters. The record keeps them, with each span's
parent, start, end and attrs, exactly while a torch.profiler session
records (the profiler's own enabled flag). A span or count that finds a
session on after one that found none starts a new record (a session
that follows another with no span or count between them adds to its
record; `Record.clear` starts one by hand, as `device_trace` does); the
record stays readable after its session. Outside a session a span costs
one record_function enter and exit, and a count one flag test.

Counts the device makes inside a step go through a `tally`: the code that
forms the rows adds 0-d int64 device tensors (and host integers from the
shapes) to the open tally, and the caller that opened it carries them to
the host in a copy it makes anyway (`train.trainer.read_rows`,
`run.common.render_image`), so a captured step still makes no host sync.
With no tally open nothing is counted on the device.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler

TRACE_FILE = "train_loop.pt.trace.json"
COUNTERS_FILE = "train_loop.counters.json"
SPAN = "pnt."           # prefix of the port's spans on the profiler's timeline


class Span:
    """A kept span: its name (without the prefix), its parent's index in
    the record's spans (None at the top), host start and end
    (time.perf_counter seconds) and attrs."""
    __slots__ = ("name", "parent", "start", "end", "attrs")

    def __init__(self, name: str, parent: Optional[int], attrs: Dict):
        self.name, self.parent, self.attrs = name, parent, attrs
        self.start = time.perf_counter()
        self.end: Optional[float] = None


class Record:
    """What the program traced in the latest profiler session: its spans
    in the order they opened, and its counters."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}
        self.open: List[int] = []       # indices of the spans still open

    def clear(self) -> None:
        self.spans, self.counters, self.open = [], {}, []


RECORD = Record()
_was_on = False


def recording() -> bool:
    """Whether a torch.profiler session records now; a call that finds it
    on after one that found it off clears the record."""
    global _was_on
    on = _profiler._is_profiler_enabled
    if on and not _was_on:
        RECORD.clear()
    _was_on = on
    return on


class span:
    """``with span("train.dispatch", steps=8) as sp: ...``: the block as
    ``pnt.train.dispatch`` on the profiler's timeline, and, while the
    record is on, a kept `Span` whose attrs the block may add to
    (``sp.attrs``). `open()` and `close()` (idempotent) delimit a span
    that does not follow a block."""
    __slots__ = ("_fn", "_name", "_kept", "_at", "attrs")

    def __init__(self, name: str, **attrs):
        self._fn = torch.profiler.record_function(SPAN + name)
        self._name = name
        self._kept: Optional[Span] = None
        self._at = -1
        self.attrs = attrs

    def open(self) -> "span":
        self._fn.__enter__()
        if recording():
            rec = RECORD
            self._kept = Span(self._name, rec.open[-1] if rec.open else None,
                              self.attrs)
            self._at = len(rec.spans)
            rec.open.append(self._at)
            rec.spans.append(self._kept)
        return self

    def close(self) -> None:
        fn, self._fn = self._fn, None
        if fn is None:
            return
        fn.__exit__(None, None, None)
        if self._kept is not None:
            # the host clock read after the profiler's own, at both ends
            self._kept.end = time.perf_counter()
            if self._at in RECORD.open:
                RECORD.open.remove(self._at)

    def __enter__(self) -> "span":
        return self.open()

    def __exit__(self, *exc) -> None:
        self.close()


def count(name: str, n: int) -> None:
    """Add n to the record's counter `name` while the record is on."""
    if recording():
        RECORD.counters[name] = RECORD.counters.get(name, 0) + int(n)


class Tally:
    """One step's or one render's device counts: 0-d int64 tensors on
    the device (`device`), summed as they are added, and host integers
    (`host`)."""

    def __init__(self):
        self.device: Dict[str, torch.Tensor] = {}
        self.host: Dict[str, int] = {}

    def add(self, name: str, n) -> None:
        if torch.is_tensor(n):
            prev = self.device.get(name)
            self.device[name] = n if prev is None else prev + n
        else:
            self.host[name] = self.host.get(name, 0) + int(n)

    def names(self) -> List[str]:
        return sorted(self.device)


_TALLIES: List[Optional[Tally]] = []


def tallying() -> Optional[Tally]:
    """The innermost open tally, or None (none open, or paused)."""
    return _TALLIES[-1] if _TALLIES else None


@contextlib.contextmanager
def tally(paused: bool = False) -> Iterator[Optional[Tally]]:
    """Open a tally for the block (`paused`: none, e.g. around a backward
    pass that recomputes what the forward counted)."""
    t = None if paused else Tally()
    _TALLIES.append(t)
    try:
        yield t
    finally:
        _TALLIES.pop()


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Trace the block's host and CUDA activity into
    ``log_dir/train_loop.pt.trace.json``, and the trace record's counters
    into ``log_dir/train_loop.counters.json``. No-op when log_dir is
    falsy."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    RECORD.clear()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
        with open(os.path.join(log_dir, COUNTERS_FILE), "w") as f:
            json.dump(dict(sorted(RECORD.counters.items())), f, indent=1)


class PhaseTimer:
    """Accumulates wall-clock per named phase; read via summary(). Each
    phase is a span of the trace record, ``phase.<name>``."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            with span("phase." + name):
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
