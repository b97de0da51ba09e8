"""The program's own trace record (`pointnerf_tpu_torch.utils.profiling.
RECORD`) as the traced slice's profiler session left it: the spans and
counters the port kept while the slice recorded. Beside the
`system*.py` modules the one module of the benchmark that reaches into
the program; it reads that record and nothing else, and gives None where
the program keeps none.

Counters (the port's names): ``trunk.rows.<tier>``, the trunk's (shading
row, neighbor slot) pairs that carry a valid neighbor, and
``trunk.slots.<tier>``, the pairs it runs, over the narrow and wide K
tiers and the uncompacted (dense) trunk. Spans: ``train.lead``, a train
dispatch from its entry to its first step's launch; ``render.image`` and
``render.group``, one render of a group of chunks at a rung of the
budget ladder (attrs ``rung`` and ``dropped``, the rows it dropped).
"""

from __future__ import annotations

from typing import Optional


def program_record():
    """The program's record, or None (a program without one)."""
    try:
        from pointnerf_tpu_torch.utils import profiling
    except ImportError:
        return None
    return getattr(profiling, "RECORD", None)


def _seconds(s) -> float:
    return s.end - s.start if s.end is not None else 0.0


def _spans(rec, name: str):
    return [s for s in getattr(rec, "spans", ()) if s.name == name]


def trunk_fill(ctx, kind: str) -> Optional[float]:
    """Trunk rows with a valid neighbor as a share of the trunk slots run,
    every tier, over the slice."""
    rec = program_record()
    if ctx["kind"] != kind or rec is None:
        return None
    c = getattr(rec, "counters", {})
    rows = sum(v for k, v in c.items() if k.startswith("trunk.rows."))
    slots = sum(v for k, v in c.items() if k.startswith("trunk.slots."))
    return 100.0 * rows / slots if slots > 0 else None


def ladder_pct(ctx) -> Optional[float]:
    """Share of the slice's `render.image` time spent in `render.group`
    renders above the first rung, or that dropped rows and were rendered
    again."""
    rec = program_record()
    if ctx["kind"] != "render" or rec is None:
        return None
    total = sum(_seconds(s) for s in _spans(rec, "render.image"))
    groups = _spans(rec, "render.group")
    if total <= 0 or not groups:
        return None
    up = sum(_seconds(g) for g in groups
             if g.attrs.get("rung", 0) > 0 or g.attrs.get("dropped", 0) > 0)
    return 100.0 * up / total


def lead_ms(ctx) -> Optional[float]:
    """The mean `train.lead` of the slice's dispatches, in ms."""
    rec = program_record()
    if ctx["kind"] != "train" or rec is None:
        return None
    leads = _spans(rec, "train.lead")
    if not leads:
        return None
    return 1e3 * sum(_seconds(s) for s in leads) / len(leads)
