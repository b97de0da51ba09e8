"""The readers of the program's trace record (`gpubench/record.py`): each
of the four metrics on a hand-built record and None on the other kind of
traffic or without a record; the record's trunk rows against the
reference's shaded neighbor rows, step by step; a traced run's line."""

from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gpubench import inputs, record, run
from gpubench.mix import reference_scene
from gpubench.reference import model
from gpubench.tests.conftest import tiny

SEED = 2 ** 31 + 29
READERS = run.ROOT / "gpubench" / "metrics"


def _span(name, start, end, **attrs):
    return SimpleNamespace(name=name, start=start, end=end, attrs=attrs)


HAND = SimpleNamespace(
    counters={"trunk.rows.narrow": 30, "trunk.slots.narrow": 100,
              "trunk.rows.wide": 60, "trunk.slots.wide": 200,
              "trunk.rows.dense": 10, "trunk.slots.dense": 100,
              "shade.rows.kept": 7},
    spans=[_span("train.dispatch", 0.0, 0.1, steps=8, route="graphed"),
           _span("train.lead", 0.0, 0.004),
           _span("train.dispatch", 0.2, 0.3, steps=8, route="graphed"),
           _span("train.lead", 0.2, 0.206),
           _span("render.image", 1.0, 3.0),
           _span("render.group", 1.0, 1.5, rung=0, dropped=0),
           _span("render.group", 1.5, 1.75, rung=0, dropped=12),
           _span("render.group", 1.75, 2.25, rung=1, dropped=0),
           _span("render.group", 2.25, 2.5, rung=2, dropped=0)])

WANT = {"trunk_fill.train": ("train", 25.0),
        "trunk_fill.render": ("render", 25.0),
        "ladder_pct.render": ("render", 50.0),
        "dispatch_lead_ms.train": ("train", 5.0)}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_a_hand_built_record(monkeypatch, name):
    kind, value = WANT[name]
    other = "render" if kind == "train" else "train"
    monkeypatch.setattr(record, "program_record", lambda: HAND)
    assert run.read_metric(READERS, name, {"kind": kind}) == \
        pytest.approx(value)
    assert run.read_metric(READERS, name, {"kind": other}) is None
    # a program that keeps no record, or kept nothing in the slice
    monkeypatch.setattr(record, "program_record", lambda: None)
    assert run.read_metric(READERS, name, {"kind": kind}) is None
    empty = SimpleNamespace(counters={}, spans=[])
    monkeypatch.setattr(record, "program_record", lambda: empty)
    assert run.read_metric(READERS, name, {"kind": kind}) is None


def test_trunk_rows_are_the_references_shaded_rows():
    """Each step of a pool dispatch, run alone under a CPU profiler
    session: the record's trunk rows with a valid neighbor equal the
    reference's count of the rows the step shades (`model.count_rows`),
    and its kept shading rows the reference's shaded shading rows."""
    from pointnerf_tpu_torch.utils import profiling
    spec = tiny("lego.train", 20000, focal=120.0)
    train = run.load_mix(spec["mixes"], "train")
    mix = train.Train(spec, SEED, run.Card("cpu"), None)
    o = spec["cfg"]["options"]
    _, gspec, g = reference_scene(spec, SEED, "cpu")
    d = mix.pool[2]
    buf = inputs.draws(d, torch.empty_like(mix.u))
    for s in range(mix.S):
        with profile(activities=[ProfilerActivity.CPU]):
            profiling.RECORD.clear()
            mix.call(train._sub(d, s, s + 1))
        c = profiling.RECORD.counters
        b = inputs.step_of(d, s)
        want = model.count_rows(o, g, gspec, b["campos"], b["raydir"],
                                buf[s, 0], b["near"], b["far"])["shaded"]
        got = (sum(v for k, v in c.items() if k.startswith("trunk.rows.")),
               c["shade.rows.kept"])
        assert got == want, s
        assert want[0] > 0


@pytest.mark.parametrize("workload,names", [
    ("lego.train", ("trunk_fill.train", "dispatch_lead_ms.train")),
    ("lego.render", ("trunk_fill.render", "ladder_pct.render"))])
def test_a_traced_run_reports_the_record(workload, names):
    out = run.run_cell(tiny(workload, 20000, 120.0), SEED, 0.5, True, "cpu")
    for n in names:
        v = out["metrics"][n]["value"]
        assert v >= 0 and (n.startswith("dispatch") or v <= 100), (n, v)
    assert 0 < out["metrics"][names[0]]["value"] <= 100
