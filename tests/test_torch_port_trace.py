"""The port's trace record (`utils.profiling`): the row counts the shade
phase makes on the device against a direct count of the query's and the
shade phase's outputs on the tiered, untiered and uncompacted paths; the
record off outside a profiler session and on inside one, its spans the
profiler's own host events; the train dispatch's and render_image's
counters; the phase timer's spans. The `cuda` test holds the graphed
dispatch's counters to the steps run in turn, and the capture to its
refusal of a host sync."""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pointnerf_tpu_torch.config import Options
from pointnerf_tpu_torch.models import neural_points as npc
from pointnerf_tpu_torch.models import renderer
from pointnerf_tpu_torch.ops import grid as tgrid
from pointnerf_tpu_torch.run.common import render_image
from pointnerf_tpu_torch.train import trainer
from pointnerf_tpu_torch.utils import profiling

SIDE = 12                       # the batch's rays: SIDE² of one camera
TIERS = ("narrow", "wide", "dense")


def _scene(dev="cpu", side=SIDE, **kw):
    """800 points in a thin slab seen by one camera, the K-tier split
    with rows in both tiers and an auto budget that drops rows (kw
    overrides): (opt, point state, spec, grid, batch)."""
    rng = np.random.RandomState(0)
    xyz = rng.uniform(-0.4, 0.4, (800, 3)).astype(np.float32)
    xyz[:, 2] *= 0.1
    n = len(xyz)
    opt = Options(**{**dict(
        point_features_dim=8, num_feat_freqs=2, dist_xyz_freq=3,
        num_viewdir_freqs=2, shading_feature_num=32,
        shading_feature_mlp_layer1=2, shading_feature_mlp_layer3=2,
        shading_alpha_mlp_layer=1, shading_color_mlp_layer=2,
        agg_intrp_order=2, agg_dist_pers=20, vsize=(0.04, 0.04, 0.04),
        vscale=(1, 1, 1), kernel_size=(3, 3, 3), query_size=(3, 3, 3),
        max_o=2048, P=8, K=8, SR=8, z_depth_dim=64, superset_P=16,
        SR_budget=-1, k_tier=-1, ranges=(-0.5, -0.5, -0.5, 0.5, 0.5, 0.5),
        radius_limit_scale=1.5, lr=0.01, plr=0.02, random_sample_size=6,
        color_loss_items=("ray_masked_coarse_raycolor",),
        color_loss_weights=(1.0,),
        zero_one_loss_items=("conf_coefficient",),
        zero_one_loss_weights=(0.0001,)), **kw})
    state = npc.create_point_cloud(
        xyz, rng.uniform(-0.5, 0.5, (n, 8)), rng.uniform(0, 1, (n, 3)),
        rng.normal(size=(n, 3)), rng.uniform(0.5, 1.2, (n, 1)), device=dev)
    spec = tgrid.make_grid_spec(opt, xyz.min(0), xyz.max(0), n)
    grid = tgrid.build_grid(state["xyz"], state["mask"], spec)
    px = np.linspace(-0.15, 0.15, side, dtype=np.float32)
    dx, dy = np.meshgrid(px, px, indexing="ij")
    rd = np.stack([dx, dy, np.ones_like(dx)], -1).reshape(1, -1, 3)
    batch = {"raydir": torch.as_tensor(rd, device=dev),
             "campos": torch.tensor([[0.0, 0.0, -3.0]], device=dev),
             "camrotc2w": torch.eye(3, device=dev)[None],
             "near": 2.0, "far": 4.0,
             "bg_color": torch.ones(1, 3, device=dev),
             "gt_image": torch.as_tensor(
                 rng.uniform(0, 1, (1, rd.shape[1], 3)).astype(np.float32),
                 device=dev)}
    return opt, state, spec, grid, batch


@pytest.fixture(autouse=True)
def fresh_record():
    """Each test's first profiler session starts from an empty record."""
    profiling.RECORD.clear()


def _state(opt, state):
    return trainer.create_train_state(opt, state,
                                      torch.Generator().manual_seed(0))


def _stacked(batch, S):
    return {k: (torch.stack([v] * S) if torch.is_tensor(v) else v)
            for k, v in batch.items()}


def _counts(t: profiling.Tally):
    return {**{k: int(v) for k, v in t.device.items()}, **t.host}


def _direct(opt, q, out):
    """The counts from the query's and the shade phase's outputs alone."""
    if q.comp is None:
        p = q.sample_pidx
        has = torch.any(p >= 0, dim=-1)
        return {"trunk.rows.dense": int((p >= 0).sum()),
                "trunk.slots.dense": p.numel(),
                "shade.rows.occupied": int(has.sum()),
                "shade.rows.kept": int(has.sum())}
    _, valid, p, _, _ = q.comp
    BG, Ncb, K = p.shape
    occupied = int(valid.sum()) + int(q.q_overflow)
    kt = renderer.tier_k(opt, K)
    if not kt:
        assert int(out["sr_overflow"]) == int(q.q_overflow)
        return {"trunk.rows.wide": int((p >= 0).sum()),
                "trunk.slots.wide": p.numel(),
                "shade.rows.occupied": occupied,
                "shade.rows.kept": int((valid & torch.any(p >= 0, -1)).sum())}
    wide = torch.any(p[..., kt:] >= 0, dim=-1)
    mA = valid & torch.any(p[..., :kt] >= 0, dim=-1) & ~wide
    mB = valid & wide
    NtB = renderer.wide_budget(opt, Ncb)
    inB = mB & (torch.cumsum(mB.int(), dim=1) <= NtB)
    # the shade phase's overflow: the query's and the wide tier's
    assert int(out["sr_overflow"]) == int(q.q_overflow) + int(
        mB.sum() - inB.sum())
    return {"trunk.rows.narrow": int((p[..., :kt] >= 0)[mA].sum()),
            "trunk.slots.narrow": BG * Ncb * kt,
            "trunk.rows.wide": int((p >= 0)[inB].sum()),
            "trunk.slots.wide": BG * NtB * K,
            "shade.rows.occupied": occupied,
            "shade.rows.kept": int(mA.sum() + inB.sum())}


@pytest.mark.parametrize("path,kw", [
    ("tiered", {}), ("untiered", dict(k_tier=0)),
    ("uncompacted", dict(SR_budget=0))])
def test_row_counts_equal_a_direct_count(path, kw):
    opt, state, spec, grid, batch = _scene(**kw)
    ts = _state(opt, state)
    with torch.no_grad(), profiling.tally() as t:
        q = renderer.render_query(ts.points, grid, spec, opt, batch)
        out = renderer.render_shade(ts.aggregator, ts.points, spec, opt,
                                    batch, q)
    want = _direct(opt, q, out)
    assert _counts(t) == want
    assert all(t.device[k].dtype == torch.int64 for k in t.device)
    assert all(v > 0 for k, v in want.items() if k.startswith("trunk."))
    if path == "tiered":
        assert int(out["sr_overflow"]) > 0     # the budget drops rows
    # no tally open: nothing is counted
    with torch.no_grad():
        renderer.render_shade(ts.aggregator, ts.points, spec, opt, batch, q)
    assert profiling.tallying() is None


def test_record_is_off_outside_a_profiler():
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("before", 1)
    assert profiling.RECORD.counters == {"before": 1}
    spans, counters = list(profiling.RECORD.spans), \
        dict(profiling.RECORD.counters)
    assert not profiling.recording()
    with profiling.span("outside", a=1) as sp:
        profiling.count("outside", 3)
        sp.attrs["b"] = 2
    opt, state, spec, grid, batch = _scene()
    trainer.train_steps_scan(_state(opt, state), grid, _stacked(batch, 2),
                             opt, spec)
    assert profiling.RECORD.spans == spans
    assert profiling.RECORD.counters == counters
    # the next session starts a record of its own
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.recording()
        profiling.count("after", 2)
    assert profiling.RECORD.counters == {"after": 2}


def _named(name):
    return [s for s in profiling.RECORD.spans if s.name == name]


def _events(prof):
    """The profiler's host events of the port's spans, by name, in start
    order: [(start µs, end µs)]."""
    out = {}
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if e.name.startswith(profiling.SPAN):
            out.setdefault(e.name[len(profiling.SPAN):], []).append(
                (e.time_range.start, e.time_range.end))
    return out


def test_spans_are_the_profilers_host_events():
    """Inside a CPU session every kept span is one of the profiler's host
    events under its pnt. name, nested in its parent's, lasting as long
    (within 10% or 50 µs)."""
    opt, state, spec, grid, batch = _scene()
    ts = _state(opt, state)
    item = _item(batch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_steps_scan(ts, grid, _stacked(batch, 3), opt, spec)
        render_image(trainer.ServeState(ts.aggregator, ts.points), grid,
                     opt, spec, item, group=4)
    rec = profiling.RECORD
    events = _events(prof)
    names = {s.name for s in rec.spans}
    assert {"train.dispatch", "train.lead", "train.readback", "render.image",
            "render.group", "render.readback"} <= names
    assert not rec.open
    seen = {}
    placed = []
    for s in rec.spans:
        k = seen.get(s.name, 0)
        seen[s.name] = k + 1
        start, end = events[s.name][k]
        placed.append((start, end))
        dur = (end - start) / 1e6
        kept = s.end - s.start
        assert abs(dur - kept) <= max(0.1 * dur, 50e-6), s.name
        if s.parent is not None:
            ps, pe = placed[s.parent]
            assert ps <= start and end <= pe, (s.name,
                                               rec.spans[s.parent].name)
    assert {k: len(v) for k, v in events.items()} == seen
    d = _named("train.dispatch")[0]
    assert d.attrs == {"steps": 3, "route": "in_turn"}
    assert rec.spans[_named("train.lead")[0].parent] is d


def _item(batch):
    """The batch's camera as render_image's item: a square image."""
    side = int(round(batch["raydir"].shape[1] ** 0.5))
    py, px = np.meshgrid(np.arange(side, dtype=np.float32),
                         np.arange(side, dtype=np.float32), indexing="ij")
    return {"h": side, "w": side,
            "pixel_idx": np.stack([px, py], -1).reshape(1, -1, 2),
            "raydir": batch["raydir"].cpu().numpy(),
            "campos": batch["campos"].cpu().numpy(),
            "camrotc2w": batch["camrotc2w"].cpu().numpy(),
            "near": np.float32(2.0), "far": np.float32(4.0),
            "bg_color": np.ones((1, 3), np.float32)}


def _ladder_overflow(ts, grid, opt, spec, batch, group):
    """render_image's budget ladder over the image's groups, from the
    wide renders' own sr_overflow: a render of n chunks at Nc compaction
    rows and NtB wide-tier rows that drops d rows is rendered again at
    Nc + d rows (rounded up to 128 a chunk) with a wide tier of at least
    NtB + d, and later groups start at that budget. Returns (the rows
    dropped and rendered again, the renders that dropped rows, the groups
    by the rung they finished at)."""
    chunk = opt.random_sample_size ** 2
    const = {k: batch[k] for k in ("campos", "camrotc2w", "bg_color")}
    const.update(near=2.0, far=4.0)
    S_chunk = chunk * opt.SR
    rays = batch["raydir"][0]
    chunks = [rays[i:i + chunk] for i in range(0, rays.shape[0], chunk)]
    up = None
    over = drops = 0
    finals = [0, 0, 0]
    for g in range(0, len(chunks), group):
        part = chunks[g:g + group]
        n = len(part)
        stacked = {"raydir": torch.stack(part)[:, None]}
        o, r = (opt, 0) if up is None else (up, 1)
        while True:
            Nc = int(o.SR_budget) * n if int(o.SR_budget) > 0 else \
                renderer.effective_sr_budget(o, n * S_chunk)
            out = trainer.eval_chunks_stacked(
                ts, grid, stacked, const, o.replace(SR_budget=Nc), spec)
            d = int(out["sr_overflow"].sum())
            if d == 0:
                break
            over, drops = over + d, drops + 1
            per_chunk = -(-(Nc + d) // (n * 128)) * 128
            assert per_chunk < S_chunk       # the sized rung stays compacted
            NtB = renderer.wide_budget(o, Nc)
            up = o = o.replace(SR_budget=per_chunk,
                               k_tier_wide_frac=(NtB + d) / (per_chunk * n))
            r = 1
        finals[r] += 1
    return over, drops, finals


def test_render_image_counts_its_rungs():
    """Groups by the rung they finished at sum to the image's groups, the
    record's counters equal the stats, and sr_overflow is the ladder's
    own count of the rows the renders dropped. The sized rung renders
    every row: no group reaches rung 2, and every render that dropped
    rows was sized again."""
    opt, state, spec, grid, batch = _scene(side=24)     # 16 chunks of 36
    ts = _state(opt, state)
    ss = trainer.ServeState(ts.aggregator, ts.points)
    stats = {}
    with profile(activities=[ProfilerActivity.CPU]):
        maps = render_image(ss, grid, opt, spec, _item(batch), group=4,
                            stats=stats)
    assert sum(stats["rung_groups"]) == stats["groups"] == 4
    assert stats["sr_overflow"] > 0 and sum(stats["rung_groups"][1:]) > 0
    over, drops, finals = _ladder_overflow(ts, grid, opt, spec, batch, 4)
    assert stats["sr_overflow"] == over
    assert stats["rung_groups"] == finals and stats["rung_groups"][2] == 0
    c = profiling.RECORD.counters
    assert [c.get(f"render.groups.r{i}", 0) for i in range(3)] == \
        stats["rung_groups"]
    assert sum(c.get(f"trunk.rows.{t}", 0) for t in TIERS) == \
        sum(stats["trunk_rows"]) > 0
    assert sum(c.get(f"trunk.slots.{t}", 0) for t in TIERS) == \
        sum(stats["trunk_slots"])
    assert stats["trunk_slots"][-1] == c.get("trunk.slots.dense", 0) == 0
    groups = _named("render.group")
    dropped = [g.attrs["dropped"] for g in groups]
    assert sum(dropped) == stats["sr_overflow"]
    assert len(groups) == stats["groups"] + sum(d > 0 for d in dropped)
    assert c["render.resized"] == sum(d > 0 for d in dropped) == drops
    assert stats["sized_budget"] == groups[-1].attrs["budget"] // 4
    # untraced, the same image and stats
    again = {}
    maps2 = render_image(ss, grid, opt, spec, _item(batch), group=4,
                         stats=again)
    assert again == stats
    np.testing.assert_array_equal(maps["coarse_raycolor"],
                                  maps2["coarse_raycolor"])


def test_dispatch_counts_sum_its_steps(tmp_path):
    """A dispatch's counters in the record are its steps' counts summed;
    its items keep their names and values; device_trace writes the
    counters beside the trace."""
    opt, state, spec, grid, batch = _scene()
    S = 3
    u = torch.rand((S, 1, SIDE ** 2, opt.z_depth_dim),
                   generator=torch.Generator().manual_seed(1))
    st, ref = _state(opt, state), _state(opt, state)
    want, items_ref = {}, []
    for s in range(S):
        with profiling.tally() as t:
            _, items = trainer.train_step(ref, grid, batch, opt, spec, u[s])
        items_ref.append(items)
        for k, v in _counts(t).items():
            want[k] = want.get(k, 0) + v
    with profiling.device_trace(str(tmp_path)):
        st, got = trainer.train_steps_scan(st, grid, _stacked(batch, S), opt,
                                           spec, u)
    assert set(got) == set(items_ref[0])
    for k, v in got.items():
        assert v.dtype == torch.float32 and v.shape == (S,)
        assert v.tolist() == [float(i[k]) for i in items_ref], k
    c = profiling.RECORD.counters
    assert {k: c[k] for k in want} == want
    assert want["trunk.rows.narrow"] + want["trunk.rows.wide"] > 0
    with open(os.path.join(tmp_path, profiling.COUNTERS_FILE)) as f:
        assert json.load(f) == c
    assert len(_named("train.lead")) == 1


def test_phase_timer_phases_are_spans():
    timer = profiling.PhaseTimer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.phase("host_data"):
            pass
        with timer.phase("device_step"):
            pass
    assert [s.name for s in profiling.RECORD.spans] == [
        "phase.host_data", "phase.device_step"]
    assert set(_events(prof)) == {"phase.host_data", "phase.device_step"}
    assert timer.summary().startswith("phases[device_step: ")


@pytest.mark.cuda
def test_graphed_dispatch_counts_equal_steps_in_turn(monkeypatch):
    """On the card: the graphed dispatch's counters (a capture dispatch,
    then a replaying one) equal the same steps run in turn on a twin
    state; the capture still raises on a host sync."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from pointnerf_tpu_torch.ops import ray_march
    from pointnerf_tpu_torch.train import graph
    dev = torch.device("cuda")
    opt, state, spec, grid, batch = _scene(dev, side=24, use_fused_trunk=1)
    S = 4
    u = torch.rand((S, 1, 24 ** 2, opt.z_depth_dim), device=dev,
                   generator=torch.Generator(device=dev).manual_seed(1))
    st, ref = _state(opt, state), _state(opt, state)
    batches = _stacked(batch, S)
    for _ in range(2):
        # back-to-back sessions: each starts its record by hand
        with profile(activities=[ProfilerActivity.CPU]):
            profiling.RECORD.clear()
            st, got = trainer.train_steps_scan(st, grid, batches, opt, spec,
                                               u)
        graphed = dict(profiling.RECORD.counters)
        with profile(activities=[ProfilerActivity.CPU]):
            profiling.RECORD.clear()
            ref, want = trainer.steps_in_turn(
                lambda s, b, us: trainer.train_step(s, grid, b, opt, spec,
                                                    us), ref, batches, u)
        eager = dict(profiling.RECORD.counters)
        assert graphed.pop("train.captures", 0) == int(_ == 0)
        assert graphed == eager and eager["trunk.rows.wide"] > 0
        assert torch.equal(got["sr_overflow"], want["sr_overflow"])
    assert st.dispatch.captures == 1
    graph.drop(st)

    plain = ray_march.transmission

    def read_back(x):
        float(x.sum())
        return plain(x)
    monkeypatch.setattr(ray_march, "transmission", read_back)
    st = _state(opt, state)
    with pytest.raises(RuntimeError):
        trainer.train_steps_scan(st, grid, _stacked(batch, 3), opt, spec)
    assert st.dispatch.graph is None and st.dispatch.captures == 0
    torch.cuda.synchronize()
