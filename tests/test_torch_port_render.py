"""End-to-end serving parity: the port's eval_step and render_image against
the JAX package's, on a lego-envelope variant of the tiny plane scene
(superset query, auto compaction budget, K-tier split, two-layer blocks,
fused trunk forced: JAX runs the Pallas trunk in interpret mode, the port
its plain version; likewise the fused_shade configuration's shade
kernel).

Tolerances: floats rtol = atol = 1e-5 (float32, summation order differs);
masks and counters exactly.
"""

import os

import numpy as np
import jax
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pointnerf_tpu.ops import grid as jgrid
from pointnerf_tpu.run import common as jcommon
from pointnerf_tpu.train import trainer as jtrainer
from pointnerf_tpu.utils.checkpoint import export_reference_npz
from pointnerf_tpu_torch.ops import grid as tgrid
from pointnerf_tpu_torch.ops import kernels
from pointnerf_tpu_torch.ops import trunk as tt
from pointnerf_tpu_torch.run import common as tcommon
from pointnerf_tpu_torch.train import trainer as ttrainer
from pointnerf_tpu_torch.utils import profiling
from pointnerf_tpu_torch.utils.checkpoint import (from_jax_params,
                                                  load_net_ray_marching_npz)

from test_end_to_end import tiny_setup

TOL = dict(rtol=1e-5, atol=1e-5)


def _lego_like(R_side=8, **kw):
    opt, state, _, _, batch, xyz = tiny_setup(R_side=R_side)
    kw = dict(dict(use_fused_trunk=1), **kw)
    opt = opt.replace(superset_P=16, SR_budget=-1, k_tier=-1,
                      shading_feature_mlp_layer1=2,
                      shading_feature_mlp_layer3=2, occ_segments=-1, **kw)
    spec = jgrid.make_grid_spec(opt, points_min=xyz.min(0),
                                points_max=xyz.max(0), max_points=len(xyz))
    grid = jgrid.build_grid(state["xyz"], state["mask"], spec)
    ts = jtrainer.create_train_state(opt, jax.random.PRNGKey(2), state)
    return opt, ts, spec, grid, batch


def _port_state(ts):
    agg_np = jax.tree.map(np.asarray, ts.agg_params)
    pts_np = {k: (None if v is None else np.asarray(v))
              for k, v in jtrainer.point_state_of(ts).items()}
    agg, pts = from_jax_params(agg_np, pts_np, device="cpu")
    return ttrainer.ServeState(agg, pts)


def _port_grid(opt, state):
    mask = state["mask"].numpy()
    xyz = state["xyz"].numpy()[mask]
    spec = tgrid.make_grid_spec(opt, xyz.min(0), xyz.max(0), int(mask.sum()))
    return spec, tgrid.build_grid(state["xyz"], state["mask"], spec)


@pytest.mark.parametrize("fused,order,shade", [
    pytest.param(1, 2, 0, id="1-2"), pytest.param(0, 2, 0, id="0-2"),
    pytest.param(1, 1, 0, id="1-1"), pytest.param(1, 2, 1, id="shade-2"),
    pytest.param(1, 1, 1, id="shade-1")])
def test_eval_step_matches_jax(fused, order, shade, monkeypatch):
    """fused=1: JAX's Pallas trunk (interpret) vs the port's fused_trunk
    plain version; fused=0: both packages' unfused MLP paths; shade=1: the
    fused_shade configuration, JAX's Pallas shade kernel (interpret) vs the
    port's fused_shade plain version."""
    opt, ts, spec_j, grid_j, batch = _lego_like(use_fused_trunk=fused,
                                                agg_intrp_order=order,
                                                fused_shade=shade)
    want = jtrainer.eval_step(ts, grid_j, batch, opt, spec_j)
    plain_shade = tt.fused_shade_reference
    calls = []
    monkeypatch.setattr(tt, "fused_shade_reference",
                        lambda *a: calls.append(1) or plain_shade(*a))
    st = _port_state(ts)
    spec_t, grid_t = _port_grid(opt, st.points)
    tb = {k: (torch.tensor(np.asarray(v)) if hasattr(v, "shape") else v)
          for k, v in batch.items()}
    got = ttrainer.eval_step(st, grid_t, tb, opt, spec_t)
    assert int(want["sr_overflow"]) > 0      # the auto budget overflows
    assert np.asarray(want["ray_mask"]).any()
    assert (np.asarray(want["weight"]) > 0).sum(-1).max() > 1  # wide tier used
    for k in ("ray_mask", "sr_overflow", "occ_overflow", "queried_shading"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    for k in ("coarse_raycolor", "coarse_point_opacity",
              "coarse_is_background", "coarse_mask", "weight",
              "blend_weight", "conf_coefficient"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)
    assert not any(k.launches for k in kernels.KERNELS)
    assert bool(calls) == bool(shade)    # the shade path ran its plain version


def _image_item(H=12, W=10, focal=30.0):
    py, px = np.meshgrid(np.arange(H, dtype=np.float32),
                         np.arange(W, dtype=np.float32), indexing="ij")
    pix = np.stack([px, py], -1).reshape(1, -1, 2)
    d = np.stack([(px + 0.5 - W / 2) / focal, (py + 0.5 - H / 2) / focal,
                  np.ones_like(px)], -1).reshape(1, -1, 3)
    return {"h": H, "w": W, "pixel_idx": pix, "raydir": d.astype(np.float32),
            "campos": np.array([[0.0, 0.0, -3.0]], np.float32),
            "camrotc2w": np.eye(3, dtype=np.float32)[None],
            "near": np.float32(2.0), "far": np.float32(4.0),
            "bg_color": np.ones((1, 3), np.float32)}


def test_render_image_matches_jax_through_ckpt(tmp_path, capsys):
    # explicit per-chunk budget small enough that groups climb the ladder
    opt, ts, spec_j, grid_j, _ = _lego_like(random_sample_size=4)
    opt = opt.replace(SR_budget=40)
    item = _image_item()
    want = jcommon.render_image(ts, grid_j, opt, spec_j, item, group=3)
    st = _port_state(ts)
    spec_t, grid_t = tcommon.make_spec_and_grid(opt, st.points)
    capsys.readouterr()
    got = tcommon.render_image(st, grid_t, opt, spec_t, item, group=3)
    assert "re-rendered up the budget ladder" in capsys.readouterr().out
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["ray_mask"], want["ray_mask"])
    np.testing.assert_allclose(got["coarse_raycolor"],
                               want["coarse_raycolor"], **TOL)
    assert want["ray_mask"].any() and not want["ray_mask"].all()

    # a JAX-written export serves the same image through the port
    path = os.path.join(tmp_path, "7_net_ray_marching.npz")
    export_reference_npz(path, ts.agg_params, jtrainer.point_state_of(ts))
    agg, pts = from_jax_params(*load_net_ray_marching_npz(path),
                               device="cpu")
    st2 = ttrainer.ServeState(agg, pts)
    spec2, grid2 = tcommon.make_spec_and_grid(opt, st2.points)
    got2 = tcommon.render_image(st2, grid2, opt, spec2, item, group=3)
    np.testing.assert_array_equal(got2["ray_mask"], want["ray_mask"])
    np.testing.assert_allclose(got2["coarse_raycolor"],
                               want["coarse_raycolor"], **TOL)
    # the module's state_dict carries the reference keys and [out,in] layout
    raw = np.load(path)
    ref = {k[len("aggregator."):]: raw[k] for k in raw.files
           if k.startswith("aggregator.")}
    sd = agg.state_dict()
    assert sorted(sd) == sorted(ref)
    for k, v in sd.items():
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)


# an image whose groups overflow the configured budget: 24x24 rays, the
# plane filling 84% of them, in chunks of 36 rays with 24 shading rows a
# ray (the plane occupies about 8 of them)
LADDER = dict(random_sample_size=6, SR=24)


@pytest.fixture(scope="module")
def ladder_scene():
    opt, ts, _, _, _ = _lego_like(**LADDER)
    return opt, _port_state(ts)


def _traced_render(st, grid, opt, spec, item):
    """render_image in groups of 4 chunks under a profiler session: (maps,
    stats, the render.group spans' attrs, the record's counters)."""
    stats = {}
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.RECORD.clear()
        maps = tcommon.render_image(st, grid, opt, spec, item, group=4,
                                    stats=stats)
    groups = [dict(s.attrs) for s in profiling.RECORD.spans
              if s.name == "render.group"]
    return maps, stats, groups, dict(profiling.RECORD.counters)


@pytest.mark.parametrize("kw,case", [
    pytest.param(dict(SR_budget=448, k_tier_wide_frac=0.05), "wide",
                 id="wide-tier"),
    pytest.param(dict(SR_budget=64), "both", id="tight"),
    pytest.param(dict(comp_groups=2), "", id="comp-groups"),
    pytest.param(dict(k_tier=0), "", id="no-k-tier"),
    pytest.param({}, "resized", id="resized")])
def test_sized_rung_renders_every_row(ladder_scene, kw, case):
    """A group that drops d rows at Ncb compaction rows and NtB wide-tier
    rows renders again at Ncb + d and NtB + d (each compaction group's),
    and drops nothing there: the image equals the uncompacted render
    (SR_budget 0) and no group reaches rung 2. wide: only the wide tier
    overflows (the compaction keeps every row); both: the compaction and
    the wide tier overflow; resized: a later group outgrows the persisted
    budget and is sized again, and the groups after it start there."""
    opt0, st = ladder_scene
    opt = opt0.replace(**kw)
    item = _image_item(H=24, W=24, focal=60.0)
    spec, grid = tcommon.make_spec_and_grid(opt, st.points)
    exact = tcommon.render_image(st, grid, opt.replace(SR_budget=0), spec,
                                 item, group=4)
    got, stats, groups, counters = _traced_render(st, grid, opt, spec, item)
    np.testing.assert_array_equal(got["ray_mask"], exact["ray_mask"])
    np.testing.assert_allclose(got["coarse_raycolor"],
                               exact["coarse_raycolor"], atol=1e-5)
    assert stats["rung_groups"][2] == 0 and stats["rung_groups"][1] > 0
    assert groups[0]["rung"] == 0 and groups[0]["dropped"] > 0
    G = int(opt.comp_groups)
    for a, b in zip(groups, groups[1:]):
        if a["dropped"]:            # the same group again, sized
            assert b["rung"] == 1
            assert b["budget"] >= a["budget"] + G * a["dropped"]
            assert b["wide"] >= a["wide"] + G * a["dropped"] \
                if opt.k_tier else b["wide"] == 0
    assert counters["render.resized"] == sum(g["dropped"] > 0
                                             for g in groups)
    assert stats["sized_budget"] == groups[-1]["budget"] // 4
    if case in ("wide", "both"):
        # the compaction's own overflow: the same render with a wide tier
        # as large as the budget
        _, _, whole, _ = _traced_render(
            st, grid, opt.replace(k_tier_wide_frac=1.0), spec, item)
        c = whole[0]["dropped"]
        assert (c == 0) if case == "wide" else 0 < c < groups[0]["dropped"]
    if case == "resized":
        i = next(i for i, g in enumerate(groups)
                 if g["rung"] == 1 and g["dropped"] > 0)
        assert groups[i + 1]["budget"] > groups[i]["budget"]
        assert len(groups) > i + 2
        assert all(g["budget"] == groups[i + 1]["budget"]
                   for g in groups[i + 2:])
