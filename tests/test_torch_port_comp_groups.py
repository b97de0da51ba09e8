"""comp_groups > 1 on one device: the per-ray-group compaction the sharded
steps run, against the JAX package at the same G.

Each camera row's rays split into G contiguous groups, each compacted into
its own ceil(Nc / (B·G)) budget slice, so the comp leaves carry a leading
B·G axis. The scene is test_torch_port_train's lego-like tiny scene (its
auto budget drops rows, so the per-group budgets decide which). Integer
leaves exactly; loss items rtol/atol 1e-5; gradients rtol 2e-4, atol 2e-5
(the bar tests/test_pallas_trunk.py holds the Pallas trunk to).
"""

import jax
import numpy as np
import pytest
import torch

from pointnerf_tpu.models import renderer as jrend
from pointnerf_tpu.train import trainer as jtr
from pointnerf_tpu_torch.models import renderer as trend
from pointnerf_tpu_torch.train import trainer as ttr

from test_torch_port_train import (GRAD_TOL, _close_grads, _port, _scene,
                                   _uniform)

ITEM_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("G", [2, 4])
def test_comp_groups_matches_jax(G):
    """The query's comp leaves (comp_src, comp_valid, c_pidx, row_valid,
    counts) bit for bit, and the loss items and every gradient of
    compute_grads, at JAX's comp_groups = G."""
    opt, ts, spec, grid, batch = _scene(comp_groups=G)
    key = jax.random.PRNGKey(5)
    jts = jtr.point_state_of(ts)
    want_q = jax.jit(lambda p, g, b, k: jrend.render_query(
        p, g, spec, opt, b, k, is_train=True))(jts, grid, batch, key)
    st, spec_t, grid_t, tb = _port(opt, ts, batch)
    B, R = batch["raydir"].shape[:2]
    u = torch.tensor(_uniform(key, B, R, opt.z_depth_dim))
    got_q = trend.render_query(st.points, grid_t, spec_t, opt, tb,
                               is_train=True, u=u)
    Ncb = -(-trend.effective_sr_budget(opt, B * R * opt.SR) // (B * G))
    assert tuple(got_q.comp[0].shape) == (B * G, Ncb)
    names = ("comp_src", "comp_valid", "c_pidx", "row_valid", "counts")
    for name, a, b in zip(names, got_q.comp, want_q.comp):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    np.testing.assert_array_equal(got_q.ray_mask.numpy(),
                                  np.asarray(want_q.ray_mask))
    assert int(got_q.q_overflow) == int(want_q.q_overflow) > 0

    want, jn, jp = jtr.compute_grads(ts, grid, batch, key, opt, spec)
    items, g_net, g_pts = ttr.compute_grads(st, grid_t, tb, opt, spec_t, u)
    assert set(items) == set(want)
    assert float(items["sr_overflow"]) == float(want["sr_overflow"])
    for k, v in want.items():
        np.testing.assert_allclose(float(items[k]), float(v), err_msg=k,
                                   **ITEM_TOL)
    _close_grads(g_net, g_pts, jn, jp, **GRAD_TOL)


def test_comp_groups_matches_global_compaction():
    """JAX's test_comp_groups_matches_global_compaction on the port: at a
    budget that covers every group's rows (SR_budget 511, a covering wide
    tier) G = 2 and 4 compute the G = 1 row set, so the items, gradients
    and eval outputs equal G = 1's."""
    outs = {}
    for G in (1, 2, 4):
        opt, ts, spec, grid, batch = _scene(SR_budget=511, comp_groups=G,
                                            k_tier_wide_frac=1.0)
        st, spec_t, grid_t, tb = _port(opt, ts, batch)
        u = torch.tensor(_uniform(jax.random.PRNGKey(7), 1, 64,
                                  opt.z_depth_dim))
        items, g_net, g_pts = ttr.compute_grads(st, grid_t, tb, opt, spec_t,
                                                u)
        assert float(items["sr_overflow"]) == 0, G
        outs[G] = (items, g_net, g_pts,
                   ttr.eval_step(st, grid_t, tb, opt, spec_t))
    for G in (2, 4):
        items, g_net, g_pts, out = outs[G]
        for k, v in outs[1][0].items():
            np.testing.assert_allclose(float(items[k]), float(v),
                                       rtol=2e-5, atol=2e-6, err_msg=f"{G} {k}")
        for got, want in ((g_net, outs[1][1]), (g_pts, outs[1][2])):
            for k in want:
                torch.testing.assert_close(got[k], want[k], rtol=2e-4,
                                           atol=2e-5)
        torch.testing.assert_close(out["coarse_raycolor"],
                                   outs[1][3]["coarse_raycolor"],
                                   rtol=1e-6, atol=1e-7)
        assert torch.equal(out["ray_mask"], outs[1][3]["ray_mask"])


def test_comp_groups_must_divide_the_rays():
    """A G that does not divide the per-camera ray count raises
    ValueError, as JAX's query does."""
    opt, ts, spec, grid, batch = _scene(comp_groups=3)
    st, spec_t, grid_t, tb = _port(opt, ts, batch)
    with pytest.raises(ValueError, match="comp_groups"):
        trend.render_query(st.points, grid_t, spec_t, opt, tb,
                           is_train=True,
                           u=torch.zeros(1, 64, opt.z_depth_dim))
    with pytest.raises(ValueError, match="comp_groups"):
        jrend.render_query(jtr.point_state_of(ts), grid, spec, opt, batch,
                           jax.random.PRNGKey(0), is_train=True)
