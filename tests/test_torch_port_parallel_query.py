"""The frustum query (wcoord_query 0) and the vox-grid query (NN -1) over
ray shards, in this process, and the draws of a frustum train step.

Both queries compact each camera row into one budget across its ray
shards (`ops.query.Shards`, `models.renderer.RowShare`). Here the shards
of one camera row run one after another (`_Pieces`: a shard's prefix is
the sum of the counts the shards before it passed at the same call), so
their joined render is held to the port's single-device render, whose
parity with JAX's the frustum and vox-grid test files hold: integer
outputs and counters exactly, colors at 1e-6, the gradients summed over
the shards at rtol 2e-5, atol 2e-6. The spawned ranks' parity with JAX
is in test_torch_port_parallel.py.
"""

import itertools

import jax
import numpy as np
import pytest
import torch

from pointnerf_tpu.parallel import make_mesh as jmake_mesh
from pointnerf_tpu.run import common as jcommon
from pointnerf_tpu.train import trainer as jtr
from pointnerf_tpu_torch.models.renderer import (render_forward,
                                                 render_query, render_shade)
from pointnerf_tpu_torch.ops.query import Shards
from pointnerf_tpu_torch.parallel import driver
from pointnerf_tpu_torch.run import common as tcommon
from pointnerf_tpu_torch.train import trainer as ttr
from pointnerf_tpu_torch.utils.checkpoint import from_jax_train_state

from test_torch_port_frustum import _port_opt, _render_setup
from test_torch_port_train import _close_grads, _close_items, _np_tree
from test_torch_port_voxgrid import _port as _vox_port
from test_torch_port_voxgrid import _vox_scene

OUT_TOL = dict(rtol=1e-6, atol=1e-6)
SUM_TOL = dict(rtol=2e-5, atol=2e-6)
LOSS_TOL = dict(rtol=2e-5, atol=2e-6)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
VOX = dict(agg_distance_kernel="linear", agg_weight_norm=1, SR_budget=200,
           agg_axis_weight=(0.5, 2.0, 1.5))


class _Pieces:
    """n ray shards of one camera row, run one after another: the k-th
    prefix call of shard i returns the sum of the counts that the shards
    before it passed at their k-th call."""

    def __init__(self, n: int):
        self.n, self.calls = n, {}

    def shards(self, i: int) -> Shards:
        seq = itertools.count()

        def prefix(counts):
            got = self.calls.setdefault(next(seq), {})
            got[i] = counts.clone()
            return sum((got[j] for j in range(i)), torch.zeros_like(counts))
        return Shards(1, self.n, i, prefix)


def _piece(batch, i, n):
    R = batch["raydir"].shape[1]
    sl = slice(i * R // n, (i + 1) * R // n)
    return {k: (v[:, sl] if k in ttr.RAY_KEYS and torch.is_tensor(v) else v)
            for k, v in batch.items()}


def _render_pieces(agg, pts, grid, spec, opt, batch, n, **kw):
    """(the shards' outputs joined along the rays, their sr_overflow
    summed, each shard's output)."""
    pieces = _Pieces(n)
    outs = [render_forward(agg, pts, grid, spec, opt, _piece(batch, i, n),
                           shards=pieces.shards(i), **kw) for i in range(n)]
    joined = {k: torch.cat([o[k] for o in outs], dim=1)
              for k in ("coarse_raycolor", "ray_mask")}
    return joined, sum(int(o["sr_overflow"]) for o in outs), outs


def _same_render(joined, over, want):
    np.testing.assert_array_equal(joined["ray_mask"].numpy(),
                                  want["ray_mask"].numpy())
    np.testing.assert_allclose(joined["coarse_raycolor"].numpy(),
                               want["coarse_raycolor"].numpy(), **OUT_TOL)
    assert over == int(want["sr_overflow"]) > 0


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("kw", [
    pytest.param(dict(SR_budget=40, k_tier=1), id="budget40"),
    pytest.param(dict(SR_budget=20), id="budget20")])
def test_frustum_shards_render_the_whole_row(kw, n):
    """The frustum's camera row split over n shards: each keeps its valid
    rows that follow fewer than the row's budget of valid rows, so the
    joined render is the single-device render, and the rows each drops
    sum to the row's overflow. Each shard compacts into a buffer of at
    most the row's budget."""
    opt, _, spec_t, _, _, _, agg, pts, tb = _render_setup(**kw)
    opt = _port_opt(opt)
    with torch.no_grad():
        want = render_forward(agg, pts, None, spec_t, opt, tb)
        joined, over, outs = _render_pieces(agg, pts, None, spec_t, opt, tb,
                                            n)
    _same_render(joined, over, want)
    for o in outs:
        assert o["conf_compact"].shape[1] <= opt.SR_budget


def test_frustum_nn0_shards_take_the_whole_budget_priorities():
    """NN 0 under a budget: every shard draws the whole budget's
    priorities from the same generator state and ranks its kept rows'
    candidates by the slice at their place in the row, so the shards pick
    the neighbors the single-device query picks from the same state."""
    opt, _, spec_t, _, _, _, agg, pts, tb = _render_setup(NN=0, SR_budget=20)
    opt = _port_opt(opt)
    gen = lambda: torch.Generator().manual_seed(3)
    with torch.no_grad():
        one = render_query(pts, None, spec_t, opt, tb, generator=gen())
        pieces = _Pieces(2)
        qs = [render_query(pts, None, spec_t, opt, _piece(tb, i, 2),
                           generator=gen(), shards=pieces.shards(i))
              for i in range(2)]
    src, valid, c_pidx = one.comp[:3]
    want = c_pidx[valid]
    got = torch.cat([q.comp[2][q.comp[1]] for q in qs])
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert int(one.q_overflow) == sum(int(q.q_overflow) for q in qs) > 0
    assert len(got) == opt.SR_budget


@pytest.mark.parametrize("n", [2, 4, 5])
def test_vox_grid_shards_render_and_differentiate_the_whole_row(n):
    """NN -1 on the shade side: the shards share the row's compaction
    budget and its wide-tier budget, so the joined render is the single-
    device render, the dropped rows sum to its sr_overflow (both budgets
    overflow), and the aggregator and point gradients of the summed colors,
    summed over the shards, are its gradients."""
    opt, ts, spec, grid, batch = _vox_scene(**VOX)
    st, tspec, tgrid, tb = _vox_port(opt, ts, batch)
    ps = st.points

    def grads(out):
        params = list(st.aggregator.parameters()) + list(st.pt_train.values())
        return torch.autograd.grad(out["coarse_raycolor"].sum(), params,
                                   allow_unused=True)

    with torch.no_grad():
        q = render_query(ps, tgrid, tspec, opt, tb)
    want = render_shade(st.aggregator, ps, tspec, opt, tb, q)
    g_want = grads(want)
    pieces = _Pieces(n)
    outs, g_sum = [], None
    for i in range(n):
        sub = _piece(tb, i, n)
        with torch.no_grad():
            qi = render_query(ps, tgrid, tspec, opt, sub,
                              shards=pieces.shards(i))
        out = render_shade(st.aggregator, ps, tspec, opt, sub, qi)
        gi = grads(out)
        g_sum = gi if g_sum is None else [
            None if a is None else a + b for a, b in zip(g_sum, gi)]
        outs.append({k: v.detach() if torch.is_tensor(v) else v
                     for k, v in out.items()})
        assert qi.share.rows <= 200 and qi.share.wide_rows <= 128
    joined = {k: torch.cat([o[k] for o in outs], dim=1)
              for k in ("coarse_raycolor", "ray_mask")}
    _same_render(joined, sum(int(o["sr_overflow"]) for o in outs),
                 {k: v.detach() for k, v in want.items()
                  if k in ("coarse_raycolor", "ray_mask", "sr_overflow")})
    for a, b in zip(g_sum, g_want):
        if b is not None:
            np.testing.assert_allclose(a.numpy(), b.numpy(), **SUM_TOL)


def _frustum_train_scene():
    opt, spec_j, spec_t, state, _, jb, _, _, tb = _render_setup(
        shpnt_jitter="uniform", SR_budget=40, k_tier=1)
    ts = jtr.create_train_state(opt, jax.random.PRNGKey(2), state)
    R = jb["raydir"].shape[1]
    gt = np.random.RandomState(4).rand(1, R, 3).astype(np.float32)
    jb = dict(jb, gt_image=jax.numpy.asarray(gt))
    tb = dict(tb, gt_image=torch.tensor(gt))
    st = from_jax_train_state(_np_tree(ts), opt, device="cpu")
    return opt, ts, spec_j, jb, st, spec_t, tb


def test_frustum_train_step_draws_its_shpnt_jitter():
    """trainer.jitter_draws under wcoord_query 0 draws the shpnt_jitter's
    [B,R,SR] (it drew the world query's [B,R,z_depth_dim], which the
    frustum's jitter cannot take: train_step(u=None) raised), train_step
    without draws takes exactly those draws from the state's generator,
    and with JAX's draws injected the step equals JAX's train_step."""
    opt, ts, spec_j, jb, st, spec_t, tb = _frustum_train_scene()
    topt = _port_opt(opt)
    R = tb["raydir"].shape[1]
    st.generator.manual_seed(5)
    u = ttr.jitter_draws(st, tb, topt)
    assert u.shape == (1, R, topt.SR) != (1, R, topt.z_depth_dim)
    twin = from_jax_train_state(_np_tree(ts), opt, device="cpu")
    st.generator.manual_seed(5)
    _, items = ttr.train_step(st, None, tb, topt, spec_t)
    _, items_u = ttr.train_step(twin, None, tb, topt, spec_t, u=u)
    for k, v in items_u.items():
        assert float(items[k]) == float(v), k

    key = jax.random.PRNGKey(7)
    ts1, want = jtr.train_step(ts, None, jb, key, opt, spec_j)
    ju = torch.tensor(np.asarray(jax.random.uniform(
        jax.random.fold_in(key, 0), (1, R, opt.SR))))
    port = from_jax_train_state(_np_tree(ts), opt, device="cpu")
    port, got = ttr.train_step(port, None, tb, topt, spec_t, u=ju)
    assert float(got["sr_overflow"]) == float(want["sr_overflow"]) > 0
    _close_items(got, want, **LOSS_TOL)
    ts1 = _np_tree(ts1)
    for k, v in ts1.pt_train.items():
        np.testing.assert_allclose(port.pt_train[k].detach().numpy(), v,
                                   err_msg=k, rtol=1e-4, atol=1e-5)


def test_frustum_compute_grads_builds_the_camera_grid_once():
    """Under ray_chunk the frustum step builds its camera grid once, not
    once per chunk, and its gradients equal JAX's chunked step's."""
    opt, ts, spec_j, jb, st, spec_t, tb = _frustum_train_scene()
    opt = opt.replace(ray_chunk=8, SR_budget=16)
    key = jax.random.PRNGKey(3)
    want, jn, jp = jtr.compute_grads(ts, None, jb, key, opt, spec_j)
    R = tb["raydir"].shape[1]
    u = torch.cat([torch.tensor(np.asarray(jax.random.uniform(
        jax.random.fold_in(key, i), (1, 8, opt.SR)))) for i in range(R // 8)],
        dim=1)
    built = []
    orig = ttr.build_frustum_grid

    def count(*a, **k):
        built.append(1)
        return orig(*a, **k)
    ttr.build_frustum_grid = count
    try:
        items, g_net, g_pts = ttr.compute_grads(st, None, tb, _port_opt(opt),
                                                spec_t, u)
    finally:
        ttr.build_frustum_grid = orig
    assert len(built) == 1
    assert float(items["sr_overflow"]) == float(want["sr_overflow"]) > 0
    _close_items(items, want, **LOSS_TOL)
    _close_grads(g_net, g_pts, jn, jp, **GRAD_TOL)


def _serve_frustum(device=None, runner=None, item=None, opt=None, spec=None,
                   ts=None):
    try:
        tcommon.render_image(ts, None, opt, spec, item, group=1,
                             runner=runner)
    except ValueError as e:
        return str(e)
    return None


def test_frustum_mesh_serving_fails_in_both(tmp_path):
    """Mesh serving under the frustum query: JAX asserts (its per-camera
    grid rebuild is single-chip), the port's render_image on a runner
    raises ValueError before it renders."""
    opt, spec_j, spec_t, state, params, jb, agg, pts, tb = _render_setup()
    side = 4
    ii, jj = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    item = {"raydir": np.asarray(jb["raydir"])[:, :side * side],
            "campos": np.asarray(jb["campos"]),
            "camrotc2w": np.asarray(jb["camrotc2w"]),
            "near": jb["near"], "far": jb["far"],
            "bg_color": np.asarray(jb["bg_color"]),
            "pixel_idx": np.stack([jj.ravel(), ii.ravel()], -1)[None],
            "h": side, "w": side}
    opt = opt.replace(random_sample_size=2)
    jts = jtr.create_train_state(opt, jax.random.PRNGKey(2), state)
    with pytest.raises(AssertionError, match="frustum"):
        jcommon.render_image(jts, None, opt, spec_j, item, group=1,
                             mesh=jmake_mesh(2))
    msg = driver.launch(_serve_frustum, (), 1, 1, "cpu", str(tmp_path),
                        kwargs=dict(item=item, opt=_port_opt(opt),
                                    spec=spec_t,
                                    ts=ttr.ServeState(agg, pts)))
    assert msg is not None and "frustum" in msg
