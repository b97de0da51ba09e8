"""Train-step parity: the port's gradients, losses and Adam steps against
the JAX package's, from the same numpy inputs and the same jitter draws.

The scene is a lego-envelope variant of the tiny plane scene (superset
query, auto compaction budget, K-tier split, two-layer blocks) and the
sparse variant whose rows fill both tiers. JAX runs its Pallas trunk in
interpret mode (use_fused_trunk=1) or its XLA composition (0); the port its
fused trunk's plain versions or its unfused path; with fused_shade=1 JAX
runs its Pallas shade kernel in interpret mode and the port its fused
shade's plain versions. A few point confs lie
outside [1e-4, 1], where the conf clamp passes the gradient through.

Tolerances: gradients rtol 2e-4, atol 2e-5 (the bar tests/test_pallas_trunk.py
holds the Pallas trunk to); losses rtol 1e-5; gathers exactly. Over Adam
steps: losses rtol 1e-4; parameters rtol 1e-4, atol 1e-5 (a thousandth of
one step at lr 0.01); moments within a thousandth of each buffer's largest.
Adam divides each gradient by its running RMS, so an entry whose gradient
is near eps = 1e-8 turns a last-digit gradient difference into a visible
step difference; optax and torch also fold the bias correction and the
step size in another order.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointnerf_tpu.config import Options
from pointnerf_tpu.models import aggregator as jagg
from pointnerf_tpu.models import losses as jlosses
from pointnerf_tpu.models import renderer as jrend
from pointnerf_tpu.ops import grid as jgrid
from pointnerf_tpu.ops import query as jq
from pointnerf_tpu.train import trainer as jtr
from pointnerf_tpu_torch.models import aggregator as tagg
from pointnerf_tpu_torch.models import losses as tlosses
from pointnerf_tpu_torch.models import renderer as trend
from pointnerf_tpu_torch.models.networks import make_lr_schedule
from pointnerf_tpu_torch.ops import grid as tgrid
from pointnerf_tpu_torch.ops import kernels
from pointnerf_tpu_torch.ops import query as tq
from pointnerf_tpu_torch.ops import trunk as tt
from pointnerf_tpu_torch.train import trainer as ttr
from pointnerf_tpu_torch.utils.checkpoint import (_net_tensors,
                                                  from_jax_train_state)

from test_end_to_end import make_gt, tiny_setup
from test_k_tier import sparse_setup

GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
LOSS_TOL = dict(rtol=1e-5, atol=1e-7)
STEP_TOL = dict(rtol=1e-4, atol=1e-5)


def _np_tree(tree):
    return jax.tree.map(lambda x: None if x is None else np.asarray(x), tree,
                        is_leaf=lambda x: x is None)


def _uniform(key, B, R, D):
    return np.asarray(jax.random.uniform(key, (B, R, D), dtype=jnp.float32))


def _scene(scene="tiny", **kw):
    """(opt, JAX TrainState, JAX spec and grid, batch with gt) of the
    lego-like scene; some confs sit outside the clamp's [1e-4, 1]."""
    opt, state, _, _, batch, xyz = (tiny_setup(R_side=8) if scene == "tiny"
                                    else sparse_setup(R_side=10))
    opt = opt.replace(**dict(dict(superset_P=16, SR_budget=-1, k_tier=-1,
                                  shading_feature_mlp_layer1=2,
                                  shading_feature_mlp_layer3=2,
                                  occ_segments=-1, use_fused_trunk=1), **kw))
    n = len(xyz)
    conf = np.array(state["conf"])
    conf[:n:7] = 1.3
    conf[3:n:11] = 5e-5
    state = dict(state, conf=jnp.asarray(conf))
    spec = jgrid.make_grid_spec(opt, points_min=xyz.min(0),
                                points_max=xyz.max(0), max_points=n)
    grid = jgrid.build_grid(state["xyz"], state["mask"], spec)
    ts = jtr.create_train_state(opt, jax.random.PRNGKey(2), state)
    gt, _ = make_gt(batch)
    return opt, ts, spec, grid, dict(batch, gt_image=gt)


def _port(opt, ts, batch):
    """The JAX state carried across, its grid rebuilt by the port, and the
    batch as tensors."""
    st = from_jax_train_state(_np_tree(ts), opt, device="cpu")
    mask = st.points["mask"].numpy()
    xyz = st.points["xyz"].detach().numpy()[mask]
    spec = tgrid.make_grid_spec(opt, xyz.min(0), xyz.max(0), int(mask.sum()))
    grid = tgrid.build_grid(st.points["xyz"], st.points["mask"], spec)
    tb = {k: (torch.tensor(np.asarray(v)) if hasattr(v, "shape") else v)
          for k, v in batch.items()}
    return st, spec, grid, tb


def _close_grads(g_net, g_pts, jn, jp, **tol):
    want = _net_tensors(_np_tree(jn))
    assert set(g_net) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(g_net[k].numpy(), v, err_msg=k, **tol)
    assert set(g_pts) == set(jp)
    for k, v in jp.items():
        np.testing.assert_allclose(g_pts[k].numpy(), np.asarray(v),
                                   err_msg=k, **tol)


def _close_items(items, want, **tol):
    for k, v in want.items():
        np.testing.assert_allclose(float(items[k].detach()), float(v),
                                   err_msg=k, **tol)


def test_gradient_clamp_passes_gradient_through():
    """Clamp forward, identity backward, also outside [1e-4, 1]."""
    x = np.array([-0.5, 0.0, 5e-5, 1e-4, 0.3, 1.0, 1.7, 20.0], np.float32)
    c = np.linspace(-1.0, 2.0, x.size).astype(np.float32)
    fwd = jagg.gradient_clamp(jnp.asarray(x), 1e-4, 1.0)
    want = jax.grad(lambda v: jnp.sum(jagg.gradient_clamp(v, 1e-4, 1.0) * c))(
        jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    out = tagg.gradient_clamp(xt, 1e-4, 1.0)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(fwd))
    (got,) = torch.autograd.grad(torch.sum(out * torch.tensor(c)), xt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_expand_compacted_backward_is_the_compaction_gather():
    rng = np.random.RandomState(0)
    B, R, SR, C, Ncb = 2, 9, 4, 3, 20
    counts = rng.randint(0, SR + 1, (B, R)).astype(np.int32)
    comp_src, comp_valid, _ = jq.compact_row_map(jnp.asarray(counts), Ncb, SR)
    c = rng.normal(size=(B, Ncb, C)).astype(np.float32)
    ct = rng.normal(size=(B, R, SR, C)).astype(np.float32)
    out, vjp = jax.vjp(lambda v: jq.expand_compacted(
        SR, True, v, jnp.asarray(counts), comp_src, comp_valid),
        jnp.asarray(c))
    (want,) = vjp(jnp.asarray(ct))
    ctt = torch.tensor(c, requires_grad=True)
    got = tq.expand_compacted(SR, ctt, torch.tensor(counts),
                              torch.tensor(np.asarray(comp_src)),
                              torch.tensor(np.asarray(comp_valid)))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
    got.backward(torch.tensor(ct))
    assert np.asarray(comp_valid).sum() < B * Ncb       # some slots unused
    np.testing.assert_array_equal(ctt.grad.numpy(), np.asarray(want))


def test_tier_assemble_backward_is_gathers():
    rng = np.random.RandomState(1)
    BG, Ncb, NtB, C = 2, 24, 5, 3
    tier = rng.randint(0, 3, (BG, Ncb))             # 0: A, 1: B, 2: neither
    mA, mB = torch.tensor(tier == 0), torch.tensor(tier == 1)
    cumA = torch.cumsum(mA.int(), 1, dtype=torch.int32)
    cumB = torch.cumsum(mB.int(), 1, dtype=torch.int32)
    srcA, validA, _ = trend._tier_map(mA, cumA, Ncb)
    srcB, validB, over = trend._tier_map(mB, cumB, NtB)
    assert int(over) > 0                           # the wide budget drops rows
    rankA = torch.clamp(cumA - 1, 0, Ncb - 1)
    rankB = torch.clamp(cumB - 1, 0, NtB - 1)
    inB = mB & (cumB - 1 < NtB)
    ints = (mA, inB, rankA, rankB, srcA, validA, srcB, validB)
    vals = [rng.normal(size=s).astype(np.float32)
            for s in ((BG, Ncb, 1, C), (BG, NtB, 1, C), (BG, Ncb, 1, C))]
    ct = rng.normal(size=(BG, Ncb, 1, C)).astype(np.float32)
    jints = [jnp.asarray(t.numpy()) for t in ints]
    out, vjp = jax.vjp(lambda a, b, c: jrend._tier_assemble(a, b, c, *jints),
                       *map(jnp.asarray, vals))
    want = vjp(jnp.asarray(ct))
    tv = [torch.tensor(v, requires_grad=True) for v in vals]
    got = trend._tier_assemble(*tv, *ints)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
    got.backward(torch.tensor(ct))
    for t, w in zip(tv, want):
        np.testing.assert_array_equal(t.grad.numpy(), np.asarray(w))


def test_gather_neighbors_backward_is_the_scatter_add():
    """The packed attribute gather's backward equals the scatter-add that
    autograd makes of plain indexing, missing neighbors (row 0) included,
    and JAX's gradient of its gather."""
    from pointnerf_tpu.models import neural_points as jnpc
    from pointnerf_tpu_torch.models import neural_points as tnpc
    rng = np.random.RandomState(4)
    n, shape = 30, (1, 6, 5, 4)
    pidx = rng.randint(-1, n, shape).astype(np.int32)
    pidx[0, :3] = -1                                # long runs of row 0
    pidx[0, 3, :, 0] = 0
    cloud = dict(xyz=rng.uniform(-1, 1, (n, 3)),
                 embedding=rng.normal(size=(n, 8)),
                 color=rng.uniform(0, 1, (n, 3)),
                 direction=rng.normal(size=(n, 3)),
                 conf=rng.uniform(0, 1, (n, 1)))
    cot = {k: rng.normal(size=shape + (c,)).astype(np.float32)
           for k, c in (("sampled_embedding", 8), ("sampled_color", 3),
                        ("sampled_dir", 3), ("sampled_conf", 1))}
    trainable = ("embedding", "color", "dir", "conf")
    cam = (np.eye(3, dtype=np.float32)[None],
           np.array([[0.1, 0.2, -3.0]], np.float32))

    def jax_loss(tr, static):
        g = jnpc.gather_neighbors(dict(static, **tr), jnp.asarray(pidx),
                                  *map(jnp.asarray, cam))
        return sum(jnp.sum(g[k] * cot[k]) for k in cot)

    js = jnpc.create_point_cloud(cloud["xyz"], cloud["embedding"],
                                 cloud["color"], cloud["direction"],
                                 cloud["conf"], capacity=32)
    want = jax.grad(jax_loss)({k: js[k] for k in trainable},
                              {k: v for k, v in js.items()
                               if k not in trainable})
    ts = tnpc.create_point_cloud(**cloud, capacity=32, device="cpu")
    for k in trainable:
        ts[k].requires_grad_(True)
    g = tnpc.gather_neighbors(ts, torch.tensor(pidx),
                              *map(torch.tensor, cam))
    loss = sum(torch.sum(g[k] * torch.tensor(cot[k])) for k in cot)
    got = torch.autograd.grad(loss, [ts[k] for k in trainable])
    plain = torch.cat([ts[k] for k in ("xyz",) + trainable], dim=1)[
        torch.tensor(pidx).clamp(min=0).reshape(-1).long()]
    cols = np.cumsum([3, 8, 3, 3, 1])
    ref = torch.autograd.grad(sum(
        torch.sum(plain[:, a:b].reshape(shape + (b - a,))
                  * torch.tensor(cot[k]))
        for k, a, b in zip(cot, cols[:-1], cols[1:])),
        [ts[k] for k in trainable])
    for k, a, b, c in zip(trainable, got, ref, (want[k] for k in trainable)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6, msg=k)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    assert float(got[0][0].abs().sum()) > 0


@pytest.mark.parametrize("compact", [True, False])
def test_compute_losses_matches_jax(compact):
    """Every loss family on one output dict: items and the gradients of the
    total with respect to the differentiable outputs."""
    rng = np.random.RandomState(2)
    R, Ncb, K, SR = 12, 10, 4, 3
    opt = Options(color_loss_items=("ray_masked_coarse_raycolor",
                                    "ray_miss_coarse_raycolor",
                                    "coarse_raycolor"),
                  color_loss_weights=(1.0, 0.3, 0.2),
                  depth_loss_items=("coarse_depth",), depth_loss_weights=(0.5,),
                  bg_loss_items=("coarse_is_background",),
                  bg_loss_weights=(0.7,),
                  zero_one_loss_items=("conf_coefficient",),
                  zero_one_loss_weights=(0.01,),
                  l2_size_loss_items=("coarse_raycolor",),
                  l2_size_loss_weights=(0.1,), sparse_loss_weight=0.05)
    out = {"coarse_raycolor": rng.uniform(0, 1, (1, R, 3)),
           "ray_mask": rng.rand(1, R) < 0.6,
           "coarse_depth": rng.uniform(2, 4, (1, R)),
           "coarse_is_background": rng.uniform(0, 1, (1, R, 1))}
    if compact:
        out.update(conf_compact=rng.uniform(-0.1, 1.2, (1, Ncb, 1, K)),
                   weight_compact=rng.uniform(0, 2, (1, Ncb, 1, K)),
                   compact_valid=rng.rand(1, Ncb, 1, 1) < 0.7,
                   zero_one_total=np.int32(R * SR * K))
        diff = ("coarse_raycolor", "coarse_depth", "coarse_is_background",
                "conf_compact")
    else:
        out.update(conf_coefficient=rng.uniform(-0.1, 1.2, (1, R, SR, K)),
                   weight=rng.uniform(0, 2, (1, R, SR, K)))
        diff = ("coarse_raycolor", "coarse_depth", "coarse_is_background",
                "conf_coefficient")
    out = {k: (v.astype(np.float32) if v.dtype == np.float64 else v)
           for k, v in out.items()}
    gt = rng.uniform(0, 1, (1, R, 3)).astype(np.float32)
    gt_mask = rng.rand(1, R) < 0.5
    gt_depth = rng.uniform(2, 4, (1, R)).astype(np.float32)

    def jax_total(*xs):
        o = dict({k: jnp.asarray(v) for k, v in out.items()}, **dict(zip(diff,
                                                                      xs)))
        return jlosses.compute_losses(opt, o, jnp.asarray(gt),
                                      jnp.asarray(gt_mask),
                                      jnp.asarray(gt_depth))

    (_, want), jgrads = jax.value_and_grad(
        jax_total, argnums=tuple(range(len(diff))), has_aux=True)(
            *(jnp.asarray(out[k]) for k in diff))
    to = {k: torch.tensor(v) for k, v in out.items()}
    for k in diff:
        to[k].requires_grad_(True)
    total, items = tlosses.compute_losses(opt, to, torch.tensor(gt),
                                          torch.tensor(gt_mask),
                                          torch.tensor(gt_depth))
    assert set(items) == set(want)
    _close_items(items, want, **LOSS_TOL)
    got = torch.autograd.grad(total, [to[k] for k in diff])
    for k, a, b in zip(diff, got, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=k,
                                   rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(float(tlosses.mse2psnr(0.01)),
                               float(jlosses.mse2psnr(0.01)), rtol=1e-6)


def test_lr_schedules_match_jax():
    from pointnerf_tpu.models.networks import make_lr_schedule as jsched
    for kw in (dict(lr_policy="iter_exponential_decay", lr_decay_iters=1000,
                    lr_decay_exp=0.1),
               dict(lr_policy="lambda", niter=5, niter_decay=20),
               dict(lr_policy="step", lr_decay_iters=70),
               dict(lr_policy="plateau")):
        opt = Options(**kw)
        for step in (0, 3, 17, 250):
            np.testing.assert_allclose(
                make_lr_schedule(opt, 0.002)(step),
                float(jsched(opt, 0.002)(jnp.int32(step))), rtol=1e-7,
                err_msg=str(kw))


@pytest.mark.parametrize("scene", ["tiny", "sparse"])
@pytest.mark.parametrize("fused,shade", [
    pytest.param(1, 0, id="1"), pytest.param(0, 0, id="0"),
    pytest.param(1, 1, id="shade")])
def test_compute_grads_matches_jax(scene, fused, shade, monkeypatch):
    """shade=1: the fused_shade configuration, JAX's Pallas shade kernel
    (interpret) against the port's fused_shade plain versions, which must
    run (forward and backward) and launch nothing."""
    opt, ts, spec, grid, batch = _scene(scene, use_fused_trunk=fused,
                                        fused_shade=shade)
    key = jax.random.PRNGKey(5)
    want, jn, jp = jtr.compute_grads(ts, grid, batch, key, opt, spec)
    calls = {}
    for name in ("fused_shade_reference", "fused_shade_bwd_reference"):
        plain = getattr(tt, name)
        monkeypatch.setattr(tt, name, lambda *a, _n=name, _f=plain: (
            calls.__setitem__(_n, calls.get(_n, 0) + 1) or _f(*a)))
    st, spec_t, grid_t, tb = _port(opt, ts, batch)
    B, R = batch["raydir"].shape[:2]
    u = torch.tensor(_uniform(key, B, R, opt.z_depth_dim))
    items, g_net, g_pts = ttr.compute_grads(st, grid_t, tb, opt, spec_t, u)
    assert float(want["sr_overflow"]) > 0          # the auto budget drops rows
    assert set(items) == set(want)
    np.testing.assert_array_equal(float(items["sr_overflow"]),
                                  float(want["sr_overflow"]))
    _close_items(items, want, **LOSS_TOL)
    _close_grads(g_net, g_pts, jn, jp, **GRAD_TOL)
    conf = st.points["conf"].detach().numpy()[:, 0]
    out_of_range = (conf > 1.0) | (conf < 1e-4)
    assert np.abs(g_pts["conf"].numpy()[out_of_range]).max() > 0
    assert len(calls) == (2 if shade else 0)
    assert not any(k.launches for k in kernels.KERNELS)


def test_depth_bg_losses_and_bg_ray_match_jax():
    """The render's coarse_depth and bg_ray composition through the depth
    and background losses: items and every gradient."""
    opt, ts, spec, grid, batch = _scene(
        compute_depth=1, depth_loss_items=("coarse_depth",),
        depth_loss_weights=(0.1,), bg_loss_items=("coarse_is_background",),
        bg_loss_weights=(0.2,))
    rng = np.random.RandomState(6)
    _, inside = make_gt(batch)
    R = batch["raydir"].shape[1]
    batch = dict(batch, gt_mask=jnp.asarray(inside[None]),
                 gt_depth=jnp.asarray(rng.uniform(2.5, 3.5, (1, R)),
                                      jnp.float32),
                 bg_ray=jnp.asarray(rng.uniform(0, 1, (1, R, 3)),
                                    jnp.float32))
    key = jax.random.PRNGKey(8)
    want, jn, jp = jtr.compute_grads(ts, grid, batch, key, opt, spec)
    st, spec_t, grid_t, tb = _port(opt, ts, batch)
    u = torch.tensor(_uniform(key, 1, R, opt.z_depth_dim))
    items, g_net, g_pts = ttr.compute_grads(st, grid_t, tb, opt, spec_t, u)
    assert {"loss_coarse_depth", "loss_coarse_is_background"} <= set(items)
    _close_items(items, want, **LOSS_TOL)
    _close_grads(g_net, g_pts, jn, jp, **GRAD_TOL)


@pytest.mark.parametrize("alter_step", [0, 1])
def test_train_steps_match_jax(alter_step):
    """Three steps from one state: loss items each step, then every weight,
    point buffer and Adam moment; alter_step=1 alternates net and points."""
    opt, ts, spec, grid, batch = _scene(alter_step=alter_step)
    st, spec_t, grid_t, tb = _port(opt, ts, batch)
    key = jax.random.PRNGKey(9)
    B, R = batch["raydir"].shape[:2]
    for step in range(3):
        u = _uniform(jax.random.fold_in(key, step), B, R, opt.z_depth_dim)
        ts, want = jtr.train_step(ts, grid, batch, key, opt, spec)
        st, items = ttr.train_step(st, grid_t, tb, opt, spec_t,
                                   u=torch.tensor(u))
        _close_items(items, want, rtol=1e-4, atol=1e-7)
    assert st.step == int(ts.step) == 3
    jstate = _np_tree(ts)
    for k, v in _net_tensors(jstate.agg_params).items():
        np.testing.assert_allclose(
            dict(st.aggregator.named_parameters())[k].detach().numpy(), v,
            err_msg=k, **STEP_TOL)
    for k, v in jstate.pt_train.items():
        np.testing.assert_allclose(st.pt_train[k].detach().numpy(), v,
                                   err_msg=k, **STEP_TOL)
    # the moments, carried across from JAX, match the port's own
    again = from_jax_train_state(jstate, opt, device="cpu")
    for mine, theirs in ((st.opt_pts, again.opt_pts),
                         (st.opt_net, again.opt_net)):
        for p, q in zip(mine.param_groups[0]["params"],
                        theirs.param_groups[0]["params"]):
            for name in ("exp_avg", "exp_avg_sq"):
                want = theirs.state[q][name].numpy()
                np.testing.assert_allclose(
                    mine.state[p][name].numpy(), want, rtol=0,
                    atol=1e-3 * np.abs(want).max())
            assert int(mine.state[p]["step"]) == int(theirs.state[q]["step"])


def test_ray_chunk_matches_unchunked_and_jax():
    """ray_chunk renders the rays in chunks inside one loss: equal to the
    unchunked render at budgets that drop no row, and to JAX's chunked
    step (whose chunk i draws its jitter from fold_in(key, i))."""
    opt, ts, spec, grid, batch = _scene(SR_budget=64 * 8 - 8,
                                        k_tier_wide_frac=1.0)
    st, spec_t, grid_t, tb = _port(opt, ts, batch)
    B, R, D = 1, 64, opt.z_depth_dim
    key = jax.random.PRNGKey(4)
    C = 16
    u = np.concatenate([_uniform(jax.random.fold_in(key, i), B, C, D)
                        for i in range(R // C)], axis=1)
    chunked = opt.replace(ray_chunk=C)
    want, jn, jp = jtr.compute_grads(ts, grid, batch, key, chunked, spec)
    got = ttr.compute_grads(st, grid_t, tb, chunked, spec_t, torch.tensor(u))
    _close_items(got[0], want, **LOSS_TOL)
    _close_grads(got[1], got[2], jn, jp, **GRAD_TOL)
    whole = ttr.compute_grads(st, grid_t, tb, opt, spec_t, torch.tensor(u))
    assert float(whole[0]["sr_overflow"]) == float(got[0]["sr_overflow"]) == 0
    _close_items(whole[0], got[0], **LOSS_TOL)
    for a, b in zip((*whole[1].values(), *whole[2].values()),
                    (*got[1].values(), *got[2].values())):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-8)


def test_remat_gives_the_same_gradients():
    opt, ts, spec, grid, batch = _scene()
    st, spec_t, grid_t, tb = _port(opt, ts, batch)
    u = torch.rand((1, 64, opt.z_depth_dim),
                   generator=torch.Generator().manual_seed(0))
    plain = ttr.compute_grads(st, grid_t, tb, opt, spec_t, u)
    remat = ttr.compute_grads(st, grid_t, tb, opt.replace(remat=1), spec_t, u)
    for a, b in zip((*plain[1].values(), *plain[2].values()),
                    (*remat[1].values(), *remat[2].values())):
        assert torch.equal(a, b)


@pytest.mark.parametrize("packed", [1, 0])
def test_resume_from_jax_train_state(packed):
    """A JAX state one step in, in either point-moment layout, carries
    across: moments by buffer, counts, step; then both take one more step
    to the same parameters. A packed moment whose width does not match the
    trainable buffers is refused."""
    opt, ts, spec, grid, batch = _scene(packed_point_adam=packed)
    key = jax.random.PRNGKey(3)
    ts, _ = jtr.train_step(ts, grid, batch, key, opt, spec)
    jstate = _np_tree(ts)
    st, spec_t, grid_t, tb = _port(opt, ts, batch)
    mu = jstate.opt_state_pts[0].mu
    keys = sorted(jstate.pt_train)
    cols = np.cumsum([0] + [jstate.pt_train[k].shape[1] for k in keys])
    for p, k in zip(st.opt_pts.param_groups[0]["params"], st.pt_train):
        want = (mu[k] if isinstance(mu, dict)
                else mu[:, cols[keys.index(k)]:cols[keys.index(k) + 1]])
        np.testing.assert_array_equal(st.opt_pts.state[p]["exp_avg"].numpy(),
                                      want)
        assert int(st.opt_pts.state[p]["step"]) == 1
    assert st.step == 1
    u = _uniform(jax.random.fold_in(key, 1), 1, 64, opt.z_depth_dim)
    ts, want = jtr.train_step(ts, grid, batch, key, opt, spec)
    st, items = ttr.train_step(st, grid_t, tb, opt, spec_t, u=torch.tensor(u))
    _close_items(items, want, rtol=1e-4, atol=1e-7)
    for k, v in _np_tree(ts).pt_train.items():
        np.testing.assert_allclose(st.pt_train[k].detach().numpy(), v,
                                   err_msg=k, **STEP_TOL)
    if packed:
        bad = jstate._replace(pt_train={k: v for k, v in
                                        jstate.pt_train.items()
                                        if k != "dir"},
                              pt_static=dict(jstate.pt_static,
                                             dir=jstate.pt_train["dir"]))
        with pytest.raises(ValueError, match="packed point moments"):
            from_jax_train_state(bad, opt.replace(dir_grad=0), device="cpu")
