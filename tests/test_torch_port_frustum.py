"""Frustum querier parity: the port's `ops/frustum.py` and the renderer's
wcoord_query 0 branch against the JAX package's, one case for each case of
tests/test_frustum.py (scenes from its numpy generators).

Tolerances: integer outputs (grid tables, neighbor indices, masks,
q_overflow) exactly; positions and directions rtol = atol = 1e-5;
aggregator gradients rtol 2e-4, atol 2e-5. The random draws (the
shpnt_jitter draws, the NN 0 priorities) are JAX's, injected.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointnerf_tpu.models import neural_points as jnpc
from pointnerf_tpu.models.aggregator import init_aggregator_params
from pointnerf_tpu.models.renderer import render_forward as jrender_forward
from pointnerf_tpu.ops import frustum as jf
from pointnerf_tpu_torch.config import Options as TOptions
from pointnerf_tpu_torch.models.renderer import render_forward, render_query
from pointnerf_tpu_torch.models.renderer import render_shade
from pointnerf_tpu_torch.ops import frustum as tf
from pointnerf_tpu_torch.utils.checkpoint import from_jax_params

from test_frustum import (FAR, H, NEAR, W, frustum_opt, intrinsic,
                          make_scene, pixel_rays)

TOL = dict(rtol=1e-5, atol=1e-5)
GTOL = dict(rtol=2e-4, atol=2e-5)


def _port_opt(opt):
    return TOptions.from_json(opt.to_json())


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _setup(opt, n=150, seed=0):
    spec_j = jf.make_frustum_spec(opt, intrinsic(), W, H, NEAR, FAR)
    spec_t = tf.make_frustum_spec(_port_opt(opt), intrinsic(), W, H, NEAR,
                                  FAR)
    xyz, camrot, campos = make_scene(n=n, seed=seed)
    gj, pj = jf.build_frustum_grid(jnp.asarray(xyz), jnp.ones(n, bool),
                                   jnp.asarray(camrot), jnp.asarray(campos),
                                   spec_j)
    gt, pt = tf.build_frustum_grid(_t(xyz), torch.ones(n, dtype=torch.bool),
                                   _t(camrot), _t(campos), spec_t)
    return spec_j, spec_t, (gj, pj), (gt, pt), camrot, campos


def _query(opt, spec_j, spec_t, jg, tg, camrot, campos, raydir, j_kw=None,
           t_kw=None):
    want = jf.query_frustum_points(
        jnp.asarray(raydir), jnp.asarray(camrot), jnp.asarray(campos), jg[1],
        jg[0], spec_j, SR=opt.SR, K=opt.K, **(j_kw or {}))
    got = tf.query_frustum_points(
        _t(raydir), _t(camrot), _t(campos), tg[1], tg[0], spec_t, SR=opt.SR,
        K=opt.K, **(t_kw or {}))
    return want, got


def _same_query(want, got, floats=TOL):
    if want[0] is None:
        assert got[0] is None
    else:
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **floats)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), **floats)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert int(got[4]) == int(want[4])
    if want[5] is not None:
        for a, b in zip(got[5], want[5]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("kw", [
    pytest.param(dict(), id="plain"),
    pytest.param(dict(inverse=1, K=4), id="inverse"),
    pytest.param(dict(frustum_superset_P=64, depth_limit_scale=1.5),
                 id="superset"),
    pytest.param(dict(radius_limit_scale=2.0, depth_limit_scale=1.3,
                      vscale=(2, 2, 1)), id="caps")])
def test_frustum_spec_matches_jax(kw):
    opt = frustum_opt(**kw)
    assert tf.make_frustum_spec(_port_opt(opt), intrinsic(), W, H, NEAR,
                                FAR).__dict__ == jf.make_frustum_spec(
        opt, intrinsic(), W, H, NEAR, FAR).__dict__


def test_pers2w_and_pers_points_match_jax():
    """ops/camera.pers2w and ops/frustum.pers_points (a rotated, shifted
    camera, points in front and behind) equal JAX's bit for bit."""
    from pointnerf_tpu.ops.camera import pers2w as jpers2w
    from pointnerf_tpu_torch.ops.camera import pers2w
    rng = np.random.RandomState(0)
    rot = np.linalg.qr(rng.normal(size=(3, 3)))[0][None].astype(np.float32)
    campos = rng.normal(size=(1, 3)).astype(np.float32)
    p = rng.normal(size=(1, 40, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        pers2w(_t(p), _t(rot), _t(campos)).numpy(),
        np.asarray(jax.jit(jpers2w)(p, rot, campos)))
    xyz = (rng.normal(size=(500, 3)) * 2).astype(np.float32)
    np.testing.assert_array_equal(
        tf.pers_points(_t(xyz), _t(rot), _t(campos)).numpy(),
        np.asarray(jax.jit(jf.pers_points)(xyz, rot, campos)))


@pytest.mark.parametrize("kw", [
    pytest.param(dict(), id="plain"),
    pytest.param(dict(inverse=1), id="inverse"),
    pytest.param(dict(frustum_superset_P=64), id="superset")])
def test_frustum_grid_matches_jax(kw):
    """xyz_pers and every grid table bit for bit, points behind the camera
    parked at SENTINEL."""
    opt = frustum_opt(**kw)
    _, _, (gj, pj), (gt, pt), _, _ = _setup(opt, n=200, seed=3)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    assert set(gt) == set(gj)
    for k in gj:
        np.testing.assert_array_equal(gt[k].numpy(), np.asarray(gj[k]),
                                      err_msg=k)
    xyz = np.array([[0.0, 0.0, -1.0], [0.1, 0.2, 2.0]], np.float32)
    p = tf.pers_points(_t(xyz), torch.eye(3), torch.zeros(3)).numpy()
    assert (p[0] == tf.SENTINEL).all() and p[1, 2] == 2.0


@pytest.mark.parametrize("kw", [
    pytest.param(dict(), id="plain"),
    pytest.param(dict(inverse=1, K=4), id="inverse"),
    pytest.param(dict(radius_limit_scale=1.5, depth_limit_scale=1.5),
                 id="caps"),
    pytest.param(dict(vscale=(2, 2, 1), P=8, z_depth_dim=16), id="vscale")])
def test_frustum_query_matches_jax(kw):
    """Indices, world positions, per-sample directions, ray masks."""
    opt = frustum_opt(**kw)
    spec_j, spec_t, jg, tg, camrot, campos = _setup(opt, n=180, seed=3)
    pixels = np.random.RandomState(1).randint(0, W, (20, 2)).astype(float)
    want, got = _query(opt, spec_j, spec_t, jg, tg, camrot, campos,
                       pixel_rays(pixels))
    _same_query(want, got)
    assert (got[0] >= 0).any()


def test_frustum_depth_limit_matches_jax():
    """The z cap drops a same-column point two z voxels away (reference
    :476), as JAX's test sets it up."""
    opt = frustum_opt(depth_limit_scale=1.0, SR=4, K=3)
    spec_j = jf.make_frustum_spec(opt, intrinsic(), W, H, NEAR, FAR)
    spec_t = tf.make_frustum_spec(_port_opt(opt), intrinsic(), W, H, NEAR,
                                  FAR)
    z = np.array([1.375, 1.625, 1.875], np.float32)
    xyz = np.stack([0.1 * z, 0.1 * z, z], -1).astype(np.float32)
    camrot = np.eye(3, dtype=np.float32)[None]
    campos = np.zeros((1, 3), np.float32)
    jg = jf.build_frustum_grid(jnp.asarray(xyz), jnp.ones(3, bool),
                               jnp.asarray(camrot), jnp.asarray(campos),
                               spec_j)
    tg = tf.build_frustum_grid(_t(xyz), torch.ones(3, dtype=torch.bool),
                               _t(camrot), _t(campos), spec_t)
    raydir = np.array([[[0.1, 0.1, 1.0]]], np.float32)
    raydir /= np.linalg.norm(raydir, axis=-1, keepdims=True)
    want, got = _query(opt, spec_j, spec_t, jg, tg, camrot, campos, raydir)
    _same_query(want, got)
    first = set(int(i) for i in got[0][0, 0, 0] if i >= 0)
    assert 0 in first and 2 not in first


@pytest.mark.parametrize("mode", ["uniform", "gaussian"])
def test_frustum_jitter_matches_jax(mode):
    """shpnt_jitter with JAX's draws injected: positions and directions
    equal JAX's; z moves by at most half an unscaled z voxel, xy not at
    all."""
    opt = frustum_opt(shpnt_jitter=mode)
    spec_j, spec_t, jg, tg, camrot, campos = _setup(opt)
    pixels = np.stack([np.arange(10), np.arange(10)], -1).astype(float)
    raydir = pixel_rays(pixels)
    key = jax.random.PRNGKey(3)
    shape = (1, 10, opt.SR)
    u = jax.random.uniform(key, shape) if mode == "uniform" else \
        jax.random.normal(key, shape)
    want, got = _query(opt, spec_j, spec_t, jg, tg, camrot, campos, raydir,
                       dict(jitter=mode, key=key, is_train=True),
                       dict(jitter=mode, u=_t(u), is_train=True))
    _same_query(want, got)
    _, base = _query(opt, spec_j, spec_t, jg, tg, camrot, campos, raydir)
    zb, zj = base[1][..., 2].numpy(), got[1][..., 2].numpy()
    on = np.abs(zb) > 1e-3
    assert 1e-6 < np.abs(zj - zb)[on].max() <= spec_t.vsize[2] / 2 + 1e-5


def test_frustum_superset_matches_jax_and_exact():
    """frustum_superset_P with the pers-metric depth cap against JAX's
    superset query; on occupied-voxel samples the superset sets equal the
    exact scan's (the world-coordinate superset's contract)."""
    xyz, _, _ = make_scene(n=200, seed=3)
    pixels = np.random.RandomState(5).randint(0, W, (40, 2)).astype(float)
    raydir = pixel_rays(pixels)
    got = {}
    for p2 in (0, 128):
        opt = frustum_opt(frustum_superset_P=p2, depth_limit_scale=1.5)
        spec_j, spec_t, jg, tg, camrot, campos = _setup(opt, n=200, seed=3)
        want, got[p2] = _query(opt, spec_j, spec_t, jg, tg, camrot, campos,
                               raydir)
        _same_query(want, got[p2])
    np.testing.assert_array_equal(got[0][3].numpy(), got[128][3].numpy())
    # samples in occupied voxels: the same neighbor sets
    opt = frustum_opt()
    spec_t = tf.make_frustum_spec(_port_opt(opt), intrinsic(), W, H, NEAR,
                                  FAR)
    _, _, _, (grid, _), camrot, campos = _setup(opt, n=200, seed=3)
    loc = tf.pers_points(got[0][1].reshape(-1, 3), _t(camrot), _t(campos))
    vox = torch.floor((loc - torch.tensor(spec_t.ranges_min))
                      / torch.tensor(spec_t.scaled_vsize)).long()
    vd = spec_t.vdim
    lin = (vox[:, 0] * vd[1] + vox[:, 1]) * vd[2] + vox[:, 2]
    inb = ((vox >= 0) & (vox < torch.tensor(vd))).all(-1)
    occupied = inb & (grid["coor_2_occ"][lin.clamp(0, spec_t.grid_size_vol
                                                   - 1)] >= 0)
    pid_e, pid_s = got[0][0].reshape(-1, 3), got[128][0].reshape(-1, 3)
    rows = [r for r in range(len(pid_e))
            if occupied[r] and (pid_e[r] >= 0).any()]
    assert len(rows) > 10
    for r in rows:
        assert set(pid_e[r].tolist()) == set(pid_s[r].tolist()), r


def test_frustum_compaction_matches_jax_and_uncompacted():
    """Nc below the row count engages the pre-KNN compaction: comp equals
    JAX's, and c_pidx reproduces the uncompacted indices at the mapped
    rows with q_overflow 0; a budget below the valid rows counts them."""
    opt = frustum_opt()
    spec_j, spec_t, jg, tg, camrot, campos = _setup(opt)
    pixels = np.random.RandomState(3).randint(0, W, (24, 2)).astype(float)
    raydir = pixel_rays(pixels)
    R, SR = 24, opt.SR
    _, full = _query(opt, spec_j, spec_t, jg, tg, camrot, campos, raydir)
    for Nc in (R * SR - 1, 17):
        want, got = _query(opt, spec_j, spec_t, jg, tg, camrot, campos,
                           raydir, dict(Nc=Nc), dict(Nc=Nc))
        _same_query(want, got)
    want, got = _query(opt, spec_j, spec_t, jg, tg, camrot, campos, raydir,
                       dict(Nc=R * SR - 1), dict(Nc=R * SR - 1))
    assert got[0] is None and int(got[4]) == 0
    comp_src, comp_valid, c_pidx = got[5][:3]
    fp = full[0].reshape(R * SR, opt.K)
    for s in range(comp_src.shape[1]):
        if comp_valid[0, s]:
            np.testing.assert_array_equal(c_pidx[0, s].numpy(),
                                          fp[comp_src[0, s]].numpy())
    np.testing.assert_array_equal(got[3].numpy(), full[3].numpy())


@pytest.mark.parametrize("Nc", [0, 50])
def test_frustum_rand_mode_matches_jax(Nc):
    """NN 0 (reference query_rand_along_ray): with JAX's priorities
    (uniform(fold_in(key, 7)) over the window's candidates) injected, the
    neighbor picks equal JAX's exactly; without them the port draws its
    own, a subset of the window's valid candidates with no repeats."""
    opt = frustum_opt(NN=0, wcoord_query=0)
    spec_j, spec_t, jg, tg, camrot, campos = _setup(opt, n=220, seed=3)
    pixels = np.random.RandomState(2).randint(0, W, (16, 2)).astype(float)
    raydir = pixel_rays(pixels)
    key = jax.random.PRNGKey(0)
    rows = (1, -(-Nc // 1), 1) if Nc else (1, 16, opt.SR)
    pri = jax.random.uniform(jax.random.fold_in(key, 7),
                             rows + (27 * spec_j.P,))
    want, got = _query(opt, spec_j, spec_t, jg, tg, camrot, campos, raydir,
                       dict(key=key, rand_mode=True, Nc=Nc),
                       dict(rand_mode=True, priorities=_t(pri), Nc=Nc))
    _same_query(want, got)
    _, exact = _query(opt, spec_j, spec_t, jg, tg, camrot, campos, raydir,
                      t_kw=dict(Nc=Nc))
    _, own = _query(opt, spec_j, spec_t, jg, tg, camrot, campos, raydir,
                    t_kw=dict(rand_mode=True, Nc=Nc,
                              generator=torch.Generator().manual_seed(9)))
    idx = own[0] if own[0] is not None else own[5][2]
    ex = exact[0] if exact[0] is not None else exact[5][2]
    idx, ex = idx.reshape(-1, opt.K), ex.reshape(-1, opt.K)
    for a, b in zip(idx.tolist(), ex.tolist()):
        a = [i for i in a if i >= 0]
        assert len(a) == len(set(a))
        assert (len(a) > 0) == any(i >= 0 for i in b)


def _render_setup(n=200, seed=2, **kw):
    opt = frustum_opt(
        wcoord_query=0, point_features_dim=8, shading_feature_num=16,
        shading_feature_mlp_layer1=1, shading_feature_mlp_layer3=1,
        num_feat_freqs=0, dist_xyz_freq=2, agg_intrp_order=2,
        num_viewdir_freqs=2, z_depth_dim=8, SR=4, K=3,
        which_ray_generation="near_far_linear", near_plane=NEAR,
        far_plane=FAR).replace(**kw)
    spec_j = jf.make_frustum_spec(opt, intrinsic(), W, H, NEAR, FAR)
    spec_t = tf.make_frustum_spec(_port_opt(opt), intrinsic(), W, H, NEAR,
                                  FAR)
    xyz, camrot, campos = make_scene(n=n)
    rng = np.random.RandomState(seed)
    state = jnpc.create_point_cloud(
        xyz, rng.rand(n, 8).astype(np.float32) - 0.5,
        color=rng.rand(n, 3).astype(np.float32),
        direction=np.tile(np.array([0, 0, 1], np.float32), (n, 1)),
        conf=np.ones((n, 1), np.float32))
    pixels = rng.randint(0, W, (24, 2)).astype(float)
    batch = {"raydir": pixel_rays(pixels), "campos": campos,
             "camrotc2w": camrot, "near": NEAR, "far": FAR,
             "bg_color": np.ones((1, 3), np.float32)}
    params = init_aggregator_params(jax.random.PRNGKey(0), opt)
    agg, pts = from_jax_params(
        jax.tree.map(np.asarray, params),
        {k: (None if v is None else np.asarray(v)) for k, v in state.items()},
        device="cpu")
    jb = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
          for k, v in batch.items()}
    tb = {k: (_t(v) if isinstance(v, np.ndarray) else v)
          for k, v in batch.items()}
    return opt, spec_j, spec_t, state, params, jb, agg, pts, tb


@pytest.mark.parametrize("kw", [
    pytest.param(dict(), id="eval"),
    pytest.param(dict(SR_budget=40, k_tier=1), id="budget"),
    pytest.param(dict(agg_intrp_order=1), id="order1")])
def test_frustum_render_forward_matches_jax(kw):
    """wcoord_query 0 through render_forward at eval: the image, ray mask,
    opacity and counters equal JAX's (the samples' own directions feed the
    aggregator)."""
    opt, spec_j, spec_t, state, params, jb, agg, pts, tb = \
        _render_setup(**kw)
    want = jrender_forward(params, state, None, spec_j, opt, jb, key=None,
                           is_train=False)
    with torch.no_grad():
        got = render_forward(agg, pts, None, spec_t, _port_opt(opt), tb)
    for k in ("coarse_raycolor", "coarse_point_opacity", "conf_coefficient"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)
    np.testing.assert_array_equal(got["ray_mask"].numpy(),
                                  np.asarray(want["ray_mask"]))
    assert int(got["sr_overflow"]) == int(want["sr_overflow"])
    assert "occ_overflow" not in got
    assert got["ray_mask"].any()


def test_frustum_render_train_grads_match_jax():
    """The train render (uniform shpnt_jitter with JAX's draws): the color
    sum and the aggregator's gradients equal JAX's value_and_grad."""
    opt, spec_j, spec_t, state, params, jb, agg, pts, tb = \
        _render_setup(shpnt_jitter="uniform")
    key = jax.random.PRNGKey(1)

    def f(p):
        out = jrender_forward(p, state, None, spec_j, opt, jb, key,
                              is_train=True)
        return jnp.sum(out["coarse_raycolor"])

    val, grads = jax.value_and_grad(f)(params)
    u = _t(jax.random.uniform(key, (1, 24, opt.SR)))
    topt = _port_opt(opt)
    with torch.no_grad():
        q = render_query(pts, None, spec_t, topt, tb, is_train=True, u=u)
    out = render_shade(agg, pts, spec_t, topt, tb, q)
    total = out["coarse_raycolor"].sum()
    np.testing.assert_allclose(float(total), float(val), **TOL)
    names = dict(agg.named_parameters())
    g = torch.autograd.grad(total, list(names.values()))
    for (name, gt_), branch in zip(names.items(), g):
        b, pos, kind = name.split(".")
        want = np.asarray(grads[b][int(pos) // 2]["w" if kind == "weight"
                                                  else "b"])
        want = want.T if kind == "weight" else want
        np.testing.assert_allclose(branch.numpy(), want, err_msg=name,
                                   **GTOL)
    with pytest.raises(ValueError, match="shpnt_jitter"):
        render_query(pts, None, spec_t, topt, tb, is_train=True)


def test_frustum_prebuilt_grid_matches_per_call():
    """render_image's fast path: a camera grid built once (a dict holding
    xyz_pers) renders exactly what the per-call build renders, and JAX's
    prebuilt path."""
    opt, spec_j, spec_t, state, params, jb, agg, pts, tb = _render_setup(
        n=150, seed=5)
    with torch.no_grad():
        per_call = render_forward(agg, pts, None, spec_t, _port_opt(opt), tb)
        fgrid, xyz_pers = tf.build_frustum_grid(
            pts["xyz"], pts["mask"], tb["camrotc2w"], tb["campos"], spec_t)
        fast = render_forward(agg, pts, dict(fgrid, xyz_pers=xyz_pers),
                              spec_t, _port_opt(opt), tb)
    for k in ("coarse_raycolor", "ray_mask"):
        np.testing.assert_array_equal(fast[k].numpy(), per_call[k].numpy())
    jg, jp = jf.build_frustum_grid(state["xyz"], state["mask"],
                                   jb["camrotc2w"], jb["campos"], spec_j)
    want = jrender_forward(params, state, dict(jg, xyz_pers=jp), spec_j, opt,
                           jb, key=None, is_train=False)
    np.testing.assert_allclose(fast["coarse_raycolor"].numpy(),
                               np.asarray(want["coarse_raycolor"]), **TOL)
