"""The NN < 0 vox-grid querier, the pickled surface cloud and the fixed
distance kernels against the JAX package.

The lattice (`construct_grid_points`, `derive_lattice`), the corner table
and the 8-corner query are integers and must equal JAX's exactly; the JAX
functions run under `jax.jit`, as its grid build and train step run them
(inside jit XLA:CPU divides by the pitch as a multiply by its reciprocal).
`load_blender_cloud` and `apply_point_noise` are bit-equal from one seed.
The fixed distance kernels are held at forward 1e-5 and gradients rtol
2e-4, atol 2e-5; a train step under NN -1 at the same bars; the drivers
(JAX's tests/test_voxgrid.py run) within 1.5 dB of JAX's PSNR, their
randomness being another; test_ft on either package's checkpoint at 1e-5.
"""

import dataclasses
import os
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointnerf_tpu.config import Options as JOptions
from pointnerf_tpu.data import create_dataset as jcreate
from pointnerf_tpu.data import load_blender as jlb
from pointnerf_tpu.models import aggregator as jagg
from pointnerf_tpu.models import neural_points as jnpc
from pointnerf_tpu.models import renderer as jrend
from pointnerf_tpu.ops import voxgrid as jvg
from pointnerf_tpu.run import common as jcommon
from pointnerf_tpu.run import test_ft as jtest_ft
from pointnerf_tpu.run import train_ft as jdriver
from pointnerf_tpu.train import trainer as jtr
from pointnerf_tpu.utils.visualizer import Visualizer as JVisualizer
from pointnerf_tpu_torch.config import Options
from pointnerf_tpu_torch.data import create_dataset
from pointnerf_tpu_torch.data import load_blender as tlb
from pointnerf_tpu_torch.models import aggregator as tagg
from pointnerf_tpu_torch.models import neural_points as tnpc
from pointnerf_tpu_torch.models import renderer as trend
from pointnerf_tpu_torch.ops import voxgrid as tvg
from pointnerf_tpu_torch.run import common as tcommon
from pointnerf_tpu_torch.run import test_ft as ttest_ft
from pointnerf_tpu_torch.run import train_ft as tdriver
from pointnerf_tpu_torch.train import trainer as ttr
from pointnerf_tpu_torch.utils.checkpoint import (from_jax_params,
                                                  from_jax_train_state)
from pointnerf_tpu_torch.utils.visualizer import Visualizer

from fixtures import make_nerf_synth_scene
from test_end_to_end import make_gt, tiny_setup
from test_torch_port_train import (GRAD_TOL, LOSS_TOL, _close_grads,
                                   _close_items, _np_tree, _uniform)

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
KERNELS = ("linear", "numlinear", "quadric", "numquadric", "avg", "trilinear")


def blob_cloud(n=3000, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 3) * np.array([0.5, 0.3, 0.8])).astype(np.float32)


def plate_cloud(n=2500, seed=1):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-0.42, 0.42, (n, 2))
    z = 0.01 * np.sin(xy[:, :1] * 7) + rng.normal(0, 0.002, (n, 1))
    return np.concatenate([xy, z], -1).astype(np.float32)


CLOUDS = {"blob": blob_cloud, "plate": plate_cloud}


def _same_spec(a, b):
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


class _Spec:
    """The lattice fields of a GridSpec, for both packages' functions."""

    def __init__(self, cloud):
        mn, pitch, dims = jvg.derive_lattice(cloud)
        self.vox_dim = tuple(int(d) for d in dims)
        self.vox_space_min = tuple(float(v) for v in mn)
        self.vox_gvs = float(pitch)


def _jax_table(xyz, mask, spec):
    return np.asarray(jax.jit(lambda x, m: jvg.build_vox_table(x, m, spec))(
        jnp.asarray(xyz), jnp.asarray(mask)))


def _jax_query(loc, table, spec):
    return np.asarray(jax.jit(lambda lc, t: jvg.query_vox_grid(lc, t, spec))(
        jnp.asarray(loc), jnp.asarray(table)))


# ------------------------------------------------------------- the lattice
@pytest.mark.parametrize("cloud", sorted(CLOUDS))
@pytest.mark.parametrize("res", [(6, 24), (16, 32), (8, 8)])
def test_lattice_matches_jax(cloud, res):
    xyz = CLOUDS[cloud]()
    got, got_gvs = tvg.construct_grid_points(xyz, *res)
    want, want_gvs = jvg.construct_grid_points(xyz, *res)
    assert got_gvs == want_gvs
    np.testing.assert_array_equal(got, want)
    for a, b in zip(tvg.derive_lattice(got), jvg.derive_lattice(want)):
        np.testing.assert_array_equal(a, b)


def test_lattice_refusals_match_jax():
    xyz = blob_cloud(50)
    for mod in (tvg, jvg):
        with pytest.raises(ValueError, match="construct_res"):
            mod.construct_grid_points(xyz, 0, 8)
        with pytest.raises(ValueError, match="construct_res"):
            mod.construct_grid_points(xyz, 16, 8)
        with pytest.raises(ValueError, match="degenerate"):
            mod.derive_lattice(xyz[:1])
    spec = _Spec(tvg.construct_grid_points(xyz, 4, 8)[0])
    spec.vox_dim = (2048, 2048, 1024)
    with pytest.raises(ValueError, match="grid_res"):
        tvg.build_vox_table(torch.zeros((1, 3)), torch.ones(1, dtype=bool),
                            spec)


# ------------------------------------------------- the corner table, query
@pytest.mark.parametrize("cloud", sorted(CLOUDS))
@pytest.mark.parametrize("dups", [False, True])
def test_vox_table_matches_jax(cloud, dups):
    """The table over a lattice with a random mask; with `dups`, extra
    points that round onto occupied corners (jittered by under half the
    pitch, in shuffled order) and points outside the box: where points
    share a corner both packages keep the highest index."""
    lat, _ = tvg.construct_grid_points(CLOUDS[cloud](), 6, 24)
    spec = _Spec(lat)
    rng = np.random.RandomState(2)
    xyz = lat
    if dups:
        pick = rng.randint(0, len(lat), 3 * len(lat))
        jit = rng.uniform(-0.45, 0.45, (len(pick), 3)) * spec.vox_gvs
        far = rng.uniform(-3, 3, (200, 3)) + np.sign(rng.randn(200, 3)) * 3
        xyz = np.concatenate([lat, lat[pick] + jit, far]).astype(np.float32)
        xyz = xyz[rng.permutation(len(xyz))]
    mask = rng.rand(len(xyz)) < 0.9
    got = tvg.build_vox_table(torch.tensor(xyz), torch.tensor(mask), spec)
    assert got.dtype == torch.int32
    want = _jax_table(xyz, mask, spec)
    np.testing.assert_array_equal(got.numpy(), want)
    if dups:        # corners that more than one masked point reaches
        mn = np.asarray(spec.vox_space_min, np.float32)
        inv = np.float32(1) / np.float32(spec.vox_gvs)
        c = np.round((xyz - mn) * inv).astype(np.int64)
        d1, d2 = spec.vox_dim[1], spec.vox_dim[2]
        inb = np.all((c >= 0) & (c < spec.vox_dim), -1) & mask
        lin = (c[inb, 0] * d1 + c[inb, 1]) * d2 + c[inb, 2]
        assert (np.bincount(lin) > 1).sum() > 100


@pytest.mark.parametrize("cloud", sorted(CLOUDS))
def test_query_vox_grid_matches_jax(cloud):
    """Samples inside the box, exactly on cell faces (the lattice's own
    coordinates, and an ulp either side), and outside it. On the face
    samples a true division by the pitch floors some into another cell
    than JAX's multiply by the reciprocal: the port takes JAX's."""
    lat, _ = tvg.construct_grid_points(CLOUDS[cloud](), 6, 24)
    spec = _Spec(lat)
    table = tvg.build_vox_table(torch.tensor(lat),
                                torch.ones(len(lat), dtype=torch.bool), spec)
    rng = np.random.RandomState(7)
    mn = np.asarray(spec.vox_space_min, np.float32)
    dims = np.asarray(spec.vox_dim)
    k = rng.randint(-1, dims + 1, (4000, 3))
    face = (mn + k * np.float32(spec.vox_gvs)).astype(np.float32)
    face = np.concatenate([face, np.nextafter(face, np.float32(np.inf)),
                           np.nextafter(face, np.float32(-np.inf))])
    lo = mn - 2 * spec.vox_gvs
    hi = mn + dims * spec.vox_gvs + 2 * spec.vox_gvs
    inside = rng.uniform(lo, hi, (6000, 3)).astype(np.float32)
    outside = rng.uniform(-9, 9, (500, 3)).astype(np.float32)
    loc = np.concatenate([face, inside, outside])[None, :, None]
    loc = loc.reshape(1, -1, 4, 3)
    got = tvg.query_vox_grid(torch.tensor(loc), table, spec)
    want = _jax_query(loc, table.numpy(), spec)
    assert got.dtype == torch.int32 and got.shape == loc.shape[:3] + (8,)
    np.testing.assert_array_equal(got.numpy(), want)
    hit = (want >= 0).all(-1)
    assert hit.any() and (~hit).any()
    d = face - mn
    inv = np.float32(1) / np.float32(spec.vox_gvs)
    assert (np.floor(d / np.float32(spec.vox_gvs))
            != np.floor(d * inv)).any()


def test_rebuild_after_prune_keeps_the_lattice():
    """After a prune the driver rebuilds with its first spec: the table
    covers the same box, the pruned corners -1, in both packages."""
    lat, _ = tvg.construct_grid_points(plate_cloud(), 8, 32)
    rng = np.random.RandomState(4)
    n = len(lat)
    arrs = [lat, rng.uniform(-.5, .5, (n, 4)), rng.rand(n, 3),
            rng.rand(n, 3), rng.rand(n, 1)]
    arrs = [a.astype(np.float32) for a in arrs]
    opt = JOptions(NN=-1, construct_res=8, grid_res=32, vsize=(0.04,) * 3,
                   vscale=(1, 1, 1), kernel_size=(3, 3, 3),
                   query_size=(3, 3, 3), P=8, max_o=20000)
    js = jnpc.create_point_cloud(*arrs, capacity=n + 64)
    ts = tnpc.create_point_cloud(*arrs, capacity=n + 64, device="cpu")
    jspec, _ = jcommon.make_spec_and_grid(opt, js)
    tspec, _ = tcommon.make_spec_and_grid(Options.from_json(opt.to_json()),
                                          ts)
    _same_spec(tspec, jspec)
    assert tspec.vox_dim[0] > 0
    js = jnpc.prune(js, 0.5)
    tnpc.prune(ts, 0.5)
    want = np.asarray(jax.jit(lambda x, m: jcommon.build_grid(x, m, jspec))(
        js["xyz"], js["mask"])["vox_table"])
    got = tcommon.build_grid(ts["xyz"], ts["mask"], tspec)["vox_table"]
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).sum() == int(ts["mask"].sum()) < n


# ------------------------------------------------- the pickled cloud
@pytest.mark.parametrize("noise", ["", "pointgaussian_0.01",
                                   "pointuniform_0.002", "pointuniformadd_0.01",
                                   "pointuniformdouble_0.005",
                                   "pointuniform_0.0"])
@pytest.mark.parametrize("normals", [False, True])
def test_cloud_and_point_noise_match_jax(tmp_path, noise, normals):
    xyz = blob_cloud(500)
    infos = {"point_xyz": xyz}
    if normals:
        infos["point_face_normal"] = np.tile([0.0, 0.0, 1.0], (500, 1))
    path = str(tmp_path / "cloud.pkl")
    with open(path, "wb") as f:
        pickle.dump(infos, f)
    for num in (200, 500, 10000):
        ra, rb = np.random.RandomState(5), np.random.RandomState(5)
        a, an = tlb.load_blender_cloud(path, num, ra)
        b, bn = jlb.load_blender_cloud(path, num, rb)
        np.testing.assert_array_equal(a, b)
        assert (an is None) == (bn is None) == (not normals)
        if normals:
            np.testing.assert_array_equal(an, bn)
        a = tlb.apply_point_noise(a, noise, ra)
        b = jlb.apply_point_noise(b, noise, rb)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for mod in (tlb, jlb):
        with pytest.raises(ValueError, match="point_noise"):
            mod.apply_point_noise(xyz, "bogus_0.01")


# ------------------------------------------------- the distance kernels
def _kernel_cases():
    out = []
    for k in KERNELS:
        for aw in (None, (1.0, 1.0, 1.0), (0.5, 2.0, 1.5)):
            # a per-channel axis weight needs 3 channels for the quadrics
            C = 3 if aw == (0.5, 2.0, 1.5) and "quadric" in k else 6
            out.append((k, aw, C))
    return out


@pytest.mark.parametrize("kernel,aw,C", _kernel_cases())
def test_distance_kernel_matches_jax(kernel, aw, C):
    """compute_weights forward and its gradient in the distances, with
    masked slots and distances under the clamps."""
    rng = np.random.RandomState(11)
    gvs = 0.07
    shape = (2, 5, 3, 8)
    d = rng.uniform(-gvs, gvs, shape + (C,)).astype(np.float32)
    d[0, 0, 0, :2] = 1e-9
    mask = (rng.rand(*shape) < 0.75).astype(np.float32)
    mask[1, 1, 1] = 0.0
    ct = rng.normal(size=shape).astype(np.float32)
    jopt = JOptions(agg_distance_kernel=kernel, agg_axis_weight=aw)
    want, vjp = jax.vjp(lambda v: jagg.compute_weights(
        jopt, None, None, v, jnp.asarray(mask), (0.1,) * 3, gvs)[0],
        jnp.asarray(d))
    (want_g,) = vjp(jnp.asarray(ct))
    dt = torch.tensor(d, requires_grad=True)
    got = tagg.compute_weights(Options.from_json(jopt.to_json()), dt,
                               torch.tensor(mask), gvs)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **FWD_TOL)
    if got.requires_grad:
        (got_g,) = torch.autograd.grad(got, dt, torch.tensor(ct))
    else:                           # avg: the weights ignore the distances
        got_g = torch.zeros_like(dt)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), **GRAD_TOL)


@pytest.mark.parametrize("k", ["feat_intrp", "meta_intrp"])
def test_learned_kernels_still_raise(k):
    """feat_intrp and meta_intrp fail in both packages: JAX's
    compute_weights raises ValueError, and so does the port's (sh_intrp
    and gau_intrp run: test_torch_port_envelopes.py)."""
    with pytest.raises(ValueError,
                       match=f"unsupported agg_distance_kernel {k}"):
        jagg.compute_weights(JOptions(agg_distance_kernel=k), None,
                             jnp.zeros((1, 8, 8)), jnp.zeros((1, 8, 3)),
                             jnp.ones((1, 8)), (0.1,) * 3, 0.1)
    with pytest.raises(ValueError, match=f"agg_distance_kernel {k}"):
        tagg.compute_weights(Options(agg_distance_kernel=k),
                             torch.zeros(1, 8, 3), torch.ones(1, 8))
    with pytest.raises(ValueError, match=f"agg_distance_kernel {k}"):
        tagg.init_aggregator_params(Options(agg_distance_kernel=k),
                                    device="cpu")


@pytest.mark.parametrize("kernel", KERNELS)
def test_aggregator_weight_norm_rule_matches_jax(kernel):
    """aggregator_forward with agg_weight_norm 1: no second normalisation
    for trilinear and the num* kernels; decoded, weight and conf against
    JAX's (unfused on both sides)."""
    opt, state, _, _, _, _ = tiny_setup()
    opt = opt.replace(agg_distance_kernel=kernel, agg_weight_norm=1, K=8,
                      use_fused_trunk=0, agg_axis_weight=(0.5, 2.0, 1.5)
                      if kernel == "linear" else None)
    params = jagg.init_aggregator_params(jax.random.PRNGKey(3), opt)
    agg, _ = from_jax_params(jax.tree.map(np.asarray, params),
                             {k: (None if v is None else np.asarray(v))
                              for k, v in state.items()}, device="cpu")
    rng = np.random.RandomState(12)
    B, R, SR, K = 1, 6, 4, 8
    f = lambda *s: rng.uniform(-1, 1, s).astype(np.float32)
    loc_w = f(B, R, SR, 3) * 0.1
    xyz = loc_w[..., None, :] + f(B, R, SR, K, 3) * 0.05
    campos = np.array([0.0, 0.0, -3.0], np.float32)
    xyz_pers = (xyz - campos) * np.float32(1.0)
    loc = (loc_w - campos)
    mask = rng.rand(B, R, SR, K) < 0.8
    ins = dict(color=f(B, R, SR, K, 3) * .5 + .5, dir=f(B, R, SR, K, 3),
               conf=f(B, R, SR, K, 1) * .5 + .5,
               emb=f(B, R, SR, K, opt.point_features_dim),
               rd=np.tile(np.array([0, 0, 1.0], np.float32), (B, R, SR, 1)))
    rw2c = np.eye(3, dtype=np.float32)
    args = (ins["color"], rw2c, ins["dir"], ins["conf"], ins["emb"],
            xyz_pers, xyz, mask, loc, loc_w, ins["rd"])
    want = jagg.aggregator_forward(params, opt, *map(jnp.asarray, args),
                                   opt.vsize, grid_vox_sz=0.07)
    got = tagg.aggregator_forward(agg, Options.from_json(opt.to_json()),
                                  *map(torch.tensor, args), 0.07)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   **FWD_TOL)


# ------------------------------------------------- the train step, NN -1
def _vox_scene(**kw):
    """tiny_setup's plate snapped to a lattice (construct 8, grid 16),
    with the lattice fields in both packages' specs and some confs
    outside the clamp."""
    opt, _, _, _, batch, xyz = tiny_setup(R_side=10)
    opt = opt.replace(**dict(dict(
        NN=-1, construct_res=8, grid_res=16, K=8, superset_P=16,
        agg_distance_kernel="trilinear", agg_weight_norm=0, SR_budget=0,
        k_tier=-1, use_fused_trunk=1), **kw))
    lat, _ = jvg.construct_grid_points(xyz, 8, 16)
    n = len(lat)
    rng = np.random.RandomState(0)
    emb = rng.uniform(-0.5, 0.5, (n, opt.point_features_dim))
    color = np.concatenate([lat[:, :2] + 0.5, np.full((n, 1), 0.5)], -1)
    dirs = np.tile(np.array([[0, 0, -1.0]]), (n, 1))
    conf = np.full((n, 1), 0.8)
    conf[::7] = 1.3
    state = jnpc.create_point_cloud(
        lat, *[a.astype(np.float32) for a in (emb, color, dirs, conf)])
    spec, grid = jcommon.make_spec_and_grid(opt, state)
    ts = jtr.create_train_state(opt, jax.random.PRNGKey(2), state)
    gt, _ = make_gt(batch)
    return opt, ts, spec, grid, dict(batch, gt_image=gt)


def _port(opt, ts, batch):
    st = from_jax_train_state(_np_tree(ts), opt, device="cpu")
    spec, grid = tcommon.make_spec_and_grid(opt, st.points)
    tb = {k: (torch.tensor(np.asarray(v)) if hasattr(v, "shape") else v)
          for k, v in batch.items()}
    return st, spec, grid, tb


def test_vox_grid_query_matches_jax():
    """render_query under NN -1 (the train jitter injected): the corner
    indices, the sample mask of the KNN behind ray_mask and the
    positions."""
    opt, ts, spec, grid, batch = _vox_scene()
    key = jax.random.PRNGKey(5)
    q = jax.jit(jrend.render_query, static_argnames=("spec", "opt",
                                                     "is_train"))
    want = q(jtr.point_state_of(ts), grid, spec, opt, batch, key, True)
    st, tspec, tgrid, tb = _port(opt, ts, batch)
    _same_spec(tspec, spec)
    np.testing.assert_array_equal(tgrid["vox_table"].numpy(),
                                  np.asarray(grid["vox_table"]))
    B, R = tb["raydir"].shape[:2]
    u = torch.tensor(_uniform(key, B, R, opt.z_depth_dim))
    got = trend.render_query(ttr.point_state_of(st), tgrid, tspec, opt, tb,
                             is_train=True, u=u)
    np.testing.assert_array_equal(got.sample_pidx.numpy(),
                                  np.asarray(want.sample_pidx))
    np.testing.assert_array_equal(got.ray_mask.numpy(),
                                  np.asarray(want.ray_mask))
    np.testing.assert_allclose(got.sample_loc_w.numpy(),
                               np.asarray(want.sample_loc_w), **FWD_TOL)
    assert int(got.q_overflow) == int(want.q_overflow) == 0
    full = (np.asarray(want.sample_pidx) >= 0).all(-1)
    assert full.any() and (~full).any()


@pytest.mark.parametrize("case", ["trilinear", "trilinear-compact",
                                  "linear-aw-overflow"])
def test_vox_grid_train_step_matches_jax(case):
    """compute_grads under NN -1: items and every gradient.
    trilinear: uncompacted, with agg_weight_norm 1 (no second
    normalisation). trilinear-compact: the port compacts on the shade side
    (a budget and a wide tier that drop no row), held to JAX's uncompacted
    step, since
    JAX's compacted branch hands the trilinear kernel a pitch of 0 and its
    loss is NaN (ROADMAP §3). linear-aw-overflow: a non-unit axis weight,
    a budget of 128 rows that overflows and the K-tier split, held to
    JAX's compacted step."""
    kw = {"trilinear": dict(agg_weight_norm=1),
          "trilinear-compact": dict(SR_budget=512, k_tier_wide_frac=1.0),
          "linear-aw-overflow": dict(agg_distance_kernel="linear",
                                     agg_weight_norm=1, SR_budget=128,
                                     agg_axis_weight=(0.5, 2.0, 1.5))}[case]
    opt, ts, spec, grid, batch = _vox_scene(**kw)
    key = jax.random.PRNGKey(5)
    jopt = opt.replace(SR_budget=0) if case == "trilinear-compact" else opt
    want, jn, jp = jtr.compute_grads(ts, grid, batch, key, jopt, spec)
    if case == "trilinear-compact":
        bad, _, _ = jtr.compute_grads(ts, grid, batch, key, opt, spec)
        assert not np.isfinite(float(bad["loss_total"]))
    st, tspec, tgrid, tb = _port(opt, ts, batch)
    B, R = tb["raydir"].shape[:2]
    u = torch.tensor(_uniform(key, B, R, opt.z_depth_dim))
    items, g_net, g_pts = ttr.compute_grads(st, tgrid, tb, opt, tspec, u)
    assert set(items) == set(want)
    assert float(items["sr_overflow"]) == float(want["sr_overflow"])
    if case == "linear-aw-overflow":
        assert float(want["sr_overflow"]) > 0
    _close_items(items, want, **LOSS_TOL)
    _close_grads(g_net, g_pts, jn, jp, **GRAD_TOL)


# ------------------------------------------------- the drivers
def _driver_opt(root, cpath, ckpt, **kw):
    """tests/test_voxgrid.py::test_nn_neg1_driver_end_to_end's options."""
    return JOptions(**dict(dict(
        experiment="voxgrid_e2e", checkpoints_dir=ckpt, data_root=root,
        scan="plate", dataset_name="nerf_synth360_ft", img_wh=(36, 36),
        load_points=1, cloud_path=cpath, num_point=2000,
        point_noise="pointuniform_0.002", NN=-1, construct_res=16,
        grid_res=32, agg_distance_kernel="trilinear", agg_weight_norm=0,
        random_sample="random", random_sample_size=12, near_plane=2.0,
        far_plane=6.0, bg_color="white", vsize=(0.04, 0.04, 0.04),
        vscale=(1, 1, 1), kernel_size=(3, 3, 3), query_size=(3, 3, 3),
        max_o=20000, P=8, K=8, SR=16, z_depth_dim=64, point_features_dim=16,
        shading_feature_num=32, shading_feature_mlp_layer1=1,
        shading_feature_mlp_layer3=1, shading_alpha_mlp_layer=1,
        shading_color_mlp_layer=2, num_feat_freqs=2, dist_xyz_freq=3,
        num_viewdir_freqs=2, default_conf=0.4, lr=0.002, plr=0.0,
        maximum_step=20, print_freq=10, save_iter_freq=20, test_freq=0,
        test_num=1, test_num_step=2, prune_iter=0, prob_freq=0,
        save_point_freq=0), **kw))


@pytest.fixture(scope="module")
def vox_scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("vox"))
    make_nerf_synth_scene(root, scan="plate", n_train=8, n_test=2,
                          wh=(36, 36))
    g = np.linspace(-0.42, 0.42, 30)
    gx, gy = np.meshgrid(g, g, indexing="ij")
    cloud = np.stack([gx, gy, np.zeros_like(gx) + 0.01 * np.sin(gx * 7)],
                     -1).reshape(-1, 3).astype(np.float32)
    cpath = os.path.join(root, "plate_cloud.pkl")
    with open(cpath, "wb") as f:
        pickle.dump({"point_xyz": cloud}, f)
    return root, cpath


@pytest.fixture(scope="module")
def vox_runs(vox_scene, tmp_path_factory):
    """Both drivers' 20-step NN -1 runs, from the same pickled cloud."""
    root, cpath = vox_scene
    out = str(tmp_path_factory.mktemp("runs"))
    jopt = _driver_opt(root, cpath, os.path.join(out, "j"))
    start = {}
    orig = jtr.create_train_state

    def catch(opt, key, ps, *a, **k):
        start["xyz"] = np.asarray(ps["xyz"])[np.asarray(ps["mask"])]
        return orig(opt, key, ps, *a, **k)
    jtr.create_train_state = catch
    try:
        want = jdriver.main(jopt)
    finally:
        jtr.create_train_state = orig
    opt = Options.from_json(jopt.replace(
        checkpoints_dir=os.path.join(out, "t")).to_json())
    got = tdriver.main(opt, device="cpu")
    return jopt, opt, want, got, start


def test_vox_grid_driver_matches_jax(vox_runs):
    """JAX's tests/test_voxgrid.py driver run in both packages: the same
    starting lattice, 20 steps, PSNR within 1.5 dB."""
    jopt, opt, want, got, start = vox_runs
    assert got["total_steps"] == want["total_steps"] == 20
    st = ttr.point_state_of(got["state"])
    xyz = st["xyz"].detach().numpy()[st["mask"].numpy()]
    np.testing.assert_array_equal(xyz, start["xyz"])
    _same_spec(got["spec"], want["spec"])
    assert got["spec"].vox_dim[0] > 0
    assert np.isfinite(got["final_psnr"]) and got["final_psnr"] > 5.0
    assert abs(got["final_psnr"] - want["final_psnr"]) < 1.5, \
        (got["final_psnr"], want["final_psnr"])


class _Captured:
    def __init__(self, monkeypatch, cls):
        self.maps = {}
        orig = cls.display_current_results

        def record(vis, visuals, step, subdir=""):
            self.maps[(subdir, step)] = {k: np.asarray(v)
                                         for k, v in visuals.items()}
            return orig(vis, visuals, step, subdir=subdir)
        monkeypatch.setattr(cls, "display_current_results", record)


@pytest.mark.parametrize("owner", ["jax", "port"])
def test_vox_grid_test_ft_on_either_checkpoint(vox_runs, tmp_path,
                                               monkeypatch, owner):
    """test_ft of both packages on the NN -1 checkpoint one of them wrote:
    each re-derives the lattice from the checkpoint's points; the test
    images agree at 1e-5."""
    jopt, opt, _, _, _ = vox_runs
    src = jopt if owner == "jax" else opt
    ckpt = os.path.join(src.checkpoints_dir, src.experiment)
    jcap = _Captured(monkeypatch, JVisualizer)
    tcap = _Captured(monkeypatch, Visualizer)
    want = jtest_ft.main(jopt.replace(resume_dir=ckpt,
                                      checkpoints_dir=str(tmp_path / "j")))
    got = ttest_ft.main(opt.replace(resume_dir=ckpt,
                                    checkpoints_dir=str(tmp_path / "t")),
                        device="cpu")
    assert got["step"] == want["step"] == 20
    assert sorted(tcap.maps) == sorted(jcap.maps) and jcap.maps
    for k, w in jcap.maps.items():
        np.testing.assert_allclose(tcap.maps[k]["coarse_raycolor"],
                                   w["coarse_raycolor"], **FWD_TOL,
                                   err_msg=str(k))
    assert abs(got["psnr"] - want["psnr"]) < 1e-3


def test_probe_under_vox_grid_fails_in_both(vox_scene, tmp_path):
    """Probe-and-grow under NN -1: JAX's probe grid has no corner table
    and its render stops with a KeyError; the port refuses with a
    ValueError naming prob_freq (ROADMAP §3)."""
    root, cpath = vox_scene
    jopt = _driver_opt(root, cpath, str(tmp_path), prob_freq=10)
    key = jax.random.PRNGKey(0)
    ds = jcreate(jopt, split="train")
    ts = jtr.create_train_state(
        jopt, key, jcommon.init_point_state_from_dataset(jopt, ds, key))
    spec, grid = jcommon.make_spec_and_grid(jopt, jtr.point_state_of(ts))
    with pytest.raises(KeyError, match="vox_table"):
        jdriver.probe_hole(ts, grid, jopt, spec, ds, [0],
                           JVisualizer(jopt), 10)
    opt = Options.from_json(jopt.to_json())
    tds = create_dataset(opt, "train")
    tts = ttr.create_train_state(
        opt, tcommon.init_point_state_from_dataset(opt, tds, device="cpu"),
        torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="prob_freq"):
        tdriver.probe_hole(tts, opt, tds, [0], Visualizer(opt), 10)
