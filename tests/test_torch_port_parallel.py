"""The multi-GPU port (`pointnerf_tpu_torch/parallel/`) against the JAX
package's single-device step, on the CPU.

The ranks are gloo processes started by `parallel.driver.launch`: one
spawn of 2 ranks and one of 4 for the whole module (module fixtures),
each rank at one torch thread. They import neither JAX nor this file: the
jobs (`parallel/checks.py`) arrive as numpy, and the JAX side runs here.
Each sharded step at n ranks and mesh_points M (n / M ray shards) is held
to JAX's single-device step with comp_groups = n / M, the value the
runner sets, from the same state and the same jitter draws: loss items
rtol 2e-5, atol 2e-6 (tests/test_parallel.py's bar), counters exactly,
the gradients (point gradients joined from the shards) rtol 2e-4, atol
2e-5, the buffers after one Adam step rtol 1e-4, atol 1e-5 (as
test_torch_port_train.py). Mesh serving is held to JAX's single-device
render_image at 1e-5, ray_mask exactly.

The frustum query (wcoord_query 0) and the vox-grid query (NN -1)
compact each camera row into one budget that comp_groups does not split:
their jobs (`fstep`, `feval`, `vstep`, `veval`, `vserve`) run the scenes
of test_torch_port_frustum.py and test_torch_port_voxgrid.py at budgets
that overflow, so a rank keeps the rows the whole row keeps only through
the prefix over the ray shards before it, and they are held to JAX's
single-device step (comp_groups plays no part) at the same bars,
sr_overflow exactly (it holds the wide K tier's overflow too).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from pointnerf_tpu.run import common as jcommon
from pointnerf_tpu.train import trainer as jtr
from pointnerf_tpu_torch.config import Options as TOptions
from pointnerf_tpu_torch.parallel import checks, driver
from pointnerf_tpu_torch.utils.checkpoint import (_net_tensors,
                                                  from_jax_train_state,
                                                  train_state_arrays)

from test_torch_port_frustum import _render_setup
from test_torch_port_train import _np_tree, _port, _scene, _uniform
from test_torch_port_voxgrid import _port as _vox_port
from test_torch_port_voxgrid import _vox_scene

ITEM_TOL = dict(rtol=2e-5, atol=2e-6)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
STEP_TOL = dict(rtol=1e-4, atol=1e-5)
KEY = jax.random.PRNGKey(9)
SPARSE = dict(sparse_loss_weight=0.1)
# a budget that covers every row of this scene's one 64-ray chunk (and a
# covering wide tier): compaction runs and drops nothing
COVER = dict(SR_budget=511, k_tier_wide_frac=1.0)


@functools.lru_cache(maxsize=None)
def _cached_scene(items):
    """The scene of test_torch_port_train at these options, and the port's
    state, spec and grid (built once per option set)."""
    opt, ts, spec, grid, batch = _scene(**dict(items))
    return (opt, ts, spec, grid, batch), _port(opt, ts, batch)


def _scene_of(**kw):
    return _cached_scene(tuple(sorted(kw.items())))


def _port_opt(opt):
    return TOptions.from_json(opt.replace(comp_groups=1).to_json())


def _np_batch(batch):
    return {k: (np.asarray(v) if hasattr(v, "shape") else v)
            for k, v in batch.items()}


def _step_job(M, **kw):
    (opt, ts, spec, grid, batch), (st, spec_t, grid_t, _) = _scene_of(**kw)
    B, R = batch["raydir"].shape[:2]
    return dict(kind="step", opt=_port_opt(opt).to_json(), points=M,
                state=train_state_arrays(st), spec=spec_t,
                grid={k: v.numpy() for k, v in grid_t.items()},
                batch=_np_batch(batch), all_ranks=True,
                draws=[_uniform(jax.random.fold_in(KEY, 0), B, R,
                                opt.z_depth_dim)])


def _eval_job(M):
    job = _step_job(M)
    return dict(job, kind="eval", all_ranks=False)


def _item(batch):
    R = int(batch["raydir"].shape[1])
    side = int(np.sqrt(R))
    ii, jj = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    return {"raydir": np.asarray(batch["raydir"]),
            "campos": np.asarray(batch["campos"]),
            "camrotc2w": np.asarray(batch["camrotc2w"]),
            "near": batch["near"], "far": batch["far"],
            "bg_color": np.asarray(batch["bg_color"]),
            "pixel_idx": np.stack([jj.ravel(), ii.ravel()], -1)[None],
            "h": side, "w": side}


def _serve_job(M, **kw):
    (opt, ts, spec, grid, batch), (st, spec_t, grid_t, _) = _scene_of(
        random_sample_size=8, **kw)
    return dict(kind="serve", opt=_port_opt(opt).to_json(), points=M,
                state=train_state_arrays(st), spec=spec_t,
                grid={k: v.numpy() for k, v in grid_t.items()},
                item=_item(batch), group=1)


# the vox-grid scene: test_torch_port_voxgrid's linear-aw-overflow case
# at a budget of 200 rows (231 valid): the compaction drops 31 rows and the
# wide K tier (k_tier -1, its budget 128 of the whole row's 200) drops more
VOX = dict(agg_distance_kernel="linear", agg_weight_norm=1, SR_budget=200,
           agg_axis_weight=(0.5, 2.0, 1.5))
# the frustum render scene trained with the uniform shpnt_jitter: budgets
# of 40 rows with the K-tier split and of 20 under NN 0, both overflowing
FRUSTUM = dict(SR_budget=40, k_tier=1, shpnt_jitter="uniform")
FRUSTUM_NN0 = dict(SR_budget=20, NN=0, shpnt_jitter="uniform")
# mesh serving under NN -1: a 128-row budget per 100-ray chunk overflows,
# the ladder's 256-row rung holds every row (a covering wide tier)
VOX_SERVE = dict(VOX, SR_budget=128, k_tier_wide_frac=1.0,
                 random_sample_size=10)
# ray_chunk inside a rank under NN -1: 25-ray chunks of a rank's 50 rays,
# each chunk pair's budget of 60 rows overflowing
VOX_CHUNK = dict(ray_chunk=25, SR_budget=60)


@functools.lru_cache(maxsize=None)
def _cached_vox(items):
    """The vox-grid scene at these options, JAX's and the port's."""
    opt, ts, spec, grid, batch = _vox_scene(**dict(items))
    return (opt, ts, spec, grid, batch), _vox_port(opt, ts, batch)


def _vox_of(kw):
    return _cached_vox(tuple(sorted(dict(VOX, **kw).items())))


@functools.lru_cache(maxsize=None)
def _cached_frustum(items):
    """The frustum render scene at these options with a JAX train state,
    a gt image and the port's state."""
    opt, spec_j, spec_t, state, _, jb, _, _, tb = _render_setup(
        **dict(items))
    ts = jtr.create_train_state(opt, jax.random.PRNGKey(2), state)
    R = jb["raydir"].shape[1]
    gt = np.random.RandomState(4).rand(1, R, 3).astype(np.float32)
    batch = dict(jb, gt_image=jax.numpy.asarray(gt))
    st = from_jax_train_state(_np_tree(ts), opt, device="cpu")
    return (opt, ts, spec_j, batch), (st, spec_t, dict(tb, gt_image=gt))


def _frustum_of(kw):
    return _cached_frustum(tuple(sorted(kw.items())))


def _frustum_draws(opt, spec, batch):
    """JAX's draws of step 0 (key fold_in(KEY, 0)): the shpnt_jitter
    draws [1,R,SR] and, under NN 0, the whole budget's priorities."""
    key = jax.random.fold_in(KEY, 0)
    R = batch["raydir"].shape[1]
    u = np.asarray(jax.random.uniform(key, (1, R, opt.SR)))
    pri = None
    if opt.NN <= 0:
        O = spec.kernel_size[0] ** 3
        pri = np.asarray(jax.random.uniform(
            jax.random.fold_in(key, 7), (1, int(opt.SR_budget), 1, O * spec.P)))
    return u, pri


def _vstep_job(M, **kw):
    (opt, ts, spec, grid, batch), (st, spec_t, grid_t, _) = _vox_of(kw)
    B, R = batch["raydir"].shape[:2]
    return dict(kind="step", opt=_port_opt(opt).to_json(), points=M,
                state=train_state_arrays(st), spec=spec_t,
                grid={k: v.numpy() for k, v in grid_t.items()},
                batch=_np_batch(batch), all_ranks=True,
                draws=[_uniform(jax.random.fold_in(KEY, 0), B, R,
                                opt.z_depth_dim)])


def _fstep_job(M, **kw):
    (opt, ts, spec, batch), (st, spec_t, tb) = _frustum_of(kw)
    u, pri = _frustum_draws(opt, spec, batch)
    return dict(kind="step", opt=_port_opt(opt).to_json(), points=M,
                state=train_state_arrays(st), spec=spec_t, grid=None,
                batch=_np_batch(tb), all_ranks=True, draws=[u],
                priorities=pri)


def _vserve_job(M, **kw):
    (opt, ts, spec, grid, batch), (st, spec_t, grid_t, _) = _vox_of(
        VOX_SERVE)
    return dict(kind="serve", opt=_port_opt(opt).to_json(), points=M,
                state=train_state_arrays(st), spec=spec_t,
                grid={k: v.numpy() for k, v in grid_t.items()},
                item=_item(batch), group=1)


CHUNK = dict(ray_chunk=16)
JOBS = {
    2: [("step", 1, {}), ("step", 2, {}), ("step", 1, SPARSE),
        ("step", 1, CHUNK), ("eval", 1, {}), ("eval", 2, {}),
        ("serve", 1, COVER), ("serve", 2, COVER), ("serve", 1, {}),
        ("vstep", 1, {}), ("vstep", 2, {}), ("fstep", 1, FRUSTUM),
        ("fstep", 2, FRUSTUM), ("fstep", 1, FRUSTUM_NN0),
        ("veval", 1, {}), ("feval", 1, FRUSTUM), ("vserve", 1, {}),
        ("vstep", 1, VOX_CHUNK)],
    4: [("step", 1, {}), ("step", 2, {}), ("step", 2, SPARSE),
        ("eval", 1, {}), ("serve", 2, {}), ("vstep", 1, {}),
        ("fstep", 2, FRUSTUM), ("vserve", 2, {})],
}
MAKE = {"step": _step_job, "eval": lambda M, **kw: _eval_job(M),
        "serve": lambda M, **kw: _serve_job(M, **kw),
        "vstep": _vstep_job, "fstep": _fstep_job,
        "veval": lambda M, **kw: dict(_vstep_job(M, **kw), kind="eval",
                                      all_ranks=False),
        "feval": lambda M, **kw: dict(_fstep_job(M, **kw), kind="eval",
                                      all_ranks=False),
        "vserve": _vserve_job}


def _launch(n, tmp_path_factory):
    jobs = [MAKE[kind](M, **kw) for kind, M, kw in JOBS[n]]
    out = driver.launch(checks.run_jobs, (jobs,), n, 1, "cpu",
                        str(tmp_path_factory.mktemp(f"ranks{n}")), threads=1)
    return dict(zip(((k, M, tuple(sorted(kw))) for k, M, kw in JOBS[n]),
                    out))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return _launch(2, tmp_path_factory)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return _launch(4, tmp_path_factory)


def _ranks(request, n):
    return request.getfixturevalue("two_ranks" if n == 2 else "four_ranks")


@functools.lru_cache(maxsize=None)
def _jax_reference(nr, sparse):
    """JAX's single-device compute_grads and one train_step at
    comp_groups = nr, from the scene's state and draws."""
    (opt, ts, spec, grid, batch), _ = _scene_of(**(SPARSE if sparse else {}))
    opt = opt.replace(comp_groups=nr)
    want, jn, jp = jtr.compute_grads(ts, grid, batch,
                                     jax.random.fold_in(KEY, 0), opt, spec)
    ts1, items1 = jtr.train_step(ts, grid, batch, KEY, opt, spec)
    return want, _net_tensors(_np_tree(jn)), _np_tree(jp), \
        _np_tree(ts1), items1


@pytest.mark.parametrize("n,M,kw", [
    (2, 1, {}), (2, 2, {}), (2, 1, SPARSE),
    (4, 1, {}), (4, 2, {}), (4, 2, SPARSE)],
    ids=["2r-M1", "2r-M2", "2r-M1-sparse", "4r-M1", "4r-M2", "4r-M2-sparse"])
def test_sharded_step_matches_jax(request, n, M, kw):
    """Every rank's loss items and counters are the single-device step's;
    the gradients summed over the ray shards (point gradients joined from
    the point shards) are the single-device gradients; after one Adam
    step the net weights are bitwise equal on every rank and equal JAX's,
    and the joined point buffers equal JAX's."""
    ranks = _ranks(request, n)[("step", M, tuple(sorted(kw)))]
    want, jn, jp, ts1, items1 = _jax_reference(n // M, bool(kw))
    assert len(ranks) == n
    if kw:
        assert float(want["loss_sparse"]) > 0
    for r in ranks:
        assert set(r["items"]) == set(want)
        assert r["items"]["sr_overflow"] == float(want["sr_overflow"]) > 0
        for k, v in want.items():
            np.testing.assert_allclose(r["items"][k], float(v),
                                       err_msg=f"rank {r['rank']} {k}",
                                       **ITEM_TOL)
        for k, v in jn.items():
            np.testing.assert_allclose(r["g_net"][k], v, err_msg=k,
                                       **GRAD_TOL)
        for k, v in jp.items():
            np.testing.assert_allclose(r["g_pts"][k], np.asarray(v),
                                       err_msg=k, **GRAD_TOL)
        for k, v in items1.items():
            np.testing.assert_allclose(r["step_items"][0][k], float(v),
                                       err_msg=k, **ITEM_TOL)
        for k, v in _net_tensors(ts1.agg_params).items():
            np.testing.assert_array_equal(r["net_after"][k],
                                          ranks[0]["net_after"][k])
            np.testing.assert_allclose(r["net_after"][k], v, err_msg=k,
                                       **STEP_TOL)
        for k, v in ts1.pt_train.items():
            np.testing.assert_allclose(r["points_after"][k], v, err_msg=k,
                                       **STEP_TOL)


@pytest.mark.parametrize("n,M", [(2, 1), (2, 2), (4, 1), (4, 2)])
def test_shards_at_rest(request, n, M):
    """Each rank holds cap / M rows of every capacity buffer and of its
    Adam moments and max_o / M rows of the bucket tables; the dense voxel
    maps whole. Its compaction map has ceil(Nc / G) rows (G = n / M
    groups, one per ray shard), not Nc: the shade phase and the trunk run
    on the rank's rows only."""
    ranks = _ranks(request, n)[("step", M, ())]
    (opt, ts, spec, grid, batch), _ = _scene_of()
    cap = ts.pt_static["mask"].shape[0]
    B, R = batch["raydir"].shape[:2]
    Nc = max(128, -(-(B * R * opt.SR) // (6 * 128)) * 128)
    G = n // M
    for r in ranks:
        sh = r["shapes"]
        assert sh["pt/embedding"] == (cap // M, opt.point_features_dim)
        assert sh["pt/mask"] == (cap // M,)
        assert sh["grid/occ_2_xyz"] == (spec.max_o // M, spec.P, 4)
        assert sh["grid/super_xyz"][0] == spec.max_o // M
        for k in ("coor_2_occ", "coor_occ_rows", "coor_slot"):
            assert sh[f"grid/{k}"] == tuple(grid[k].shape), k
        assert {v[0] for k, v in sh.items() if k.startswith("adam/")} \
            == {cap // M}
        assert r["comp_shape"] == (B, -(-Nc // (B * G)))
        assert (r["ray_index"], r["point_index"]) == divmod(r["rank"], M)
    if M > 1:
        whole = _ranks(request, n)[("step", 1, ())][0]["bytes"]
        for r in ranks:
            for k in ("capacity_bytes", "bucket_bytes"):
                assert r["bytes"][k] * M == whole[k], k


@functools.lru_cache(maxsize=None)
def _jax_render(cover):
    (opt, ts, spec, grid, batch), _ = _scene_of(
        random_sample_size=8, **(COVER if cover else {}))
    return jcommon.render_image(ts, grid, opt, spec, _item(batch), group=1)


@pytest.mark.parametrize("n,M,kw", [
    (2, 1, COVER), (2, 2, COVER), (2, 1, {}), (4, 2, {})],
    ids=["2r-M1", "2r-M2", "2r-M1-ladder", "4r-M2-ladder"])
def test_mesh_serving_matches_jax(request, n, M, kw):
    """render_image on the ranks equals JAX's single-device render_image
    (the image on every rank). Without a budget the auto one overflows, so
    the ladder's rung comes from the overflow summed over the ranks and
    the last rung (uncompacted, each chunk split over the ranks) renders
    every row."""
    res = _ranks(request, n)[("serve", M, tuple(sorted(kw)))]
    want = _jax_render(bool(kw))
    np.testing.assert_allclose(res["maps"]["coarse_raycolor"],
                               want["coarse_raycolor"], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(res["maps"]["ray_mask"], want["ray_mask"])
    assert (res["stats"]["sr_overflow"] > 0) == (not kw)


def test_ray_chunk_inside_a_rank(two_ranks):
    """ray_chunk chunks each rank's own rays: chunk j of every rank is
    group r of the whole batch's chunk j, whose budget reads all of its
    rows. So two ranks at ray_chunk 16 equal the one-device step at
    ray_chunk 32 and comp_groups 2 over the rays taken in that order
    (rank 0's chunk j, then rank 1's): the same items and counters, the
    same gradients."""
    from pointnerf_tpu_torch.train import trainer as ttr
    ranks = two_ranks[("step", 1, ("ray_chunk",))]
    (opt, ts, spec, grid, batch), (st, spec_t, grid_t, tb) = _scene_of(
        **CHUNK)
    B, R = batch["raydir"].shape[:2]
    u = _uniform(jax.random.fold_in(KEY, 0), B, R, opt.z_depth_dim)
    half, C = R // 2, CHUNK["ray_chunk"]
    order = np.concatenate([np.arange(r * half + j * C, r * half + (j + 1) * C)
                            for j in range(half // C) for r in range(2)])
    perm = {k: (v[:, order] if k in ("raydir", "gt_image") else v)
            for k, v in tb.items()}
    one = _port_opt(opt).replace(ray_chunk=2 * C, comp_groups=2)
    items, g_net, g_pts = ttr.compute_grads(st, grid_t, perm, one, spec_t,
                                            torch.tensor(u[:, order]))
    assert float(items["sr_overflow"]) > 0
    for r in ranks:
        assert r["items"]["sr_overflow"] == float(items["sr_overflow"])
        for k, v in items.items():
            np.testing.assert_allclose(r["items"][k], float(v), err_msg=k,
                                       **ITEM_TOL)
        for got, want in ((r["g_net"], g_net), (r["g_pts"], g_pts)):
            for k, v in want.items():
                np.testing.assert_allclose(got[k], v.numpy(), err_msg=k,
                                           **GRAD_TOL)


@pytest.mark.parametrize("n,M", [(2, 1), (2, 2), (4, 1)])
def test_sharded_eval_matches_jax(request, n, M):
    """make_dp_eval_step / make_mp_eval_step: the whole batch's render
    from the ranks' shards equals JAX's eval_step at comp_groups = n / M
    (1e-5, ray_mask exactly), its overflow summed over the ranks."""
    out = _ranks(request, n)[("eval", M, ())]
    (opt, ts, spec, grid, batch), _ = _scene_of()
    want = jtr.eval_step(ts, grid, batch, opt.replace(comp_groups=n // M),
                         spec)
    np.testing.assert_allclose(out["coarse_raycolor"],
                               np.asarray(want["coarse_raycolor"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(out["ray_mask"],
                                  np.asarray(want["ray_mask"]))
    assert int(out["sr_overflow"]) == int(want["sr_overflow"]) > 0


def _hold_step(ranks, want, jn, jp, ts1, items1, n):
    """Every rank's items, gradients and state after one Adam step against
    JAX's single-device step (the bars of test_sharded_step_matches_jax)."""
    assert len(ranks) == n
    for r in ranks:
        assert set(r["items"]) == set(want)
        assert r["items"]["sr_overflow"] == float(want["sr_overflow"]) > 0
        assert r["step_items"][0]["sr_overflow"] == \
            float(items1["sr_overflow"])
        for k, v in want.items():
            np.testing.assert_allclose(r["items"][k], float(v),
                                       err_msg=f"rank {r['rank']} {k}",
                                       **ITEM_TOL)
        for k, v in jn.items():
            np.testing.assert_allclose(r["g_net"][k], v, err_msg=k,
                                       **GRAD_TOL)
        for k, v in jp.items():
            np.testing.assert_allclose(r["g_pts"][k], np.asarray(v),
                                       err_msg=k, **GRAD_TOL)
        for k, v in items1.items():
            np.testing.assert_allclose(r["step_items"][0][k], float(v),
                                       err_msg=k, **ITEM_TOL)
        for k, v in _net_tensors(ts1.agg_params).items():
            np.testing.assert_array_equal(r["net_after"][k],
                                          ranks[0]["net_after"][k])
            np.testing.assert_allclose(r["net_after"][k], v, err_msg=k,
                                       **STEP_TOL)
        for k, v in ts1.pt_train.items():
            np.testing.assert_allclose(r["points_after"][k], v, err_msg=k,
                                       **STEP_TOL)


@functools.lru_cache(maxsize=None)
def _jax_vox_reference():
    (opt, ts, spec, grid, batch), _ = _vox_of({})
    want, jn, jp = jtr.compute_grads(ts, grid, batch,
                                     jax.random.fold_in(KEY, 0), opt, spec)
    ts1, items1 = jtr.train_step(ts, grid, batch, KEY, opt, spec)
    return want, _net_tensors(_np_tree(jn)), _np_tree(jp), \
        _np_tree(ts1), items1


@functools.lru_cache(maxsize=None)
def _jax_frustum_reference(kw):
    (opt, ts, spec, batch), _ = _frustum_of(dict(kw))
    want, jn, jp = jtr.compute_grads(ts, None, batch,
                                     jax.random.fold_in(KEY, 0), opt, spec)
    ts1, items1 = jtr.train_step(ts, None, batch, KEY, opt, spec)
    return want, _net_tensors(_np_tree(jn)), _np_tree(jp), \
        _np_tree(ts1), items1


@pytest.mark.parametrize("n,M", [(2, 1), (2, 2), (4, 1)],
                         ids=["2r-M1", "2r-M2", "4r-M1"])
def test_vox_grid_sharded_step_matches_jax(request, n, M):
    """NN -1: the ray shards share each camera row's compaction budget and
    its wide-tier budget in ray order, so every rank's items, counters,
    gradients and updated state are JAX's single-device step's, whose
    budget of 200 rows and wide tier both overflow."""
    _hold_step(_ranks(request, n)[("vstep", M, ())],
               *_jax_vox_reference(), n)


def test_vox_grid_step_overflows_both_budgets():
    """The vox job's budgets overflow: JAX's sr_overflow at a covering
    wide tier is the compaction's alone (above 0), and the wide tier's
    adds to it at the job's."""
    (opt, ts, spec, grid, batch), _ = _vox_of({})
    key = jax.random.fold_in(KEY, 0)
    comp, _, _ = jtr.compute_grads(ts, grid, batch, key,
                                   opt.replace(k_tier_wide_frac=1.0), spec)
    want = _jax_vox_reference()[0]
    assert 0 < float(comp["sr_overflow"]) < float(want["sr_overflow"])


@pytest.mark.parametrize("n,M,kw", [
    (2, 1, FRUSTUM), (2, 2, FRUSTUM), (2, 1, FRUSTUM_NN0), (4, 2, FRUSTUM)],
    ids=["2r-M1", "2r-M2", "2r-M1-NN0", "4r-M2"])
def test_frustum_sharded_step_matches_jax(request, n, M, kw):
    """wcoord_query 0: each rank builds the camera grid from the whole
    points, keeps the whole row's first valid rows in ray order (under NN 0
    with the whole budget's priorities, JAX's, at its rows) and counts
    the rows it drops; items, counters, gradients and the state after one
    step are JAX's single-device step's."""
    _hold_step(_ranks(request, n)[("fstep", M, tuple(sorted(kw)))],
               *_jax_frustum_reference(tuple(sorted(kw.items()))), n)


@pytest.mark.parametrize("kind", ["veval", "feval"])
def test_sharded_eval_under_both_queries_matches_jax(two_ranks, kind):
    """The sharded eval step under NN -1 and under the frustum: JAX's
    eval_step (1e-5, ray_mask exactly), sr_overflow summed over the ranks
    exactly."""
    if kind == "veval":
        out = two_ranks[("veval", 1, ())]
        (opt, ts, spec, grid, batch), _ = _vox_of({})
        want = jtr.eval_step(ts, grid, batch, opt, spec)
    else:
        out = two_ranks[("feval", 1, tuple(sorted(FRUSTUM)))]
        (opt, ts, spec, batch), _ = _frustum_of(FRUSTUM)
        want = jtr.eval_step(ts, None, batch, opt, spec)
    np.testing.assert_allclose(out["coarse_raycolor"],
                               np.asarray(want["coarse_raycolor"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(out["ray_mask"],
                                  np.asarray(want["ray_mask"]))
    assert int(out["sr_overflow"]) == int(want["sr_overflow"]) > 0


@functools.lru_cache(maxsize=None)
def _jax_vox_render():
    (opt, ts, spec, grid, batch), _ = _vox_of(VOX_SERVE)
    return jcommon.render_image(ts, grid, opt, spec, _item(batch), group=1)


@pytest.mark.parametrize("n,M", [(2, 1), (4, 2)], ids=["2r-M1", "4r-M2"])
def test_vox_grid_mesh_serving_matches_jax(request, n, M):
    """render_image under NN -1 on the ranks: the chunk's rays split over
    the ray shards, which share its budget in ray order; the first rung
    overflows on the whole image, so every rank climbs to the 256-row
    rung, as JAX's single-device ladder does. The image equals JAX's (1e-5,
    ray_mask exactly)."""
    res = _ranks(request, n)[("vserve", M, ())]
    want = _jax_vox_render()
    np.testing.assert_allclose(res["maps"]["coarse_raycolor"],
                               want["coarse_raycolor"], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(res["maps"]["ray_mask"], want["ray_mask"])
    assert res["stats"]["sr_overflow"] > 0


def test_ray_chunk_inside_a_rank_under_vox_grid(two_ranks):
    """ray_chunk under NN -1: chunk j of every rank is a piece of the
    whole batch's chunk j, whose camera-row budget the ranks share in ray
    order. So two ranks at ray_chunk 25 equal the one-device step at
    ray_chunk 50 over the rays taken in that order (rank 0's chunk j, then
    rank 1's): the same items and counters, the same gradients."""
    ranks = two_ranks[("vstep", 1, tuple(sorted(VOX_CHUNK)))]
    (opt, ts, spec, grid, batch), (st, spec_t, grid_t, tb) = _vox_of(
        VOX_CHUNK)
    B, R = batch["raydir"].shape[:2]
    u = _uniform(jax.random.fold_in(KEY, 0), B, R, opt.z_depth_dim)
    half, C = R // 2, VOX_CHUNK["ray_chunk"]
    order = np.concatenate([np.arange(r * half + j * C, r * half + (j + 1) * C)
                            for j in range(half // C) for r in range(2)])
    perm = {k: (v[:, order] if k in ("raydir", "gt_image") else v)
            for k, v in tb.items()}
    one = _port_opt(opt).replace(ray_chunk=2 * C)
    from pointnerf_tpu_torch.train import trainer as ttr
    items, g_net, g_pts = ttr.compute_grads(st, grid_t, perm, one, spec_t,
                                            torch.tensor(u[:, order]))
    assert float(items["sr_overflow"]) > 0
    for r in ranks:
        assert r["items"]["sr_overflow"] == float(items["sr_overflow"])
        for k, v in items.items():
            np.testing.assert_allclose(r["items"][k], float(v), err_msg=k,
                                       **ITEM_TOL)
        for got, want in ((r["g_net"], g_net), (r["g_pts"], g_pts)):
            for k, v in want.items():
                np.testing.assert_allclose(got[k], v.numpy(), err_msg=k,
                                           **GRAD_TOL)
