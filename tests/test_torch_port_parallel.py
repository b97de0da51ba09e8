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
                                                  train_state_arrays)

from test_torch_port_train import _np_tree, _port, _scene, _uniform

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


CHUNK = dict(ray_chunk=16)
JOBS = {
    2: [("step", 1, {}), ("step", 2, {}), ("step", 1, SPARSE),
        ("step", 1, CHUNK), ("eval", 1, {}), ("eval", 2, {}),
        ("serve", 1, COVER), ("serve", 2, COVER), ("serve", 1, {})],
    4: [("step", 1, {}), ("step", 2, {}), ("step", 2, SPARSE),
        ("eval", 1, {}), ("serve", 2, {})],
}
MAKE = {"step": _step_job, "eval": lambda M, **kw: _eval_job(M),
        "serve": lambda M, **kw: _serve_job(M, **kw)}


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
