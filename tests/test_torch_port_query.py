"""Query parity: the port's query_grid_points against the JAX package's
(jitted, as the renderer runs it). Integer outputs (neighbor indices, masks,
compaction maps, counters) and the shading locations must match exactly.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointnerf_tpu.config import Options
from pointnerf_tpu.ops import grid as jgrid
from pointnerf_tpu.ops import query as jq
from pointnerf_tpu_torch.ops import grid as tgrid
from pointnerf_tpu_torch.ops import query as tq


def query_workload(superset_P, n_pts=800, B=2, R=24, D=64, seed=4):
    """Clustered cloud + rays through it (the dilated grid is hit often)."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-0.3, 0.3, (6, 3))
    xyz = (centers[rng.randint(0, 6, n_pts)]
           + rng.normal(0, 0.05, (n_pts, 3))).astype(np.float32)
    opt = Options(vsize=(0.04, 0.04, 0.04), vscale=(1, 1, 1),
                  kernel_size=(3, 3, 3), query_size=(3, 3, 3),
                  ranges=(-0.5, -0.5, -0.5, 0.5, 0.5, 0.5), max_o=2048, P=8,
                  radius_limit_scale=2.0, superset_P=superset_P,
                  query_max_voxels=14)
    spec_j = jgrid.make_grid_spec(opt, xyz.min(0), xyz.max(0), n_pts)
    spec_t = tgrid.make_grid_spec(opt, xyz.min(0), xyz.max(0), n_pts)
    grid_j = jgrid.build_grid(jnp.asarray(xyz), jnp.ones(n_pts, bool), spec_j)
    grid_t = tgrid.build_grid(torch.as_tensor(xyz),
                              torch.ones(n_pts, dtype=torch.bool), spec_t)
    campos = rng.uniform(-1.2, -0.8, (B, 3)).astype(np.float32)
    tgt = rng.uniform(-0.3, 0.3, (B, R, 3)).astype(np.float32)
    rd = tgt - campos[:, None]
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    t = np.sort(rng.uniform(0.2, 2.4, (B, R, D)), -1).astype(np.float32)
    return (campos, rd.astype(np.float32), t, xyz, grid_j, grid_t, spec_j,
            spec_t)


def _eq(got, want, name):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)


@pytest.mark.parametrize("superset_P", [0, 32])
@pytest.mark.parametrize("Nc", [0, 60])
def test_query_grid_points_matches_jax(superset_P, Nc):
    campos, rd, t, xyz, grid_j, grid_t, spec_j, spec_t = \
        query_workload(superset_P)
    SR, K = 6, 4
    want = jq.query_grid_points(jnp.asarray(campos), jnp.asarray(rd),
                                jnp.asarray(t), jnp.asarray(xyz), grid_j,
                                spec_j, SR=SR, K=K, Nc=Nc)
    got = tq.query_grid_points(torch.as_tensor(campos), torch.as_tensor(rd),
                               torch.as_tensor(t), grid_t, spec_t, SR=SR, K=K,
                               Nc=Nc)
    for i, name in ((1, "sample_loc_w"), (2, "ray_mask"), (3, "q_overflow"),
                    (5, "occ_overflow")):
        _eq(got[i], want[i], name)
    if Nc == 0:
        assert got[4] is None and want[4] is None
        _eq(got[0], want[0], "sample_pidx")
        assert (got[0] >= 0).any()
    else:
        assert got[0] is None and want[0] is None
        for g, w, name in zip(got[4], want[4], ("comp_src", "comp_valid",
                                                "c_pidx", "row_valid",
                                                "counts")):
            _eq(g, w, name)
        assert int(want[3]) > 0          # the budget actually overflows
        assert (got[4][2] >= 0).any()


def test_select_and_compaction_maps_match_jax():
    rng = np.random.RandomState(1)
    B, R, D, SR, Ncb = 3, 11, 30, 5, 17
    valid = rng.rand(B, R, D) < 0.25
    t = np.sort(rng.uniform(0, 5, (B, R, D)), -1).astype(np.float32)
    want = jq.select_shading_t(jnp.asarray(t), jnp.asarray(valid), SR)
    got = tq.select_shading_t(torch.as_tensor(t), torch.as_tensor(valid), SR)
    for g, w, name in zip(got, want, ("t_sel", "mask", "counts")):
        _eq(g, w, name)
    counts = np.array(want[2])
    want = jq.compact_row_map(jnp.asarray(counts), Ncb, SR)
    got = tq.compact_row_map(torch.as_tensor(counts), Ncb, SR)
    for g, w, name in zip(got, want, ("comp_src", "comp_valid", "n_total")):
        _eq(g, w, name)
    c = rng.normal(size=(B, Ncb, 2)).astype(np.float32)
    want = jq.expand_compacted(SR, True, jnp.asarray(c), jnp.asarray(counts),
                               want[0], want[1])
    got = tq.expand_compacted(SR, torch.as_tensor(c), torch.as_tensor(counts),
                              got[0], got[1])
    _eq(got, want, "expand_compacted")


@pytest.mark.parametrize("gen", ["near_far_linear", "near_far_disparity_linear"])
@pytest.mark.parametrize("near,far,S", [(2.0, 6.0, 400), (0.1, 8.0, 400),
                                        (0.3, 7.7, 333)])
def test_ray_generation_matches_jax(gen, near, far, S):
    """Eval-time depth samples equal the jitted JAX generator's bit for bit
    (near/far traced as the renderer's batch passes them)."""
    from pointnerf_tpu.ops import raygen as jr
    from pointnerf_tpu_torch.ops import raygen as tr
    rng = np.random.RandomState(0)
    rd = rng.normal(size=(1, 5, 3)).astype(np.float32)
    cam = np.array([[0.0, 0.5, 4.0]], np.float32)
    want = jax.jit(lambda c, r, n, f: jr.find_ray_generation_method(gen)(
        c, r, S, near=n, far=f))(cam, rd, near, far)
    got = tr.find_ray_generation_method(gen)(torch.as_tensor(cam),
                                             torch.as_tensor(rd), S,
                                             near=near, far=far)
    for name, g, w in zip(("raypos", "seg", "valid", "ts"), got, want):
        if name != "raypos":      # the renderer reads ts only
            _eq(g, w, name)
