"""Occupancy parity: the port's mask_raypos_segmented (kernel K3's plain
version on CPU tensors) against the JAX dense mask_raypos and the segmented
Pallas kernel in interpret mode, both under jit as the query runs them.
Masks must match exactly; the port reports no overflow.

occupancy_select (K3's select mode: the occupancy test, the first ≤SR
occupied depths and their positions in one pass on the card) runs its plain
version on CPU tensors. It must equal, bit for bit, the JAX chain the query
runs under jit: the segmented mask (interpret mode, U = D), select_shading_t
and campos + raydir·t_sel where selected. The workload's rays miss the grid,
graze it or cross it, so rays hold 0, fewer than SR and more than SR
occupied samples, and many samples lie outside the grid; its depths are
either one row broadcast over the rays (strides 0, 0, 1, as at serving) or
jittered per ray (dense, as at training), D = 97.
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointnerf_tpu.config import Options
from pointnerf_tpu.ops import grid as jgrid
from pointnerf_tpu.ops import query as jq
from pointnerf_tpu_torch.ops import grid as tgrid
from pointnerf_tpu_torch.ops import kernels
from pointnerf_tpu_torch.ops import query as tq

from test_torch_port_query import query_workload


@functools.partial(jax.jit, static_argnames=("spec", "U"))
def _jax_masks(campos, rd, t, grid, spec, U):
    raypos = campos[:, None, None, :] + rd[:, :, None, :] * t[..., None]
    dense = jq.mask_raypos(raypos, grid, spec)
    seg, n_over = jq.mask_raypos_segmented(raypos, grid, spec, U,
                                           interpret=True)
    return dense, seg, n_over


@pytest.mark.parametrize("seed,D", [(4, 64), (9, 97)])
def test_occupancy_matches_dense_and_segmented(seed, D):
    campos, rd, t, _, grid_j, grid_t, spec_j, spec_t = query_workload(
        0, B=2, R=7, D=D, seed=seed)
    dense, seg, n_over = _jax_masks(jnp.asarray(campos), jnp.asarray(rd),
                                    jnp.asarray(t), grid_j, spec_j, U=D)
    assert int(n_over) == 0
    got, over = tq.mask_raypos_segmented(
        torch.as_tensor(campos), torch.as_tensor(rd), torch.as_tensor(t),
        grid_t, spec_t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(dense))
    np.testing.assert_array_equal(got.numpy(), np.asarray(seg))
    assert int(over) == 0 and got.dtype == torch.bool
    assert np.asarray(dense).any() and not np.asarray(dense).all()
    assert kernels.OCCUPANCY.launches == 0


def test_occupancy_counts_no_overflow_where_jax_budget_overflows():
    """With a row budget too small for some rays, the JAX kernel goes
    conservative-valid and counts them; the port stays exact (dense mask)
    and reports occ_overflow 0."""
    campos, rd, t, _, grid_j, grid_t, spec_j, spec_t = query_workload(
        0, B=1, R=6, D=64, seed=2)
    dense, seg, n_over = _jax_masks(jnp.asarray(campos), jnp.asarray(rd),
                                    jnp.asarray(t), grid_j, spec_j, U=2)
    assert int(n_over) > 0
    got, over = tq.mask_raypos_segmented(
        torch.as_tensor(campos), torch.as_tensor(rd), torch.as_tensor(t),
        grid_t, spec_t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(dense))
    assert int(over) == 0
    assert (np.asarray(seg) >= got.numpy()).all()   # JAX's is a superset


def select_workload(broadcast: bool, B=2, R=24, D=97, seed=3):
    """A box-shaped cloud and B cameras in front of it. Per camera a quarter
    of the rays miss the grid, a quarter graze its dilated edge, the rest
    cross it; the depths span the whole grid and beyond. Returns numpy
    (campos, raydir, t [B,R,D]), the cloud, the JAX and the port's grid and
    spec."""
    rng = np.random.RandomState(seed)
    xyz = (rng.uniform(-1, 1, (1200, 3)) * [0.4, 0.4, 0.55]
           ).astype(np.float32)
    opt = Options(vsize=(0.04, 0.04, 0.04), vscale=(1, 1, 1),
                  kernel_size=(3, 3, 3), query_size=(3, 3, 3),
                  ranges=(-0.6, -0.6, -0.6, 0.6, 0.6, 0.6), max_o=4096, P=8,
                  radius_limit_scale=2.0, superset_P=32)
    n = len(xyz)
    spec_j = jgrid.make_grid_spec(opt, xyz.min(0), xyz.max(0), n)
    spec_t = tgrid.make_grid_spec(opt, xyz.min(0), xyz.max(0), n)
    grid_j = jgrid.build_grid(jnp.asarray(xyz), jnp.ones(n, bool), spec_j)
    grid_t = tgrid.build_grid(torch.as_tensor(xyz),
                              torch.ones(n, dtype=torch.bool), spec_t)
    campos = np.stack([rng.uniform(-0.05, 0.05, B),
                       rng.uniform(-0.05, 0.05, B), np.full(B, -1.2)], -1)
    tgt = np.zeros((B, R, 3))
    tgt[..., :2] = rng.uniform(-0.2, 0.2, (B, R, 2))
    q = R // 4
    tgt[:, :q, 0] += 3.0                                  # miss
    tgt[:, q:2 * q, 0] = rng.uniform(0.47, 0.5, (B, q))   # graze
    rd = tgt - campos[:, None]
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    if broadcast:
        t = np.broadcast_to(np.linspace(0.55, 1.85, D, dtype=np.float32),
                            (B, R, D))
    else:
        t = np.sort(rng.uniform(0.55, 1.85, (B, R, D)), -1)
    return (campos.astype(np.float32), rd.astype(np.float32),
            t.astype(np.float32), xyz, grid_j, grid_t, spec_j, spec_t)


def port_inputs(campos, rd, t, broadcast: bool):
    """Torch tensors of the workload; broadcast depths as one expanded row
    (strides 0, 0, 1), as the serving path hands them over."""
    tt = (torch.as_tensor(t[0, 0].copy()).expand(t.shape) if broadcast
          else torch.as_tensor(t))
    return torch.as_tensor(campos), torch.as_tensor(rd), tt


@functools.partial(jax.jit, static_argnames=("spec", "SR"))
def _jax_select(campos, rd, t, grid, spec, SR):
    """The JAX query's chain (query.py:578-588) with the segmented mask."""
    raypos = campos[:, None, None, :] + rd[:, :, None, :] * t[..., None]
    valid, _ = jq.mask_raypos_segmented(raypos, grid, spec, t.shape[-1],
                                        interpret=True)
    t_sel, mask, counts = jq.select_shading_t(t, valid, SR)
    loc = jnp.where(mask[..., None],
                    campos[:, None, None, :] + rd[:, :, None, :]
                    * t_sel[..., None], 0.0)
    return loc, mask, counts, valid


@pytest.mark.parametrize("SR", [1, 7, 80, 120])
@pytest.mark.parametrize("broadcast", [True, False],
                         ids=["broadcast", "jittered"])
def test_occupancy_select_matches_jax_chain(broadcast, SR):
    campos, rd, t, _, grid_j, grid_t, spec_j, spec_t = select_workload(
        broadcast)
    want = _jax_select(jnp.asarray(campos), jnp.asarray(rd), jnp.asarray(t),
                       grid_j, spec_j, SR)
    want = [np.asarray(w) for w in want]
    total = want[3].sum(-1)
    assert (total == 0).any() and ((0 < total) & (total < 80)).any() \
        and (total > 80).any()
    c, r, tt = port_inputs(campos, rd, t, broadcast)
    assert (tt.stride() == (0, 0, 1)) == broadcast
    launches = kernels.OCCUPANCY.launches
    got = tq.occupancy_select(c, r, tt, grid_t, spec_t, SR)
    for g, w, name in zip(got, want, ("sample_loc_w", "sample_mask",
                                      "counts")):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.bool
    assert got[2].dtype == torch.int32 and int(got[3]) == 0
    if SR > t.shape[-1]:
        assert not got[1][..., t.shape[-1]:].any()
    assert kernels.OCCUPANCY.launches == launches


@pytest.mark.parametrize("Nc", [0, 160])
@pytest.mark.parametrize("broadcast", [True, False],
                         ids=["broadcast", "jittered"])
def test_query_grid_points_on_select_workload_matches_jax(broadcast, Nc):
    """The whole query, which now takes its shading points from
    occupancy_select, against JAX's on the select workload."""
    campos, rd, t, xyz, grid_j, grid_t, spec_j, spec_t = select_workload(
        broadcast)
    SR, K = 7, 4
    want = jq.query_grid_points(jnp.asarray(campos), jnp.asarray(rd),
                                jnp.asarray(t), jnp.asarray(xyz), grid_j,
                                spec_j, SR=SR, K=K, Nc=Nc)
    got = tq.query_grid_points(*port_inputs(campos, rd, t, broadcast),
                               grid_t, spec_t, SR=SR, K=K, Nc=Nc)
    leaves = [(got[i], want[i], name) for i, name in (
        (0, "sample_pidx"), (1, "sample_loc_w"), (2, "ray_mask"),
        (3, "q_overflow"), (5, "occ_overflow"))]
    if Nc:
        assert int(want[3]) > 0          # the budget actually overflows
        leaves += list(zip(got[4], want[4], ("comp_src", "comp_valid",
                                             "c_pidx", "row_valid",
                                             "counts")))
    for g, w, name in leaves:
        if w is None:
            assert g is None, name
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=name)


@pytest.mark.parametrize("case", ["samples", "slots", "offset", "volume",
                                  "axis", "fits"])
def test_occupancy_index_range_guard(case):
    """K3 indexes with 32-bit integers and floors coordinates below 2^22:
    the wrapper's guard refuses what would overflow, before any launch."""
    *_, spec = select_workload(True, B=1, R=2, D=8)
    shape, strides, SR = (2, 1024, 1024), (0, 0, 1), 80
    if case == "samples":
        shape = (2, 1024, 2 ** 20)
    elif case == "slots":
        SR = 2 ** 20
    elif case == "offset":
        strides = (2 ** 31, 1024, 1)
    elif case == "volume":
        spec = dataclasses.replace(spec, vdim=(2048, 1024, 1024))
    elif case == "axis":
        spec = dataclasses.replace(spec, vdim=(2 ** 22 + 1, 1, 1))
    if case == "fits":
        tq.check_index_range(shape, strides, SR, spec)
    else:
        with pytest.raises(ValueError, match=r"2\^(31|22)"):
            tq.check_index_range(shape, strides, SR, spec)
