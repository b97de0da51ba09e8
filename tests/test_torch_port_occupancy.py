"""Occupancy parity: the port's mask_raypos_segmented (kernel K3's plain
version on CPU tensors) against the JAX dense mask_raypos and the segmented
Pallas kernel in interpret mode, both under jit as the query runs them.
Masks must match exactly; the port reports no overflow.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointnerf_tpu.ops import query as jq
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
