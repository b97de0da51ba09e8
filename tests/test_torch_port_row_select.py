"""K7's plain version and the segmented occupancy pipeline it serves,
against the JAX package.

`row_select_reference` must equal a jnp formulation of the TPU kernel's
math (`kern_batched`, scripts/occ_micro3.py:134: a one-hot [D, U] x
[U, LW] product, then a one-hot lane select) for int8 and bf16 rows, and
the port's segmented pipeline (`scripts/occ_micro3.segmented_mask`) must
equal JAX's dense `mask_raypos` on every ray within U distinct rows. All
exact: the rows hold 0/1.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointnerf_tpu.ops import query as jq
from pointnerf_tpu_torch.ops import kernels
from pointnerf_tpu_torch.ops import query as tq
from pointnerf_tpu_torch.scripts import occ_micro3 as om

from test_torch_port_query import query_workload


def _kern_batched(rows_g, rank, lane, dtype):
    """kern_batched's math for all rays at once (jnp)."""
    U, LW = rows_g.shape[1:]
    oh = (rank[:, :, None] == jnp.arange(U)[None, None]).astype(dtype)
    m = jax.lax.dot_general(
        oh, rows_g.astype(dtype), (((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32 if dtype == jnp.bfloat16
        else jnp.int32)
    ohl = lane[:, :, None] == jnp.arange(LW)[None, None]
    return jnp.sum(jnp.where(ohl, m.astype(jnp.float32), 0.0), axis=-1)


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
def test_plain_row_select_matches_jax_one_hot(dtype):
    rng = np.random.RandomState(1)
    N, D, U, LW = 10, 40, 12, 128
    rows = (rng.rand(N, U, LW) < 0.3).astype(np.int8)
    rank = rng.randint(0, U, (N, D)).astype(np.int32)
    lane = rng.randint(0, LW, (N, D)).astype(np.int32)
    jd = jnp.int8 if dtype == "int8" else jnp.bfloat16
    want = _kern_batched(jnp.asarray(rows), jnp.asarray(rank),
                         jnp.asarray(lane), jd)
    td = torch.int8 if dtype == "int8" else torch.bfloat16
    got = tq.row_select(torch.as_tensor(rows).to(td), torch.as_tensor(rank),
                        torch.as_tensor(lane))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # one row set shared by every ray (ray stride 0)
    shared = torch.as_tensor(rows[:1]).to(td).expand(N, U, LW)
    np.testing.assert_array_equal(
        tq.row_select(shared, torch.as_tensor(rank),
                      torch.as_tensor(lane)).numpy(),
        np.asarray(_kern_batched(jnp.broadcast_to(jnp.asarray(rows[:1]),
                                                  (N, U, LW)),
                                 jnp.asarray(rank), jnp.asarray(lane), jd)))
    assert kernels.ROW_SELECT.launches == 0


@pytest.mark.parametrize("U", [96, 3])
def test_segmented_pipeline_matches_dense_mask(U):
    """Equal to the dense mask on every ray within U rows; at U=3 most rays
    overflow and must be conservative (a superset of the dense mask)."""
    campos, rd, t, _, grid_j, grid_t, spec_j, spec_t = query_workload(
        0, B=2, R=24, D=64)
    raypos = campos[:, None, None, :] + rd[:, :, None, :] * t[..., None]
    raypos = raypos.astype(np.float32)
    dense = np.asarray(jax.jit(lambda p: jq.mask_raypos(p, grid_j, spec_j))(
        jnp.asarray(raypos)))
    seg, over = om.segmented_mask(torch.as_tensor(raypos), grid_t, spec_t,
                                  U=U, dtype=torch.bfloat16)
    seg, over = seg.numpy(), over.numpy().reshape(dense.shape[:2])
    assert dense.any()
    np.testing.assert_array_equal(seg[~over], dense[~over])
    assert (seg | ~dense).all()              # never drops a valid sample
    assert over.any() == (U == 3)
