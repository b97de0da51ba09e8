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


def _rows_view(N, U, LW, dtype, offset):
    """An [N, U, LW] view of a flat buffer, starting `offset` elements in."""
    flat = torch.zeros(N * U * LW + offset, dtype=dtype)
    return flat[offset:].view(N, U, LW)


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_bulk_copy_check_takes_aligned_blocks(dtype):
    """K7's wrapper passes a block the bulk copy can stage: 16-byte aligned,
    a multiple of 16 bytes, per ray or shared (ray stride 0)."""
    rows = _rows_view(5, 9, 128, dtype, 0)
    tq.check_bulk_copy(rows)
    tq.check_bulk_copy(rows[:1].expand(5, 9, 128))


@pytest.mark.parametrize("dtype,offset", [(torch.int8, 1), (torch.int8, 8),
                                          (torch.bfloat16, 1)])
def test_bulk_copy_check_rejects_a_misaligned_block(dtype, offset):
    """rows_g starting off a 16-byte boundary raises ValueError (the card
    route takes no other path for it)."""
    rows = _rows_view(5, 9, 128, dtype, offset)
    assert rows.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        tq.check_bulk_copy(rows)


def test_bulk_copy_check_rejects_a_ragged_block():
    """A block of U·LW bytes that is not a multiple of 16 raises."""
    with pytest.raises(ValueError, match="multiples of 16"):
        tq.check_bulk_copy(_rows_view(4, 3, 12, torch.int8, 0))


def test_bulk_copy_check_rejects_a_block_past_shared_memory():
    """Two blocks and the CTA's row spans (8 bytes a ray) must fit a CTA's
    shared memory; one block shared by every ray (stride 0) need only fit
    once."""
    rows = _rows_view(2, 1024, 128, torch.int8, 0)      # 128 KiB a block
    with pytest.raises(ValueError, match="shared memory"):
        tq.check_bulk_copy(rows)
    tq.check_bulk_copy(rows[:1].expand(2, 1024, 128))
    rows = _rows_view(2, 800, 128, torch.int8, 0)       # 100 KiB a block
    tq.check_bulk_copy(rows, rays_per_cta=16)
    with pytest.raises(ValueError, match="shared memory"):
        tq.check_bulk_copy(rows, rays_per_cta=4096)
