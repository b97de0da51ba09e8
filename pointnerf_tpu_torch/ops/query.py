"""Ray → shading point → neighbor query over the voxel grid.

PyTorch port of `pointnerf_tpu/ops/query.py` (one compaction group). The
KNN takes the world-coordinate metric (a spherical radius cap) or the
perspective-frustum one (`spec.pers_metric`: a radius cap on x/z, y/z and
a depth cap on z), and in the frustum's NN ≤ 0 mode K random candidates in
place of the K nearest. Where the JAX version shaped work around the TPU — one-hot
lane selects, [B,R,D,SR] indicator contractions, count-compare maps — the
port does the direct GPU thing with the same outputs: gathers, scatters and
`searchsorted`. Integer outputs (masks, neighbor indices, counters) equal
the JAX package's exactly.

The occupancy test and the shading-point select, `occupancy_select`,
launch the CUDA kernel `csrc/occupancy.cu` (K3) on CUDA tensors: one pass
that tests every depth sample and writes the positions of each ray's first
SR occupied ones. Its plain version is the dense `mask_raypos`, then
`select_shading_t`, then the picked depths' positions. The occupancy test
alone, `mask_raypos_segmented`, launches the same kernel in mask mode.
`row_select`, the per-sample select of the segment-cached occupancy
experiment (`pointnerf_tpu_torch/scripts/occ_micro3.py`; no production path
runs it), launches `csrc/row_select.cu`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import kernels
from .grid import (GridSpec, fma, grid_consts, host_const, linearize,
                   voxel_coords)

BIG = 3.0e38
INDEX_LIMIT = 2 ** 31   # K3 indexes with 32-bit integers
FLOOR_LIMIT = 2 ** 22   # and floors coordinates below it on the float pipe


def ray_points(campos: torch.Tensor, raydir: torch.Tensor,
               tvals: torch.Tensor) -> torch.Tensor:
    """campos [B,3] + raydir [B,R,3] · t [B,R,D] → [B,R,D,3], rounded once
    per coordinate as XLA's fused multiply-add rounds it."""
    return fma(raydir[:, :, None, :], tvals[..., None], campos[:, None, None, :])


def _sq32(limit: float) -> float:
    """A squared limit, rounded to float32 as the comparison against float32
    distances rounds it."""
    return float(np.float32(limit * limit))


def _r2(spec: GridSpec) -> float:
    return _sq32(spec.radius_limit)


def _pers_caps(valid: torch.Tensor, dxy2, dz2, spec: GridSpec) -> torch.Tensor:
    """The frustum metric's caps (reference query_point_indices.py:476):
    radius_limit on the perspective xy distance, depth_limit on z."""
    if spec.radius_limit > 0:
        valid = valid & (dxy2 <= _r2(spec))
    if spec.depth_limit > 0:
        valid = valid & (dz2 <= _sq32(spec.depth_limit))
    return valid


def mask_raypos(raypos: torch.Tensor, grid, spec: GridSpec) -> torch.Tensor:
    """[B,R,D,3] ray sample positions → bool validity via the dilated
    occupancy (reference cu:165-189): one direct byte lookup per sample."""
    coords, inb = voxel_coords(raypos, spec)
    lin = torch.where(inb, linearize(coords, spec), 0)
    occ = grid["coor_occ_rows"].reshape(-1)[lin.long()]
    return (occ > 0) & inb


def mask_raypos_segmented(campos: torch.Tensor, raydir: torch.Tensor,
                          tvals: torch.Tensor, grid, spec: GridSpec
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Occupancy of the samples campos + raydir·t, tvals [B,R,D].

    Counterpart of the JAX segment-cached test, which caches each ray's
    ≤U distinct occupancy rows for its TPU kernel and goes conservative
    past U. The port looks every sample up directly (`csrc/occupancy.cu` in
    mask mode on CUDA tensors, dense `mask_raypos` on CPU tensors), so it is
    exact — equal to the dense mask everywhere — and has no budget: the
    second return, the number of rays past the row budget (`occ_overflow`),
    is always 0.

    Returns (valid [B,R,D] bool, n_overflow [] int32).
    """
    n_over = torch.zeros((), dtype=torch.int32, device=tvals.device)
    if tvals.device.type == "cpu":
        return mask_raypos(ray_points(campos, raydir, tvals), grid, spec), \
            n_over
    return _occupancy_launch(campos, raydir, tvals, grid, spec), n_over


def occupancy_select_reference(campos: torch.Tensor, raydir: torch.Tensor,
                               tvals: torch.Tensor, grid, spec: GridSpec,
                               SR: int):
    """The plain version of `occupancy_select`: the dense mask, the first
    ≤SR valid depths (`select_shading_t`), their positions."""
    valid = mask_raypos(ray_points(campos, raydir, tvals), grid, spec)
    t_sel, sample_mask, counts = select_shading_t(tvals, valid, SR)
    sample_loc_w = torch.where(sample_mask[..., None],
                               ray_points(campos, raydir, t_sel), 0.0)
    return sample_loc_w, sample_mask, counts


def occupancy_select(campos: torch.Tensor, raydir: torch.Tensor,
                     tvals: torch.Tensor, grid, spec: GridSpec, SR: int):
    """Occupancy of the samples campos + raydir·t (tvals [B,R,D], any
    strides) and the positions of each ray's first ≤SR occupied ones.

    On CUDA tensors one launch of `csrc/occupancy.cu` (K3) does both: a
    warp per ray ranks its occupied samples with a ballot and writes only
    the first SR; B·R·D, B·R·SR·3, the largest tvals offset and the grid
    volume must stay under 2^31, each grid dimension at most 2^22
    (ValueError). On CPU tensors it runs `occupancy_select_reference`.
    Exact, with no row budget: occ_overflow is always 0.

    Returns (sample_loc_w [B,R,SR,3] float32, sample_mask [B,R,SR] bool,
    counts [B,R] int32 = min(occupied samples, SR), occ_overflow [] int32).
    """
    n_over = torch.zeros((), dtype=torch.int32, device=tvals.device)
    if tvals.device.type == "cpu":
        return (*occupancy_select_reference(campos, raydir, tvals, grid,
                                            spec, SR), n_over)
    return (*_occupancy_launch(campos, raydir, tvals, grid, spec, SR),
            n_over)


def check_index_range(shape, tvals_strides, SR, spec: GridSpec) -> None:
    """Raise ValueError where K3's 32-bit indices would overflow, or a grid
    dimension passes the range of its float-pipe floor."""
    B, R, D = shape
    sizes = {"B·R·D": B * R * D, "B·R·SR·3": B * R * max(SR, 0) * 3,
             "the largest tvals offset": sum(max(n - 1, 0) * st for n, st
                                             in zip(shape, tvals_strides)),
             "the grid volume": spec.grid_size_vol}
    for what, n in sizes.items():
        if n >= INDEX_LIMIT:
            raise ValueError(f"occupancy indexes with 32-bit integers: "
                             f"{what} = {n} reaches 2^31")
    if max(spec.vdim) > FLOOR_LIMIT:
        raise ValueError(f"occupancy floors voxel coordinates below 2^22 "
                         f"only; the grid is {spec.vdim}")


def _occupancy_launch(campos, raydir, tvals, grid, spec: GridSpec,
                      SR: int | None = None):
    """K3 in select mode, returning (sample_loc_w, sample_mask, counts),
    or, with SR None, in mask mode, returning valid [B,R,D]."""
    dev = tvals.device
    if dev.type != "cuda":
        raise ValueError(f"occupancy runs on cpu or cuda, not {dev}")
    B, R, D = tvals.shape
    rows = grid["coor_occ_rows"]
    check_index_range((B, R, D), tvals.stride(), SR or 0, spec)
    kernels.require(campos, "campos", torch.float32, dev, (B, 3))
    kernels.require(raydir, "raydir", torch.float32, dev, (B, R, 3))
    kernels.require(rows, "coor_occ_rows", torch.int8, dev)
    if tvals.dtype != torch.float32 or tvals.device != dev:
        raise ValueError("tvals must be float32 on the rays' device")
    if rows.numel() < spec.grid_size_vol:
        raise ValueError("coor_occ_rows is smaller than the grid volume")
    if SR is None:
        outs = (torch.empty((B, R, D), dtype=torch.bool, device=dev),)
        ptrs = (None, None, None, outs[0].data_ptr())
    else:
        outs = (torch.empty((B, R, SR, 3), dtype=torch.float32, device=dev),
                torch.empty((B, R, SR), dtype=torch.bool, device=dev),
                torch.empty((B, R), dtype=torch.int32, device=dev))
        ptrs = (*(o.data_ptr() for o in outs), None)
    mn, inv = (v.tolist() for v in grid_consts(spec, "cpu"))
    err = kernels.library().occupancy_select(
        campos.data_ptr(), raydir.data_ptr(), tvals.data_ptr(),
        rows.data_ptr(), *ptrs, *tvals.stride(), B, R, D, SR or 0, *mn,
        *inv, *spec.vdim, kernels.stream_handle(tvals))
    kernels.check(err, kernels.OCCUPANCY)
    kernels.OCCUPANCY.launches += 1
    return outs[0] if SR is None else outs


def row_select_reference(rows_g: torch.Tensor, rank: torch.Tensor,
                         lane: torch.Tensor) -> torch.Tensor:
    """The plain version of `row_select`: advanced indexing."""
    N, U, LW = rows_g.shape
    n = torch.arange(N, device=rank.device)[:, None]
    r = rank.long().clamp(0, U - 1)
    return rows_g[n, r, lane.long().clamp(0, LW - 1)].to(torch.float32)


def row_select(rows_g: torch.Tensor, rank: torch.Tensor, lane: torch.Tensor,
               rays_per_cta: int = 16) -> torch.Tensor:
    """Segmented occupancy row select: occ[n, d] = rows_g[n, rank[n, d],
    lane[n, d]] as float32.

    rows_g [N, U, LW] int8 or bf16 (each ray's cached occupancy rows; a
    ray stride of 0, as from `expand`, shares one row set across rays),
    rank/lane [N, D] integers, clamped to [0, U) and [0, LW). On CUDA
    tensors it launches `csrc/row_select.cu` (K7, replaces
    `scripts/occ_micro3.py::run_kernel`): each CTA walks `rays_per_cta`
    rays (the TPU's Rt), bulk-copying the rows of each ray's [U, LW] block
    that its ranks reach into shared memory (the whole block once per CTA
    at ray stride 0) while the ray before it is selected, four samples a
    thread. The copy takes only 16-byte aligned blocks: rows_g must start
    16-byte aligned, and U·LW and the ray stride must be multiples of 16
    bytes; anything else raises ValueError (`check_bulk_copy`). On CPU
    tensors it runs `row_select_reference`."""
    if rank.device.type == "cpu":
        return row_select_reference(rows_g, rank, lane)
    if rank.device.type != "cuda":
        raise ValueError(f"row_select runs on cpu or cuda, not {rank.device}")
    dev = rank.device
    N, U, LW = rows_g.shape
    D = rank.shape[1]
    codes = {torch.int8: 0, torch.bfloat16: 1}
    if rows_g.dtype not in codes:
        raise ValueError(f"rows_g has dtype {rows_g.dtype}, expected int8 or "
                         f"bfloat16")
    if rows_g.device != dev:
        raise ValueError(f"rows_g is on {rows_g.device}, expected {dev}")
    if rows_g.stride()[1:] != (LW, 1) or rows_g.stride(0) not in (0, U * LW):
        raise ValueError("rows_g must be [N, U, LW] with contiguous rows and "
                         "a ray stride of U·LW or 0")
    check_bulk_copy(rows_g, rays_per_cta)
    rank = rank.to(torch.int32).contiguous()
    lane = lane.to(torch.int32).contiguous()
    kernels.require(rank, "rank", torch.int32, dev, (N, D))
    kernels.require(lane, "lane", torch.int32, dev, (N, D))
    out = torch.empty((N, D), dtype=torch.float32, device=dev)
    vec = all(t.data_ptr() % 16 == 0 for t in (rank, lane, out))
    err = kernels.library().row_select(
        rows_g.data_ptr(), rank.data_ptr(), lane.data_ptr(), out.data_ptr(),
        N, D, U, LW, rows_g.stride(0), int(rays_per_cta),
        codes[rows_g.dtype], int(vec), kernels.stream_handle(rank))
    kernels.check(err, kernels.ROW_SELECT)
    kernels.ROW_SELECT.launches += 1
    return out


SMEM_MAX = 231424       # dynamic shared memory K7 asks for at most: sm_90's
                        # 227 KiB a CTA, less 1 KiB for its barriers


def check_bulk_copy(rows_g: torch.Tensor, rays_per_cta: int = 16) -> None:
    """Raise ValueError unless K7's bulk copy can stage rows_g's [U, LW]
    blocks: each starts 16-byte aligned, spans a multiple of 16 bytes, and
    two of them with the CTA's table of row spans (one block at ray stride
    0) fit in a CTA's shared memory."""
    N, U, LW = rows_g.shape
    block = U * LW * rows_g.element_size()
    stride = rows_g.stride(0) * rows_g.element_size()
    if rows_g.data_ptr() % 16 or stride % 16 or block % 16:
        raise ValueError(
            f"row_select stages each ray's rows with a 16-byte bulk copy: "
            f"rows_g must start 16-byte aligned (offset "
            f"{rows_g.data_ptr() % 16}) with a block of U·LW = {block} bytes "
            f"and a ray stride of {stride} bytes, both multiples of 16")
    need = block if stride == 0 else 2 * block + 8 * rays_per_cta
    if need > SMEM_MAX:
        raise ValueError(f"{need} bytes of [U, LW] blocks ({block} bytes "
                         f"each) do not fit in shared memory ({SMEM_MAX} "
                         f"bytes)")


def select_shading_t(tvals: torch.Tensor, valid: torch.Tensor, SR: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """First ≤SR valid depths per ray (reference cu:192-214).

    tvals/valid [B,R,D]. Returns (t_sel [B,R,SR], mask [B,R,SR],
    counts [B,R]). The (s+1)-th valid sample is written to slot s by a
    scatter; the rest of the row stays 0.
    """
    B, R, D = valid.shape
    cum = torch.cumsum(valid.to(torch.int32), dim=-1, dtype=torch.int32)
    total = cum[..., -1]
    slot = torch.where(valid & (cum <= SR), cum - 1, SR).long()
    t_sel = torch.zeros((B, R, SR + 1), dtype=tvals.dtype, device=tvals.device)
    t_sel.scatter_(2, slot, tvals.expand(B, R, D))
    s_idx = torch.arange(1, SR + 1, dtype=torch.int32, device=valid.device)
    mask = s_idx <= total[..., None]
    return t_sel[..., :SR], mask, torch.clamp(total, max=SR)


class Shards(NamedTuple):
    """A batch's place in a ray-sharded one (`parallel.dp`, mesh serving):
    it is the piece at ray coordinate `index` of `rays` equal pieces of
    each camera row, and one of `batch` pieces of the camera rows, of a
    batch of batch·B rows by rays·R rays. `prefix(counts)` takes a count
    per camera row of this piece ([B] int32) and returns the sum of the
    same counts over the pieces before it in those rows (the same on every
    rank that holds this piece): the frustum and vox-grid paths compact
    each whole camera row into one budget across its pieces with it.
    Shards() is a whole batch."""
    batch: int = 1
    rays: int = 1
    index: int = 0
    prefix: Optional[Callable] = None


SHARE_BUCKET = 128      # a piece's buffer rows: a multiple of this


def row_share(counts: torch.Tensor, Nt: int, shards: Optional[Shards]):
    """This piece's share of a budget of Nt rows per camera row, whose
    rows are kept in ray order across the pieces: (limit, rows). limit:
    the budget rows the pieces before it leave ([B,1] int32; Nt itself
    for a whole batch), so its valid row of running count c is kept when
    c ≤ limit; rows: the buffer it compacts into, Nt for a whole batch,
    else its most kept rows over its camera rows rounded up to a multiple
    of SHARE_BUCKET, at most Nt (one host read; the rounding repeats the
    shapes the trunk sees). counts [B] int32: its valid rows per camera
    row."""
    if shards is None or shards.prefix is None:
        return Nt, Nt
    before = shards.prefix(counts.to(torch.int32))
    limit = torch.clamp(Nt - before, min=0).to(torch.int32)[:, None]
    need = int(torch.minimum(counts, limit[:, 0]).max())
    rows = max(SHARE_BUCKET, -(-need // SHARE_BUCKET) * SHARE_BUCKET)
    return limit, min(Nt, rows)


def compact_row_map(counts: torch.Tensor, Ncb: int, SR: int, limit=None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-ray valid-row counts [B,R] → (comp_src [B,Ncb] flat ray·SR+slot
    source rows, comp_valid [B,Ncb], n_total [B]). Slot s belongs to the last
    ray r with rayoff[r] ≤ s; slots ≥ n_total hold clamped garbage. limit
    ([B,1], `row_share`): only the first `limit` valid rows of a camera
    row are valid slots."""
    B, R = counts.shape
    rayoff = torch.cumsum(counts, dim=-1, dtype=torch.int32) - counts
    n_total = rayoff[:, -1] + counts[:, -1]
    slots = torch.arange(Ncb, dtype=torch.int32, device=counts.device)
    c_ray = torch.searchsorted(rayoff.contiguous(),
                               slots.expand(B, Ncb).contiguous(),
                               right=True) - 1
    c_s = slots[None] - torch.gather(rayoff, 1, c_ray)
    comp_src = torch.clamp(c_ray.to(torch.int32) * SR + c_s, 0, R * SR - 1)
    n = torch.clamp(n_total[:, None], max=Ncb)
    comp_valid = slots[None] < (n if limit is None
                                else torch.clamp(n, max=limit))
    return comp_src, comp_valid, n_total


def expand_compacted(SR: int, c: torch.Tensor, counts_g: torch.Tensor,
                     comp_src: torch.Tensor, comp_valid: torch.Tensor
                     ) -> torch.Tensor:
    """Inverse of the prefix compaction map: [BG,Ncb,...] → [BG,Rg,SR,...].

    Row (r, sr) reads compacted slot rayoff[r] + sr, valid iff
    sr < counts[r] and the slot is inside the budget. The gradient is the
    compaction gather itself, ct_c[s] = ct_full[comp_src[s]] on the valid
    slots (the JAX package's `_expand_bwd`), not the scatter that autograd
    would make of the expanding gather."""
    if torch.is_grad_enabled() and c.requires_grad:
        return _ExpandCompacted.apply(SR, c, counts_g, comp_src, comp_valid)
    return _expand(SR, c, counts_g, comp_valid)


class _ExpandCompacted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, SR, c, counts_g, comp_src, comp_valid):
        ctx.save_for_backward(comp_src, comp_valid)
        return _expand(SR, c, counts_g, comp_valid)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, ct):
        comp_src, comp_valid = ctx.saved_tensors
        BG, Ncb = comp_src.shape
        tail = tuple(ct.shape[3:])
        RS = ct.shape[1] * ct.shape[2]
        goff = (torch.arange(BG, device=ct.device) * RS)[:, None]
        g = ct.reshape((BG * RS,) + tail)[(comp_src + goff).reshape(-1)]
        g = g.reshape((BG, Ncb) + tail)
        ct_c = torch.where(comp_valid.reshape((BG, Ncb) + (1,) * len(tail)),
                           g, torch.zeros((), dtype=g.dtype, device=g.device))
        return None, ct_c, None, None, None


def _expand(SR: int, c: torch.Tensor, counts_g: torch.Tensor,
            comp_valid: torch.Tensor) -> torch.Tensor:
    BG, Ncb = c.shape[:2]
    Rg = counts_g.shape[1]
    tail = tuple(c.shape[2:])
    rayoff = torch.cumsum(counts_g, dim=-1, dtype=torch.int32) - counts_g
    sr = torch.arange(SR, dtype=torch.int32, device=c.device)
    rank = rayoff[:, :, None] + sr[None, None]
    take = torch.clamp(rank, 0, Ncb - 1).reshape(BG, Rg * SR).long()
    # a slot inside the buffer may lie past a piece's share (`row_share`)
    valid = (sr[None, None] < counts_g[:, :, None]) & (rank < Ncb) \
        & torch.gather(comp_valid, 1, take).reshape(BG, Rg, SR)
    goff = (torch.arange(BG, device=c.device) * Ncb)[:, None]
    out = c.reshape((BG * Ncb,) + tail)[(take + goff).reshape(-1)]
    out = out.reshape((BG, Rg * SR) + tail)
    out = torch.where(valid.reshape((BG, Rg * SR) + (1,) * len(tail)), out,
                      torch.zeros((), dtype=c.dtype, device=c.device))
    return out.reshape((BG, Rg, SR) + tail)


def scatter_row_valid(comp_src: torch.Tensor, comp_valid: torch.Tensor,
                      c_has: torch.Tensor, R: int, SR: int) -> torch.Tensor:
    """Per-slot has-neighbor bits back to [B,R,SR] (invalid slots dropped)."""
    B = comp_src.shape[0]
    RS = R * SR
    out = torch.zeros((B, RS + 1), dtype=torch.bool, device=comp_src.device)
    idx = torch.where(comp_valid, comp_src, RS).long()
    out.scatter_(1, idx, c_has & comp_valid)
    return out[:, :RS].reshape(B, R, SR)


def _topk_smallest(d2: torch.Tensor, k: int):
    """k smallest along the last axis, ties to the lower index — the order
    of `lax.top_k(-d2, k)` (torch.topk promises no tie order)."""
    vals, arg = torch.sort(d2, dim=-1, stable=True)
    return vals[..., :k], arg[..., :k]


def knn_neighbors_superset(sample_loc: torch.Tensor, sample_mask: torch.Tensor,
                           grid, spec: GridSpec, K: int) -> torch.Tensor:
    """Superset-bucket KNN: one super_xyz row gather per shading point.

    sample_loc [B,R,SR,3], sample_mask [B,R,SR]. Returns sample_pidx
    [B,R,SR,K] int32 (-1 = none)."""
    B, R, SR, _ = sample_loc.shape
    P2 = spec.superset_P
    S = B * R * SR
    coords, inb = voxel_coords(sample_loc, spec)
    lin = torch.where(inb, linearize(coords, spec), 0)
    slot = torch.where(inb & sample_mask, grid["coor_slot"][lin.long()], -1)
    rows = grid["super_xyz"][slot.clamp(min=0).reshape(-1).long()]  # [S,4·P2]
    loc = sample_loc.reshape(S, 3)
    sq = [torch.square(rows[:, a * P2:(a + 1) * P2] - loc[:, a:a + 1])
          for a in range(3)]
    dxy2 = sq[0] + sq[1]
    d2 = dxy2 + sq[2]                                  # [S, P2]
    valid = (slot.reshape(S, 1) >= 0) & (d2 < 1.0e15)
    if spec.pers_metric:
        valid = _pers_caps(valid, dxy2, sq[2], spec)
    elif spec.radius_limit > 0:
        valid = valid & (d2 <= _r2(spec))
    d2 = torch.where(valid, d2, BIG)
    best_d, arg = _topk_smallest(d2, K)
    best_i = torch.gather(rows[:, 3 * P2:], 1, arg).to(torch.int32)
    return torch.where(best_d < BIG, best_i, -1).reshape(B, R, SR, K)


def knn_neighbors(sample_loc: torch.Tensor, sample_mask: torch.Tensor,
                  grid, spec: GridSpec, K: int,
                  priorities: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact K nearest points over the kernel_size³ voxel neighborhood
    (optionally culled to the query_max_voxels nearest voxel centers).

    sample_loc [B,R,SR,3], sample_mask [B,R,SR] → [B,R,SR,K] int32.

    priorities [B,R,SR,kernel³·P] (the frustum's NN ≤ 0 mode, reference
    query_rand_along_ray, query_point_indices.py:414-491): instead of the K
    nearest, the K cap-valid candidates of highest priority over the whole
    kernel window (no voxel cull) — with uniform draws, K picked uniformly
    without replacement. The JAX package draws them from its key; the
    caller passes them."""
    B, R, SR, _ = sample_loc.shape
    P = spec.P
    dev = sample_loc.device
    coords, _ = voxel_coords(sample_loc, spec)
    lx = (spec.kernel_size[0] + 1) // 2 - 1
    ax = np.arange(-lx, lx + 1)
    offs = host_const(np.stack(np.meshgrid(ax, ax, ax, indexing="ij"),
                               axis=-1).reshape(-1, 3), torch.int32, dev)
    O = offs.shape[0]
    vdim = host_const(spec.vdim, torch.int32, dev)
    c = coords[..., None, :] + offs                          # [B,R,SR,O,3]
    inb = torch.all((c >= 0) & (c < vdim), dim=-1)
    lin = torch.where(inb, linearize(c, spec), 0)
    slot = torch.where(inb & sample_mask[..., None],
                       grid["coor_2_occ"][lin.long()], -1)   # [B,R,SR,O]
    T = spec.query_max_voxels if priorities is None else 0
    if 0 < T < O:
        mn = host_const(spec.ranges_min, torch.float32, dev)
        vs = host_const(spec.scaled_vsize, torch.float32, dev)
        diff = fma(c.float() + 0.5, vs, mn) - sample_loc[..., None, :]
        dc = fma(diff[..., 2], diff[..., 2],
                 fma(diff[..., 1], diff[..., 1], diff[..., 0] * diff[..., 0]))
        dc = torch.where(slot >= 0, dc, BIG)
        _, vox_arg = _topk_smallest(dc, T)
        slot = torch.gather(slot, -1, vox_arg)
        O = T
    rows = grid["occ_2_xyz"].reshape(spec.max_o, P * 4)[
        slot.clamp(min=0).reshape(-1).long()].reshape(B, R, SR, O, P, 4)
    cand_idx = rows[..., 3].to(torch.int32).reshape(B, R, SR, O * P)
    diff = rows[..., :3] - sample_loc[..., None, None, :]
    d2 = fma(diff[..., 2], diff[..., 2],
             fma(diff[..., 1], diff[..., 1], diff[..., 0] * diff[..., 0]))
    valid = (slot[..., None] >= 0) & (d2 < 1.0e15)
    if spec.pers_metric:
        dz2 = diff[..., 2] * diff[..., 2]
        valid = _pers_caps(valid, fma(diff[..., 1], diff[..., 1], diff[..., 0]
                                      * diff[..., 0]), dz2, spec)
    elif spec.radius_limit > 0:
        valid = valid & (d2 <= _r2(spec))
    d2 = torch.where(valid, d2, BIG).reshape(B, R, SR, O * P)
    if priorities is not None:
        score = torch.where(d2 < BIG, priorities, -1.0)
        top, arg = torch.sort(score, dim=-1, descending=True, stable=True)
        top, arg = top[..., :K], arg[..., :K]
        best_i = torch.gather(cand_idx, -1, arg)
        return torch.where(top >= 0.0, best_i, -1)
    best_d, arg = _topk_smallest(d2, K)
    best_i = torch.gather(cand_idx, -1, arg)
    return torch.where(best_d < BIG, best_i, -1)


def query_grid_points(campos: torch.Tensor, raydir: torch.Tensor,
                      tvals: torch.Tensor, grid, spec: GridSpec, SR: int,
                      K: int, Nc: int = 0, G: int = 1, Ncb: int = 0):
    """Full query pipeline (reference host orchestration cu:305-433).

    campos [B,3], raydir [B,R,3], tvals [B,R,D] ray-march depths. The
    occupancy test and the shading-point select are one `occupancy_select`
    (K3 on the card): exact and without a row budget, so the JAX package's
    `occ_segments` option has nothing to choose here.

    Compaction: each batch row's R rays split into G contiguous groups
    (opt.comp_groups), and each group's occupancy-valid shading rows are
    packed, in row order, into a budget of Ncb rows; the KNN runs on those
    rows only, and rows past a group's budget get no neighbors and count in
    q_overflow. Nc > 0 (below B·R·SR) gives Ncb = ceil(Nc / (B·G)), the
    JAX package's split of a global budget; Ncb > 0 gives the per-group
    budget itself (a ray shard's, `models.renderer.comp_budget`). A G that
    does not divide R raises ValueError.

    Returns (sample_pidx [B,R,SR,K] or None, sample_loc_w [B,R,SR,3],
    ray_mask [B,R] bool, q_overflow [] int32, comp, occ_overflow [] int32);
    with the budget active, sample_pidx is None and comp = (comp_src
    [B·G,Ncb] rows within the group, comp_valid [B·G,Ncb], c_pidx
    [B·G,Ncb,K], row_valid [B,R,SR], counts [B·G,R/G]).
    """
    sample_loc_w, sample_mask, counts, occ_overflow = occupancy_select(
        campos, raydir, tvals, grid, spec, SR)
    B, R = raydir.shape[0], raydir.shape[1]
    S = B * R * SR

    def knn(loc, mask):
        if spec.superset_P > 0:
            return knn_neighbors_superset(loc, mask, grid, spec, K)
        return knn_neighbors(loc, mask, grid, spec, K)

    G = max(1, int(G))
    if Ncb <= 0 and 0 < Nc < S:
        Ncb = -(-Nc // (B * G))
    if Ncb > 0:
        if R % G:
            raise ValueError(f"comp_groups={G} must divide the per-camera "
                             f"ray count R={R}")
        BG, Rg = B * G, R // G
        comp_src, comp_valid, n_total = compact_row_map(
            counts.reshape(BG, Rg), Ncb, SR)
        goff = (torch.arange(BG, device=tvals.device) * (Rg * SR))[:, None]
        c_loc = sample_loc_w.reshape(S, 3)[(comp_src + goff).reshape(-1)]
        c_loc = c_loc.reshape(BG, Ncb, 3)
        c_pidx = knn(c_loc[:, :, None, :], comp_valid[:, :, None])[:, :, 0]
        c_pidx = torch.where(comp_valid[..., None], c_pidx, -1)
        c_has = comp_valid & torch.any(c_pidx >= 0, dim=-1)
        row_valid = scatter_row_valid(comp_src, comp_valid, c_has, Rg,
                                      SR).reshape(B, R, SR)
        ray_mask = torch.any(row_valid, dim=-1)
        q_overflow = torch.clamp(n_total - Ncb, min=0).sum(dtype=torch.int32)
        comp = (comp_src, comp_valid, c_pidx, row_valid,
                counts.reshape(BG, Rg))
        return None, sample_loc_w, ray_mask, q_overflow, comp, occ_overflow

    sample_pidx = knn(sample_loc_w, sample_mask)
    ray_mask = torch.any(sample_pidx.reshape(B, R, -1) >= 0, dim=-1)
    q_overflow = torch.zeros((), dtype=torch.int32, device=tvals.device)
    return sample_pidx, sample_loc_w, ray_mask, q_overflow, None, occ_overflow
