"""Ray → shading point → neighbor query over the voxel grid.

PyTorch port of `pointnerf_tpu/ops/query.py` (world-coordinate path, one
compaction group). Where the JAX version shaped work around the TPU — one-hot
lane selects, [B,R,D,SR] indicator contractions, count-compare maps — the
port does the direct GPU thing with the same outputs: gathers, scatters and
`searchsorted`. Integer outputs (masks, neighbor indices, counters) equal
the JAX package's exactly.

The occupancy test `mask_raypos_segmented` launches the CUDA kernel
`csrc/occupancy.cu` on CUDA tensors; its plain version is the dense
`mask_raypos`. `row_select`, the per-sample select of the segment-cached
occupancy experiment (`pointnerf_tpu_torch/scripts/occ_micro3.py`; no
production path runs it), launches `csrc/row_select.cu`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import kernels
from .grid import GridSpec, fma, grid_consts, linearize, voxel_coords

BIG = 3.0e38


def ray_points(campos: torch.Tensor, raydir: torch.Tensor,
               tvals: torch.Tensor) -> torch.Tensor:
    """campos [B,3] + raydir [B,R,3] · t [B,R,D] → [B,R,D,3], rounded once
    per coordinate as XLA's fused multiply-add rounds it."""
    return fma(raydir[:, :, None, :], tvals[..., None], campos[:, None, None, :])


def _r2(spec: GridSpec) -> float:
    """The squared radius limit, rounded to float32 as the comparison
    against float32 distances rounds it."""
    return float(np.float32(spec.radius_limit * spec.radius_limit))


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
    past U. The port looks every sample up directly (`csrc/occupancy.cu` on
    CUDA tensors, dense `mask_raypos` on CPU tensors), so it is exact — equal
    to the dense mask everywhere — and has no budget: the second return,
    the number of rays past the row budget (`occ_overflow`), is always 0.

    Returns (valid [B,R,D] bool, n_overflow [] int32).
    """
    n_over = torch.zeros((), dtype=torch.int32, device=tvals.device)
    if tvals.device.type == "cpu":
        return mask_raypos(ray_points(campos, raydir, tvals), grid, spec), \
            n_over
    return _occupancy_launch(campos, raydir, tvals, grid, spec), n_over


def _occupancy_launch(campos, raydir, tvals, grid, spec: GridSpec):
    dev = tvals.device
    if dev.type != "cuda":
        raise ValueError(f"occupancy runs on cpu or cuda, not {dev}")
    B, R, D = tvals.shape
    rows = grid["coor_occ_rows"]
    kernels.require(campos, "campos", torch.float32, dev, (B, 3))
    kernels.require(raydir, "raydir", torch.float32, dev, (B, R, 3))
    kernels.require(rows, "coor_occ_rows", torch.int8, dev)
    if tvals.dtype != torch.float32 or tvals.device != dev:
        raise ValueError("tvals must be float32 on the rays' device")
    if rows.numel() < spec.grid_size_vol:
        raise ValueError("coor_occ_rows is smaller than the grid volume")
    out = torch.empty((B, R, D), dtype=torch.bool, device=dev)
    mn, inv = (v.tolist() for v in grid_consts(spec, "cpu"))
    sb, sr, sd = tvals.stride()
    lib = kernels.library()
    err = lib.occupancy(campos.data_ptr(), raydir.data_ptr(), tvals.data_ptr(),
                        rows.data_ptr(), out.data_ptr(), sb, sr, sd, B, R, D,
                        *mn, *inv, *spec.vdim, kernels.stream_handle(tvals))
    kernels.check(err, kernels.OCCUPANCY)
    kernels.OCCUPANCY.launches += 1
    return out


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
    `scripts/occ_micro3.py::run_kernel`) with `rays_per_cta` rays per CTA
    (the TPU's Rt); on CPU tensors it runs `row_select_reference`."""
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
    rank = rank.to(torch.int32).contiguous()
    lane = lane.to(torch.int32).contiguous()
    kernels.require(rank, "rank", torch.int32, dev, (N, D))
    kernels.require(lane, "lane", torch.int32, dev, (N, D))
    out = torch.empty((N, D), dtype=torch.float32, device=dev)
    err = kernels.library().row_select(
        rows_g.data_ptr(), rank.data_ptr(), lane.data_ptr(), out.data_ptr(),
        N, D, U, LW, rows_g.stride(0), int(rays_per_cta),
        codes[rows_g.dtype], kernels.stream_handle(rank))
    kernels.check(err, kernels.ROW_SELECT)
    kernels.ROW_SELECT.launches += 1
    return out


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


def compact_row_map(counts: torch.Tensor, Ncb: int, SR: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-ray valid-row counts [B,R] → (comp_src [B,Ncb] flat ray·SR+slot
    source rows, comp_valid [B,Ncb], n_total [B]). Slot s belongs to the last
    ray r with rayoff[r] ≤ s; slots ≥ n_total hold clamped garbage."""
    B, R = counts.shape
    rayoff = torch.cumsum(counts, dim=-1, dtype=torch.int32) - counts
    n_total = rayoff[:, -1] + counts[:, -1]
    slots = torch.arange(Ncb, dtype=torch.int32, device=counts.device)
    c_ray = torch.searchsorted(rayoff.contiguous(),
                               slots.expand(B, Ncb).contiguous(),
                               right=True) - 1
    c_s = slots[None] - torch.gather(rayoff, 1, c_ray)
    comp_src = torch.clamp(c_ray.to(torch.int32) * SR + c_s, 0, R * SR - 1)
    comp_valid = slots[None] < torch.clamp(n_total[:, None], max=Ncb)
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
    return _expand(SR, c, counts_g)


class _ExpandCompacted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, SR, c, counts_g, comp_src, comp_valid):
        ctx.save_for_backward(comp_src, comp_valid)
        return _expand(SR, c, counts_g)

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


def _expand(SR: int, c: torch.Tensor, counts_g: torch.Tensor) -> torch.Tensor:
    BG, Ncb = c.shape[:2]
    Rg = counts_g.shape[1]
    tail = tuple(c.shape[2:])
    rayoff = torch.cumsum(counts_g, dim=-1, dtype=torch.int32) - counts_g
    sr = torch.arange(SR, dtype=torch.int32, device=c.device)
    rank = rayoff[:, :, None] + sr[None, None]
    valid = (sr[None, None] < counts_g[:, :, None]) & (rank < Ncb)
    take = torch.clamp(rank, 0, Ncb - 1).reshape(BG, Rg * SR).long()
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
    if spec.pers_metric:
        raise NotImplementedError("the frustum metric is not ported")
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
    d2 = (sq[0] + sq[1]) + sq[2]                       # [S, P2]
    valid = (slot.reshape(S, 1) >= 0) & (d2 < 1.0e15)
    if spec.radius_limit > 0:
        valid = valid & (d2 <= _r2(spec))
    d2 = torch.where(valid, d2, BIG)
    best_d, arg = _topk_smallest(d2, K)
    best_i = torch.gather(rows[:, 3 * P2:], 1, arg).to(torch.int32)
    return torch.where(best_d < BIG, best_i, -1).reshape(B, R, SR, K)


def knn_neighbors(sample_loc: torch.Tensor, sample_mask: torch.Tensor,
                  grid, spec: GridSpec, K: int) -> torch.Tensor:
    """Exact K nearest points over the kernel_size³ voxel neighborhood
    (optionally culled to the query_max_voxels nearest voxel centers).

    sample_loc [B,R,SR,3], sample_mask [B,R,SR] → [B,R,SR,K] int32."""
    if spec.pers_metric:
        raise NotImplementedError("the frustum metric is not ported")
    B, R, SR, _ = sample_loc.shape
    P = spec.P
    dev = sample_loc.device
    coords, _ = voxel_coords(sample_loc, spec)
    lx = (spec.kernel_size[0] + 1) // 2 - 1
    ax = np.arange(-lx, lx + 1)
    offs = torch.as_tensor(np.stack(np.meshgrid(ax, ax, ax, indexing="ij"),
                                    axis=-1).reshape(-1, 3).astype(np.int32),
                           device=dev)
    O = offs.shape[0]
    vdim = torch.tensor(spec.vdim, dtype=torch.int32, device=dev)
    c = coords[..., None, :] + offs                          # [B,R,SR,O,3]
    inb = torch.all((c >= 0) & (c < vdim), dim=-1)
    lin = torch.where(inb, linearize(c, spec), 0)
    slot = torch.where(inb & sample_mask[..., None],
                       grid["coor_2_occ"][lin.long()], -1)   # [B,R,SR,O]
    T = spec.query_max_voxels
    if 0 < T < O:
        mn = torch.tensor(spec.ranges_min, dtype=torch.float32, device=dev)
        vs = torch.tensor(spec.scaled_vsize, dtype=torch.float32, device=dev)
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
    if spec.radius_limit > 0:
        valid = valid & (d2 <= _r2(spec))
    d2 = torch.where(valid, d2, BIG).reshape(B, R, SR, O * P)
    best_d, arg = _topk_smallest(d2, K)
    best_i = torch.gather(cand_idx, -1, arg)
    return torch.where(best_d < BIG, best_i, -1)


def query_grid_points(campos: torch.Tensor, raydir: torch.Tensor,
                      tvals: torch.Tensor, grid, spec: GridSpec, SR: int,
                      K: int, Nc: int = 0):
    """Full query pipeline (reference host orchestration cu:305-433).

    campos [B,3], raydir [B,R,3], tvals [B,R,D] ray-march depths. The
    occupancy test is always `mask_raypos_segmented`: exact and without a
    row budget, so the JAX package's `occ_segments` option has nothing to
    choose here. Nc > 0: the KNN runs only on the first Ncb = ceil(Nc/B)
    occupancy-valid shading rows of each batch row; rows past the budget
    get no neighbors and count in q_overflow.

    Returns (sample_pidx [B,R,SR,K] or None, sample_loc_w [B,R,SR,3],
    ray_mask [B,R] bool, q_overflow [] int32, comp, occ_overflow [] int32);
    with the budget active, sample_pidx is None and comp = (comp_src
    [B,Ncb], comp_valid [B,Ncb], c_pidx [B,Ncb,K], row_valid [B,R,SR],
    counts [B,R]).
    """
    rp_valid, occ_overflow = mask_raypos_segmented(campos, raydir, tvals,
                                                   grid, spec)
    t_sel, sample_mask, counts = select_shading_t(tvals, rp_valid, SR)
    sample_loc_w = torch.where(sample_mask[..., None],
                               ray_points(campos, raydir, t_sel), 0.0)
    B, R = raydir.shape[0], raydir.shape[1]
    S = B * R * SR
    RS = R * SR

    def knn(loc, mask):
        if spec.superset_P > 0:
            return knn_neighbors_superset(loc, mask, grid, spec, K)
        return knn_neighbors(loc, mask, grid, spec, K)

    if 0 < Nc < S:
        Ncb = -(-Nc // B)
        comp_src, comp_valid, n_total = compact_row_map(counts, Ncb, SR)
        goff = (torch.arange(B, device=tvals.device) * RS)[:, None]
        c_loc = sample_loc_w.reshape(S, 3)[(comp_src + goff).reshape(-1)]
        c_loc = c_loc.reshape(B, Ncb, 3)
        c_pidx = knn(c_loc[:, :, None, :], comp_valid[:, :, None])[:, :, 0]
        c_pidx = torch.where(comp_valid[..., None], c_pidx, -1)
        c_has = comp_valid & torch.any(c_pidx >= 0, dim=-1)
        row_valid = scatter_row_valid(comp_src, comp_valid, c_has, R, SR)
        ray_mask = torch.any(row_valid, dim=-1)
        q_overflow = torch.clamp(n_total - Ncb, min=0).sum(dtype=torch.int32)
        comp = (comp_src, comp_valid, c_pidx, row_valid, counts)
        return None, sample_loc_w, ray_mask, q_overflow, comp, occ_overflow

    sample_pidx = knn(sample_loc_w, sample_mask)
    ray_mask = torch.any(sample_pidx.reshape(B, R, -1) >= 0, dim=-1)
    q_overflow = torch.zeros((), dtype=torch.int32, device=tvals.device)
    return sample_pidx, sample_loc_w, ray_mask, q_overflow, None, occ_overflow
