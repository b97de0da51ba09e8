"""Perspective-frustum querier (port of `pointnerf_tpu/ops/frustum.py`; the
reference's wcoord_query 0 default path).

Reference: models/neural_points/query_point_indices.py — get_hyperparameters
(:49-76, frustum ranges from the intrinsics), the per-frame perspective
voxel grid and its kernels (:265-560), the shpnt_jitter z jitter (:104-116)
and pers2w (:93-101).

In perspective coordinates (x/z, y/z, z) every pixel ray is an axis-aligned
column at constant (x/z, y/z), so the querier is the world path's grid
builder and KNN over a frustum `GridSpec`: ranges from the intrinsics, vdim
= (W, H, z_depth_dim) / vscale, and the perspective metric (an xy radius
cap and a z depth cap, `pers_metric`). The grid is built per camera. With
`inverse 1` the z axis buckets in disparity (`GridSpec.inv_z`); positions
and distances stay true z.

JAX computes the frustum occupancy in XLA, outside Pallas; so does the port,
in plain PyTorch on the rays' device (the world path's K3 takes the
``campos + raydir·t`` form, which has no per-ray column origin). Integer
outputs (grid tables, neighbor indices, masks, q_overflow) equal JAX's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .camera import dot3, pers2w
from .grid import GridSpec, build_grid, fma
from .query import (Shards, compact_row_map, knn_neighbors,
                    knn_neighbors_superset, mask_raypos, row_share,
                    scatter_row_valid)

SENTINEL = 1.0e6


def make_frustum_spec(opt, intrinsic: np.ndarray, w: int, h: int,
                      near: float, far: float) -> GridSpec:
    """Frustum grid geometry (reference get_hyperparameters :49-76):
    perspective ranges from the principal point and focal lengths, vdim the
    image resolution × z_depth_dim downscaled by opt.vscale."""
    K = np.asarray(intrinsic, np.float64)
    x_rl, x_rh = -K[0, 2] / K[0, 0], (w - K[0, 2]) / K[0, 0]
    y_rl, y_rh = -K[1, 2] / K[1, 1], (h - K[1, 2]) / K[1, 1]
    inv = opt.inverse > 0
    # inverse mode: z buckets in disparity, ranges [1/far, 1/near]
    z_lo, z_hi = (1.0 / far, 1.0 / near) if inv else (near, far)
    ranges = np.array([x_rl, y_rl, z_lo, x_rh, y_rh, z_hi], np.float64)
    vdim = np.array([w, h, opt.z_depth_dim], np.int64)
    vsize = (ranges[3:] - ranges[:3]) / vdim
    vscale = np.asarray(opt.vscale, np.float64)
    scaled_vdim = np.ceil(vdim / vscale).astype(np.int64)
    scaled_vsize = vsize * vscale
    max_o = opt.max_o if (opt.max_o or 0) > 0 else int(np.prod(scaled_vdim))
    return GridSpec(
        ranges_min=tuple(float(v) for v in ranges[:3]),
        scaled_vsize=tuple(float(v) for v in scaled_vsize),
        vdim=tuple(int(v) for v in scaled_vdim),
        max_o=int(max_o),
        P=int(opt.P),
        kernel_size=tuple(int(k) for k in opt.kernel_size),
        query_size=tuple(int(q) for q in opt.effective_query_size),
        radius_limit=float(opt.radius_limit_scale * max(vsize[0], vsize[1])),
        vsize=tuple(float(v) for v in vsize),
        # voxel-center culling and the supersets rank by disparity-space
        # centers under inv_z, so both are off there
        query_max_voxels=0 if inv else int(getattr(opt, "query_max_voxels",
                                                   0)),
        superset_P=0 if inv else int(getattr(opt, "frustum_superset_P", 0)),
        superset_pad=(0, 0, opt.effective_query_size[2] // 2),
        depth_limit=float(opt.depth_limit_scale * vsize[2]),
        pers_metric=True,
        inv_z=inv,
    )


def pers_points(xyz_w: torch.Tensor, camrotc2w: torch.Tensor,
                campos: torch.Tensor) -> torch.Tensor:
    """[N,3] world points → (x/z, y/z, z) in one camera's frame, rounded
    as JAX's `w2pers` (the grid's voxel coordinates must equal JAX's).
    Points at or behind the camera plane (z ≤ 1e-9) park at SENTINEL, so
    the grid builder drops them."""
    shift = xyz_w - campos.reshape(3)
    rot = camrotc2w.reshape(3, 3)
    x, y, z = (dot3(shift, rot, i, transpose=True) for i in range(3))
    p = torch.stack([x / z, y / z, z], dim=-1)
    return torch.where((z <= 1e-9)[..., None], SENTINEL, p)


def build_frustum_grid(xyz_w: torch.Tensor, point_mask: torch.Tensor,
                       camrotc2w: torch.Tensor, campos: torch.Tensor,
                       spec: GridSpec):
    """One camera's perspective grid (the reference rebuilds it per query,
    :92-94). Returns (grid, xyz_pers)."""
    xyz_pers = pers_points(xyz_w, camrotc2w, campos)
    return build_grid(xyz_pers, point_mask, spec), xyz_pers


def jitter_z(sample_loc: torch.Tensor, mode: str, vsize_z: float,
             u: Optional[torch.Tensor]) -> torch.Tensor:
    """shpnt_jitter: the train-time z perturbation of the shading locations
    in perspective space (reference :104-116, the unscaled voxel size). u:
    the draws [B,R,SR] — uniform in [0, 1) for "uniform", standard normal
    for "gaussian"; the JAX package draws them from its key."""
    if mode == "passfunc" or u is None:
        return sample_loc
    if mode == "gaussian":
        j = torch.clamp(u * (vsize_z / 4.0), -vsize_z / 2.0, vsize_z / 2.0)
    elif mode == "uniform":
        j = (u - 0.5) * vsize_z
    else:
        raise ValueError(f"unknown shpnt_jitter {mode}")
    z = sample_loc[..., 2] + j
    return torch.cat([sample_loc[..., :2], z[..., None]], dim=-1)


def draw_jitter(mode: str, shape, generator: torch.Generator, device
                ) -> Optional[torch.Tensor]:
    """The shpnt_jitter draws for one query ([B,R,SR]), or None."""
    if mode == "uniform":
        return torch.rand(shape, generator=generator, device=device)
    if mode == "gaussian":
        return torch.randn(shape, generator=generator, device=device)
    return None


def camera_columns(raydir: torch.Tensor, camrotc2w: torch.Tensor):
    """World ray dirs [B,R,3] → (x/z [B,R], y/z [B,R], camera-frame z of
    the dir [B,R]): the ray's perspective column. No pixel index is
    needed; any world direction works."""
    dc = [dot3(raydir, camrotc2w, i, transpose=True) for i in range(3)]
    fwd = dc[2]
    safe_z = torch.where(torch.abs(fwd) > 1e-9, fwd, 1.0)
    return dc[0] / safe_z, dc[1] / safe_z, fwd


def column_depths(spec: GridSpec, device) -> torch.Tensor:
    """The D scaled z-voxel centers of a column [D], near to far. inv_z:
    centers uniform in disparity, walked in descending disparity so true z
    ascends."""
    D = spec.vdim[2]
    mn, svs = float(np.float32(spec.ranges_min[2])), \
        float(np.float32(spec.scaled_vsize[2]))
    if spec.inv_z:
        k = torch.arange(D - 1, -1, -1, dtype=torch.float32, device=device)
        return 1.0 / fma(k + 0.5, svs, mn)
    k = torch.arange(D, dtype=torch.float32, device=device)
    return fma(k + 0.5, svs, mn)


def select_shading_points(raypos: torch.Tensor, valid: torch.Tensor,
                          SR: int):
    """The first ≤SR valid samples of each ray, in order, as [B,R,SR,3]
    (zeros past the count) and their mask [B,R,SR] (reference cu:192-214)."""
    B, R, D, _ = raypos.shape
    cum = torch.cumsum(valid.to(torch.int32), dim=-1, dtype=torch.int32)
    slot = torch.where(valid & (cum <= SR), cum - 1, SR).long()
    src = torch.zeros((B, R, SR + 1), dtype=torch.int64, device=raypos.device)
    depth = torch.arange(D, device=raypos.device).expand(B, R, D)
    src.scatter_(2, slot, depth)
    mask = torch.arange(SR, device=raypos.device) < cum[..., -1:]
    loc = torch.gather(raypos, 2, src[..., :SR, None].expand(B, R, SR, 3))
    return torch.where(mask[..., None], loc, 0.0), mask


def query_frustum_points(raydir: torch.Tensor, camrotc2w: torch.Tensor,
                         campos: torch.Tensor, xyz_pers: torch.Tensor, grid,
                         spec: GridSpec, SR: int, K: int,
                         jitter: str = "passfunc",
                         u: Optional[torch.Tensor] = None,
                         is_train: bool = False, Nc: int = 0,
                         rand_mode: bool = False,
                         priorities: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None,
                         shards: Optional[Shards] = None):
    """The full frustum query (reference query_points :80-101).

    raydir [B,R,3] world ray dirs, camrotc2w [B,3,3], campos [B,3];
    xyz_pers and grid from build_frustum_grid (B must be 1: one grid per
    camera). u: the shpnt_jitter draws [B,R,SR] at train (`jitter_z`).
    rand_mode (NN ≤ 0): K random cap-valid candidates of the kernel window
    in place of the K nearest (`knn_neighbors`), ranked by `priorities`
    [B,R,SR,kernel³·P] ([B,Ncb,1,kernel³·P] with the budget), drawn
    uniform from `generator` (a fixed seed 0 if None) when not given.

    Returns (sample_pidx [B,R,SR,K], sample_loc_w [B,R,SR,3],
    sample_ray_dirs [B,R,SR,3], ray_mask [B,R], q_overflow [] int32,
    comp). With 0 < Nc < B·R·SR the KNN runs on the first Nc valid shading
    rows only; sample_pidx is then None and comp = (comp_src, comp_valid,
    c_pidx, row_valid, counts), `query_grid_points`' contract, the rows
    past the budget counted in q_overflow.

    shards: these rays are a piece of a camera row's (`ops.query.Shards`).
    Nc is then the whole batch's budget and the camera row compacts into
    one budget of Ncb = ceil(Nc / B) rows across its pieces in ray order:
    this piece keeps its valid rows that follow fewer than Ncb valid rows
    of the row (`row_share`: one prefix over the pieces), into a buffer
    of its own, and q_overflow counts the rows it drops, so the pieces'
    counts sum to the whole row's. The priorities (given or drawn) are the
    whole row's, as one device draws them, and the piece takes its rows'.
    """
    B, R, _ = raydir.shape
    if B != 1 or camrotc2w.shape[0] != 1 or campos.shape[0] != 1:
        raise ValueError(
            f"query_frustum_points requires B == 1 (one perspective grid per "
            f"camera); got raydir batch {B}, camrotc2w batch "
            f"{camrotc2w.shape[0]}, campos batch {campos.shape[0]}")
    dev = raydir.device
    D = spec.vdim[2]
    xp, yp, fwd = camera_columns(raydir, camrotc2w)
    zc = column_depths(spec, dev)
    raypos = torch.stack([xp[..., None].expand(B, R, D),
                          yp[..., None].expand(B, R, D),
                          zc.expand(B, R, D)], dim=-1)          # [B,R,D,3]
    rp_valid = mask_raypos(raypos, grid, spec) & (fwd > 1e-9)[..., None]
    sample_loc, sample_mask = select_shading_points(raypos, rp_valid, SR)
    del raypos, rp_valid

    whole = shards is not None and shards.prefix is not None
    Bw, Rw = (B * shards.batch, R * shards.rays) if whole else (B, R)

    def knn(loc, mask, take=None):
        # the KNN runs on the unjittered locations (reference ordering:
        # query_grid_point_index, then shpnt_jitter, :92-99); take = (the
        # row's budget slot of this piece's first kept row [B], Ncb) under
        # the budget
        if rand_mode:
            pri = priorities
            if pri is None:
                O = spec.kernel_size[0] ** 3
                gen = generator or torch.Generator(device=dev).manual_seed(0)
                n = (Bw, take[1], 1) if take is not None else (Bw, Rw, SR)
                pri = torch.rand(n + (O * spec.P,), generator=gen,
                                 device=dev)
            if take is not None and whole:     # this piece's budget rows
                idx = torch.clamp(take[0] + torch.arange(
                    loc.shape[1], device=dev)[None], max=take[1] - 1)
                pri = torch.gather(pri, 1, idx.long()[:, :, None, None]
                                   .expand((B, loc.shape[1]) + pri.shape[2:]))
            elif whole:                        # this piece's rays
                pri = pri[:, shards.index * R:(shards.index + 1) * R]
            return knn_neighbors(loc, mask, grid, spec, K, priorities=pri)
        if spec.superset_P > 0:
            return knn_neighbors_superset(loc, mask, grid, spec, K)
        return knn_neighbors(loc, mask, grid, spec, K)

    S = B * R * SR
    q_overflow = torch.zeros((), dtype=torch.int32, device=dev)
    comp = None
    if 0 < Nc < Bw * Rw * SR:
        Ncb = -(-Nc // Bw)
        counts = sample_mask.sum(dim=-1, dtype=torch.int32)           # [B,R]
        limit, rows = row_share(counts.sum(dim=1, dtype=torch.int32), Ncb,
                                shards)
        comp_src, comp_valid, n_total = compact_row_map(counts, rows, SR,
                                                        limit)
        c_loc = sample_loc.reshape(S, 3)[comp_src.reshape(-1).long()]
        c_loc = c_loc.reshape(B, rows, 3)
        # the row's budget rows the pieces before this one keep: its kept
        # rows take the budget slots from there
        first = (Ncb - limit)[:, 0] if whole else None
        c_pidx = knn(c_loc[:, :, None, :], comp_valid[:, :, None],
                     (first, Ncb))[:, :, 0]
        c_pidx = torch.where(comp_valid[..., None], c_pidx, -1)
        c_has = comp_valid & torch.any(c_pidx >= 0, dim=-1)
        row_valid = scatter_row_valid(comp_src, comp_valid, c_has, R, SR)
        ray_mask = torch.any(row_valid, dim=-1)
        q_overflow = torch.clamp(n_total[:, None] - limit, min=0).sum(
            dtype=torch.int32)
        comp = (comp_src, comp_valid, c_pidx, row_valid, counts)
        sample_pidx = None
    else:
        sample_pidx = knn(sample_loc, sample_mask)
        ray_mask = torch.any(sample_pidx.reshape(B, R, -1) >= 0, dim=-1)
    if is_train:
        sample_loc = jitter_z(sample_loc, jitter, spec.vsize[2], u)

    # perspective → world; per-sample ray dirs recomputed from the
    # positions (reference pers2w :93-101), not the input raydir
    sample_loc_w = pers2w(sample_loc, camrotc2w, campos)
    shift = sample_loc_w - campos.reshape(B, 1, 1, 3)
    sample_ray_dirs = shift / (torch.linalg.norm(shift, dim=-1, keepdim=True)
                               + 1e-7)
    sample_loc_w = torch.where(sample_mask[..., None], sample_loc_w, 0.0)
    return (sample_pidx, sample_loc_w, sample_ray_dirs, ray_mask, q_overflow,
            comp)
