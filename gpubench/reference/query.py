"""Ray samples, the occupancy test and the neighbor search, plain.

A frozen copy of the plain path of the port's query (`ops/raygen.py`'s
near/far linear depths with the train jitter, `ops/query.py`'s dense
occupancy mask, first-SR select and superset KNN), with the float32
rounding of each step kept, so that which samples are occupied and which
points are neighbors equals the port's. It imports nothing of the port.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .grid import Spec, fma, linearize, voxel_coords

BIG = 3.0e38
TRAIN_JITTER = 0.3
CUMSUM_BLOCK = 16
_f32 = np.float32


def _scan(x: torch.Tensor) -> torch.Tensor:
    out = [x[..., 0]]
    for j in range(1, x.shape[-1]):
        out.append(out[-1] + x[..., j])
    return torch.stack(out, dim=-1)


def _cumsum(x: torch.Tensor, base: int = CUMSUM_BLOCK) -> torch.Tensor:
    """Prefix sum in blocks of `base`, block totals one level up, each
    block's offset added last."""
    n = x.shape[-1]
    if n <= base:
        return _scan(x)
    m = -(-n // base)
    blocks = torch.nn.functional.pad(x, (0, m * base - n))
    inner = _scan(blocks.reshape(x.shape[:-1] + (m, base)))
    tot = _cumsum(inner[..., -1], base)
    offs = torch.cat([torch.zeros_like(tot[..., :1]), tot[..., :-1]], dim=-1)
    return (inner + offs[..., None]).reshape(x.shape[:-1] + (m * base,))[
        ..., :n]


def march_depths(n: int, near: float, far: float) -> np.ndarray:
    """n segment lengths uniform in depth between near and far, then near."""
    t = np.arange(n + 1, dtype=_f32) * (_f32(1) / _f32(n))
    lin = (np.asarray(_f32(far), np.float64) * np.asarray(t, np.float64)
           + np.asarray(_f32(near) * (_f32(1) - t), np.float64)).astype(_f32)
    return np.append(lin[1:] - lin[:-1], _f32(near)).astype(_f32)


def sample_depths(raydir: torch.Tensor, n: int, near: float, far: float,
                  u: Optional[torch.Tensor]) -> torch.Tensor:
    """Midpoint depths [B,R,n] of the n segments, each scaled by
    1 + 0.3·(u - 0.5) when the train draws u [B,R,n] are given."""
    B, R, _ = raydir.shape
    dev = raydir.device
    dep = march_depths(n, near, far)
    near_f = float(dep[-1])
    seg = torch.as_tensor(dep[:-1], dtype=torch.float32, device=dev)
    if u is not None:
        if tuple(u.shape) != (B, R, n):
            raise ValueError(f"draws u must be {[B, R, n]}")
        seg = seg * fma(u - 0.5, float(_f32(TRAIN_JITTER)), 1.0)
    lead = seg.shape[:-1]
    end = torch.cat([torch.zeros(lead + (1,), device=dev), _cumsum(seg)],
                    dim=-1) + near_f
    return (0.5 * (end[..., :-1] + end[..., 1:])).expand(B, R, n)


def ray_points(campos, raydir, t):
    return fma(raydir[:, :, None, :], t[..., None], campos[:, None, None, :])


def occupied_samples(campos, raydir, tvals, grid: Dict, spec: Spec, SR: int):
    """Each ray's first ≤SR samples whose dilated voxel is occupied:
    (sample_loc_w [B,R,SR,3], sample_mask [B,R,SR])."""
    pos = ray_points(campos, raydir, tvals)
    coords, inb = voxel_coords(pos, spec)
    lin = torch.where(inb, linearize(coords, spec), 0)
    valid = (grid["coor_occ"][lin.long()] > 0) & inb
    B, R, D = valid.shape
    cum = torch.cumsum(valid.to(torch.int32), dim=-1, dtype=torch.int32)
    slot = torch.where(valid & (cum <= SR), cum - 1, SR).long()
    t_sel = torch.zeros((B, R, SR + 1), dtype=tvals.dtype, device=tvals.device)
    t_sel.scatter_(2, slot, tvals.expand(B, R, D))
    t_sel = t_sel[..., :SR]
    mask = torch.arange(1, SR + 1, device=valid.device) <= cum[..., -1:]
    loc = torch.where(mask[..., None], ray_points(campos, raydir, t_sel), 0.0)
    return loc, mask


def neighbors(loc: torch.Tensor, grid: Dict, spec: Spec, K: int
              ) -> torch.Tensor:
    """The K nearest candidates within radius_limit of each row's superset
    (the row's nearest occupied slot's), nearest first, ties to the lower
    candidate: loc [N,3] → point indices [N,K] int64, -1 where none."""
    P2 = spec.superset_P
    coords, inb = voxel_coords(loc, spec)
    lin = torch.where(inb, linearize(coords, spec), 0)
    slot = torch.where(inb, grid["coor_slot"][lin.long()], -1)
    rows = grid["super_xyz"][slot.clamp(min=0).long()]
    sq = [torch.square(rows[:, a * P2:(a + 1) * P2] - loc[:, a:a + 1])
          for a in range(3)]
    d2 = sq[0] + sq[1] + sq[2]
    r2 = float(_f32(spec.radius_limit * spec.radius_limit))
    valid = (slot[:, None] >= 0) & (d2 < 1.0e15) & (d2 <= r2)
    d2 = torch.where(valid, d2, BIG)
    best, arg = torch.sort(d2, dim=-1, stable=True)
    best, arg = best[:, :K], arg[:, :K]
    idx = torch.gather(rows[:, 3 * P2:], 1, arg).long()
    return torch.where(best < BIG, idx, -1)
