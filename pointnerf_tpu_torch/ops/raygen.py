"""Ray sample generation along camera rays (port of `pointnerf_tpu/ops/raygen.py`).

Shapes: campos [B,3]; raydir [B,R,3]; outputs raypos [B,R,S,3],
segment_length [B,R,S], valid [B,R,S], ts [B,R,S]. Serving samples without
jitter (the JAX renderer passes jitter 0 at eval); the training-time jitter
comes with the train step.

The depths are the same for every ray, so they are computed once on the
host in float32, in the order XLA evaluates the JAX generator
(`jnp.linspace` as iota times the reciprocal step count, ``near·(1-t) +
far·t`` as one fused multiply-add, the cumulative sum blocked as XLA
blocks it). The depths then equal the JAX package's bit for bit on any
device, which keeps the occupancy test and the neighbor search exact.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .grid import fma

Arrays4 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

_f32 = np.float32


def _fma(a, b, c) -> np.ndarray:
    """float32 a·b + c with one rounding (see ops.grid.fma)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(_f32)


def _cumsum(x: np.ndarray, base: int = 16) -> np.ndarray:
    """float32 inclusive prefix sum in XLA's order for a long cumulative
    window: sequential sums inside blocks of `base`, the block totals scanned
    the same way one level up, and each block's exclusive offset added last.
    """
    n = x.shape[0]
    if n <= base:
        return np.cumsum(x, dtype=_f32)
    m = -(-n // base)
    blocks = np.zeros(m * base, _f32)
    blocks[:n] = x
    inner = np.cumsum(blocks.reshape(m, base), axis=1, dtype=_f32)
    offs = np.concatenate([np.zeros(1, _f32), _cumsum(inner[:, -1], base)[:-1]])
    return (inner + offs[:, None]).reshape(-1)[:n]


def _linspace01(point_count: int) -> np.ndarray:
    return np.arange(point_count + 1, dtype=_f32) * (_f32(1) / _f32(point_count))


def _march(campos, raydir, tvals: np.ndarray, point_count, near,
           scale_by_norm: bool) -> Arrays4:
    B, R, _ = raydir.shape
    dev = raydir.device
    seg = tvals[1:] - tvals[:-1]                                # [S]
    end_ts = _f32(near) + np.concatenate([np.zeros(1, _f32), _cumsum(seg)])
    mid = _f32(0.5) * (end_ts[:-1] + end_ts[1:])
    seg = torch.as_tensor(seg, device=dev).expand(B, R, point_count)
    mid_ts = torch.as_tensor(mid, device=dev).expand(B, R, point_count)
    raypos = fma(raydir[:, :, None, :], mid_ts[..., None],
                 campos[:, None, None, :])
    valid = torch.ones_like(mid_ts)
    if scale_by_norm:
        seg = seg * torch.linalg.norm(raydir, dim=-1)[..., None]
    return raypos, seg, valid, mid_ts


def near_far_linear_ray_generation(campos, raydir, point_count, near=0.1,
                                   far=10.0, **_) -> Arrays4:
    """Uniform-in-depth samples (reference: diff_ray_marching.py:349-392)."""
    t = _linspace01(point_count)
    tvals = _fma(_f32(far), t, _f32(near) * (_f32(1) - t))
    return _march(campos, raydir, tvals, point_count, near, True)


def near_far_disparity_linear_ray_generation(campos, raydir, point_count,
                                             near=0.1, far=10.0,
                                             **_) -> Arrays4:
    """Uniform-in-disparity samples (reference: :201-249). The reference
    does not scale the segments by |raydir| here (it is unit)."""
    t = _linspace01(point_count)
    inv_n, inv_f = _f32(1) / _f32(near), _f32(1) / _f32(far)
    tvals = _f32(1) / _fma(inv_f, t, inv_n * (_f32(1) - t))
    return _march(campos, raydir, tvals, point_count, near, False)


_GENERATORS = {
    "near_far_linear": near_far_linear_ray_generation,
    "near_far_disparity_linear": near_far_disparity_linear_ray_generation,
}


def find_ray_generation_method(name: str):
    """Registry lookup (reference: diff_ray_marching.py:7-21)."""
    if name not in _GENERATORS:
        raise RuntimeError(f"No such ray generation method: {name}")
    return _GENERATORS[name]
