"""Ray sample generation along camera rays (port of `pointnerf_tpu/ops/raygen.py`).

Shapes: campos [B,3]; raydir [B,R,3]; outputs raypos [B,R,S,3],
segment_length [B,R,S], valid [B,R,S], ts [B,R,S].

The depths reproduce the JAX generator's float32 rounding, in the order XLA
evaluates it: `jnp.linspace` as iota times the reciprocal step count,
``near·(1-t) + far·t`` and the training jitter ``1 + j·(u - 0.5)`` each as
one fused multiply-add, and the cumulative sum blocked as XLA blocks it. The
depths then equal the JAX package's bit for bit on any device, which keeps
the occupancy test and the neighbor search exact. Without jitter every ray
shares the same depths, computed once and broadcast; with it (training,
``u`` [B,R,S] uniform in [0,1)) each ray's depths are summed on the rays'
device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .grid import fma, host_const

Arrays4 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

_f32 = np.float32
CUMSUM_BLOCK = 16      # XLA:CPU's block length for long cumulative sums


def _fma(a, b, c) -> np.ndarray:
    """float32 a·b + c with one rounding (see ops.grid.fma)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(_f32)


def _scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last axis, one addition at a time
    from the left, whatever the device."""
    out = [x[..., 0]]
    for j in range(1, x.shape[-1]):
        out.append(out[-1] + x[..., j])
    return torch.stack(out, dim=-1)


def _cumsum(x: torch.Tensor, base: int = CUMSUM_BLOCK) -> torch.Tensor:
    """float32 inclusive prefix sum along the last axis in XLA's order for
    a long cumulative window: sequential sums inside blocks of `base`, the
    block totals scanned the same way one level up, and each block's
    exclusive offset added last."""
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


def _linspace01(point_count: int) -> np.ndarray:
    return np.arange(point_count + 1, dtype=_f32) * (_f32(1) / _f32(point_count))


def _march(campos, raydir, tvals: np.ndarray, point_count, near,
           scale_by_norm: bool, jitter: float,
           u: Optional[torch.Tensor]) -> Arrays4:
    B, R, _ = raydir.shape
    dev = raydir.device
    seg = host_const(tvals[1:] - tvals[:-1], torch.float32, dev)   # [S]
    if jitter > 0.0 and u is not None:
        if tuple(u.shape) != (B, R, point_count) or u.device != dev:
            raise ValueError(f"jitter draws u must be [{B},{R},{point_count}]"
                             f" on {dev}")
        seg = seg * fma(u - 0.5, float(_f32(jitter)), 1.0)         # [B,R,S]
    lead = seg.shape[:-1]
    end_ts = torch.cat([torch.zeros(lead + (1,), device=dev),
                        _cumsum(seg)], dim=-1) + float(_f32(near))
    mid_ts = (0.5 * (end_ts[..., :-1] + end_ts[..., 1:])).expand(
        B, R, point_count)
    seg = seg.expand(B, R, point_count)
    raypos = fma(raydir[:, :, None, :], mid_ts[..., None],
                 campos[:, None, None, :])
    valid = torch.ones_like(mid_ts)
    if scale_by_norm:
        seg = seg * torch.linalg.norm(raydir, dim=-1)[..., None]
    return raypos, seg, valid, mid_ts


def near_far_linear_ray_generation(campos, raydir, point_count, near=0.1,
                                   far=10.0, jitter=0.0,
                                   u: Optional[torch.Tensor] = None,
                                   **_) -> Arrays4:
    """Uniform-in-depth samples (reference: diff_ray_marching.py:349-392);
    with jitter > 0 and draws u, each segment is scaled by
    1 + jitter·(u - 0.5)."""
    t = _linspace01(point_count)
    tvals = _fma(_f32(far), t, _f32(near) * (_f32(1) - t))
    return _march(campos, raydir, tvals, point_count, near, True, jitter, u)


def near_far_disparity_linear_ray_generation(campos, raydir, point_count,
                                             near=0.1, far=10.0, jitter=0.0,
                                             u: Optional[torch.Tensor] = None,
                                             **_) -> Arrays4:
    """Uniform-in-disparity samples (reference: :201-249). The reference
    does not scale the segments by |raydir| here (it is unit)."""
    t = _linspace01(point_count)
    inv_n, inv_f = _f32(1) / _f32(near), _f32(1) / _f32(far)
    tvals = _f32(1) / _fma(inv_f, t, inv_n * (_f32(1) - t))
    return _march(campos, raydir, tvals, point_count, near, False, jitter, u)


_GENERATORS = {
    "near_far_linear": near_far_linear_ray_generation,
    "near_far_disparity_linear": near_far_disparity_linear_ray_generation,
}


def find_ray_generation_method(name: str):
    """Registry lookup (reference: diff_ray_marching.py:7-21)."""
    if name not in _GENERATORS:
        raise RuntimeError(f"No such ray generation method: {name}")
    return _GENERATORS[name]
