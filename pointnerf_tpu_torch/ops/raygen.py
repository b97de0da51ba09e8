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

The registry holds JAX's five generators; `sample_pdf` and the refine
generators (`find_refined_ray_generation_method`) resample a coarse pass
by its weights. Random draws are always injected as ``u`` tensors (JAX's
threefry streams are not reproduced): the jitter draws, the stratified
NeRF draws, the inverse-CDF draws. The renderer picks its generator as the
JAX package's does (linear, or disparity under `inverse`).
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


def _draws(u: torch.Tensor, shape, dev) -> torch.Tensor:
    if tuple(u.shape) != tuple(shape) or u.device != dev:
        raise ValueError(f"draws u must be {list(shape)} on {dev}")
    return u


def march_depths(tvals: np.ndarray, near) -> np.ndarray:
    """The host half of a march: the float32 segment lengths between the
    depths `tvals`, then `near`, [len(tvals)]."""
    return np.append(tvals[1:] - tvals[:-1], _f32(near)).astype(_f32)


def _march(campos, raydir, depths, point_count, scale_by_norm: bool,
           jitter: float, u: Optional[torch.Tensor]) -> Arrays4:
    """Segments of `depths` (`march_depths`: a host array, or a float32
    tensor of the same values on the rays' device), all of them jittered
    by the draws u [B,R,len(depths)-1], then the first point_count kept,
    summed from its last entry, near; samples at the segments'
    midpoints."""
    B, R, _ = raydir.shape
    dev = raydir.device
    if not torch.is_tensor(depths):
        near = float(depths[-1])
        depths = host_const(depths, torch.float32, dev)
    else:
        near = depths[-1]
    seg = depths[:-1]                                              # [S']
    if jitter > 0.0 and u is not None:
        u = _draws(u, (B, R, seg.shape[0]), dev)
        seg = seg * fma(u - 0.5, float(_f32(jitter)), 1.0)         # [B,R,S']
    seg = seg[..., :point_count]
    lead = seg.shape[:-1]
    end_ts = torch.cat([torch.zeros(lead + (1,), device=dev),
                        _cumsum(seg)], dim=-1) + near
    mid_ts = (0.5 * (end_ts[..., :-1] + end_ts[..., 1:])).expand(
        B, R, point_count)
    seg = seg.expand(B, R, point_count)
    raypos = fma(raydir[:, :, None, :], mid_ts[..., None],
                 campos[:, None, None, :])
    valid = torch.ones_like(mid_ts)
    if scale_by_norm:
        seg = seg * torch.linalg.norm(raydir, dim=-1)[..., None]
    return raypos, seg, valid, mid_ts


def _lerp(a: float, b: float, t: np.ndarray) -> np.ndarray:
    """a·(1-t) + b·t in float32, as XLA contracts it."""
    return _fma(_f32(b), t, _f32(a) * (_f32(1) - t))


def _disparity(a: float, b: float, t: np.ndarray) -> np.ndarray:
    """1 / (1/a·(1-t) + 1/b·t) in float32."""
    return _f32(1) / _lerp(_f32(1) / _f32(a), _f32(1) / _f32(b), t)


def near_far_depths(point_count: int, near, far,
                    disparity: bool = False) -> np.ndarray:
    """The host half of the two near/far generators (`march_depths`):
    point_count segment lengths, uniform in depth or in disparity, then
    near."""
    t = _linspace01(point_count)
    return march_depths(_disparity(near, far, t) if disparity
                        else _lerp(near, far, t), near)


def near_far_linear_ray_generation(campos, raydir, point_count, near=0.1,
                                   far=10.0, jitter=0.0,
                                   u: Optional[torch.Tensor] = None,
                                   depths=None, **_) -> Arrays4:
    """Uniform-in-depth samples (reference: diff_ray_marching.py:349-392);
    with jitter > 0 and draws u, each segment is scaled by
    1 + jitter·(u - 0.5). `depths`, if given, stands for near and far:
    their `near_far_depths`, on the host or as a float32 tensor on the
    rays' device (a captured train step's input, `train.graph`)."""
    if depths is None:
        depths = near_far_depths(point_count, near, far)
    return _march(campos, raydir, depths, point_count, True, jitter, u)


def near_far_disparity_linear_ray_generation(campos, raydir, point_count,
                                             near=0.1, far=10.0, jitter=0.0,
                                             u: Optional[torch.Tensor] = None,
                                             depths=None, **_) -> Arrays4:
    """Uniform-in-disparity samples (reference: :201-249). The reference
    does not scale the segments by |raydir| here (it is unit). `depths`
    as for the linear generator."""
    if depths is None:
        depths = near_far_depths(point_count, near, far, disparity=True)
    return _march(campos, raydir, depths, point_count, False, jitter, u)


def near_middle_far_ray_generation(campos, raydir, point_count, near=0.1,
                                   middle=2.0, far=10.0, middle_split=0.6,
                                   jitter=0.0,
                                   u: Optional[torch.Tensor] = None,
                                   **_) -> Arrays4:
    """Linear near → middle, then uniform in disparity middle → far
    (reference: :142-198): int(S·split) + 1 and int(S·(1 - split)) + 2
    depths, the segments between all of them jittered by u [B,R,n0+n1-1],
    the first point_count kept; unscaled by |raydir|."""
    n0 = int(point_count * middle_split) + 1
    n1 = int(point_count * (1.0 - middle_split)) + 2
    tvals = np.concatenate([_lerp(near, middle, _linspace01(n0 - 1)),
                            _disparity(middle, far, _linspace01(n1 - 1))])
    return _march(campos, raydir, march_depths(tvals, near), point_count,
                  False, jitter, u)


def _stratified(campos, raydir, tv: np.ndarray, jitter: float,
                u: Optional[torch.Tensor]) -> Arrays4:
    """NeRF's stratified samples: depth t_i, or with jitter a draw in
    [lower_i, upper_i] between the neighbouring midpoints; segments to the
    next sample (1e10 after the last), scaled by |raydir|."""
    B, R, _ = raydir.shape
    S = tv.shape[0]
    dev = raydir.device
    tvals = host_const(tv, torch.float32, dev).expand(B, R, S)
    if jitter > 0.0 and u is not None:
        u = _draws(u, (B, R, S), dev)
        mids = 0.5 * (tvals[..., 1:] + tvals[..., :-1])
        upper = torch.cat([mids, tvals[..., -1:]], dim=-1)
        lower = torch.cat([tvals[..., :1], mids], dim=-1)
        tvals = fma(upper - lower, u, lower)
    seg = torch.cat([tvals[..., 1:] - tvals[..., :-1],
                     torch.full((B, R, 1), 1e10, device=dev)], dim=-1)
    seg = seg * torch.linalg.norm(raydir, dim=-1)[..., None]
    raypos = fma(raydir[:, :, None, :], tvals[..., None],
                 campos[:, None, None, :])
    return raypos, seg, torch.ones_like(tvals), tvals


def nerf_near_far_linear_ray_generation(campos, raydir, point_count,
                                        near=0.1, far=10.0, jitter=1.0,
                                        u: Optional[torch.Tensor] = None,
                                        **_) -> Arrays4:
    """NeRF-style stratified linear samples (reference: :302-345); u
    [B,R,point_count]."""
    return _stratified(campos, raydir,
                       _lerp(near, far, _linspace01(point_count - 1)),
                       jitter, u)


def nerf_near_far_disparity_linear_ray_generation(
        campos, raydir, point_count, near=0.1, far=10.0, jitter=1.0,
        u: Optional[torch.Tensor] = None, **_) -> Arrays4:
    """NeRF-style stratified disparity samples (reference: :252-299); u
    [B,R,point_count]."""
    return _stratified(campos, raydir,
                       _disparity(near, far, _linspace01(point_count - 1)),
                       jitter, u)


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               u: Optional[torch.Tensor] = None, det: bool = False
               ) -> torch.Tensor:
    """Inverse-CDF importance sampling (reference: diff_ray_marching.py:
    36-82). bins/weights [B,R,S]: the bins' midpoints carry the inner
    weights (+1e-5); the draws u [B,R,n_samples] (evenly spaced when `det`
    or u is None) are inverted through the CDF (searchsorted to the
    right), and the samples are returned sorted together with the bins,
    [B,R,n_samples+S], without gradient to the bins."""
    B, R, S = bins.shape
    mid = 0.5 * (bins[..., 1:] + bins[..., :-1])                  # [B,R,S-1]
    w = weights[..., 1:-1] + 1e-5                                 # [B,R,S-2]
    pdf = w / _scan(w)[..., -1:]         # summed from the left, as XLA
    cdf = torch.cat([torch.zeros_like(pdf[..., :1]), _cumsum(pdf)],
                    dim=-1)                                       # [B,R,S-1]
    if det or u is None:
        u = host_const(_linspace01(n_samples - 1), torch.float32,
                       bins.device).expand(B, R, n_samples)
    else:
        u = _draws(u, (B, R, n_samples), bins.device)
    idx = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    last = cdf.shape[-1] - 1
    below = torch.clamp(idx - 1, min=0)
    above = torch.clamp(idx, max=last)
    cdf_b, cdf_a = torch.gather(cdf, -1, below), torch.gather(cdf, -1, above)
    top = mid.shape[-1] - 1
    bins_b = torch.gather(mid, -1, torch.clamp(below, max=top))
    bins_a = torch.gather(mid, -1, torch.clamp(above, max=top))
    span = cdf_a - cdf_b
    t = (u - cdf_b) / torch.where(span < 1e-5, torch.ones_like(span), span)
    samples = fma(t, bins_a - bins_b, bins_b)
    return torch.sort(torch.cat([samples, bins.detach()], dim=-1),
                      dim=-1).values


def refine_ray_generation(campos, raydir, point_count, prev_ts, prev_weights,
                          domain_size: float = 1.0, jitter: float = 0.0,
                          u: Optional[torch.Tensor] = None, **_) -> Arrays4:
    """Importance-resampled fine pass (reference: diff_ray_marching.py:
    396-430): prev_ts/prev_weights [B,R,S] the coarse depths and blend
    weights; point_count + S samples at the midpoints of sample_pdf's
    point_count + 1 + S sorted depths (evenly spaced draws unless jitter >
    0 and u [B,R,point_count+1] is given)."""
    with torch.no_grad():
        end_ts = sample_pdf(prev_ts, prev_weights, point_count + 1, u=u,
                            det=jitter <= 0)
    seg = end_ts[..., 1:] - end_ts[..., :-1]
    mid_ts = 0.5 * (end_ts[..., :-1] + end_ts[..., 1:])
    raypos = fma(raydir[:, :, None, :], mid_ts[..., None],
                 campos[:, None, None, :])
    seg = seg * torch.linalg.norm(raydir, dim=-1)[..., None]
    return raypos, seg, torch.ones_like(mid_ts), mid_ts


def nerf_refine_ray_generation(campos, raydir, point_count, prev_ts,
                               prev_weights, domain_size: float = 1.0,
                               jitter: float = 0.0,
                               u: Optional[torch.Tensor] = None,
                               **_) -> Arrays4:
    """NeRF-variant refine pass (reference: :433-470): the same math,
    a separate entry as in the reference."""
    return refine_ray_generation(campos, raydir, point_count, prev_ts,
                                 prev_weights, domain_size=domain_size,
                                 jitter=jitter, u=u)


def refine_cube_ray_generation(campos, raydir, point_count, prev_ts,
                               prev_weights, domain_size: float = 1.0,
                               jitter: float = 0.0,
                               u: Optional[torch.Tensor] = None,
                               **_) -> Arrays4:
    """Refine pass whose samples are valid inside the open cube
    (-domain_size, domain_size)³ (reference: :472-505)."""
    raypos, seg, _, mid_ts = refine_ray_generation(
        campos, raydir, point_count, prev_ts, prev_weights,
        domain_size=domain_size, jitter=jitter, u=u)
    valid = torch.all((raypos > -domain_size) & (raypos < domain_size),
                      dim=-1).to(raypos.dtype)
    return raypos, seg, valid, mid_ts


_GENERATORS = {
    "near_far_linear": near_far_linear_ray_generation,
    "near_far_disparity_linear": near_far_disparity_linear_ray_generation,
    "near_middle_far": near_middle_far_ray_generation,
    "nerf_near_far_linear": nerf_near_far_linear_ray_generation,
    "nerf_near_far_disparity_linear":
        nerf_near_far_disparity_linear_ray_generation,
}


def find_ray_generation_method(name: str):
    """Registry lookup (reference: diff_ray_marching.py:7-21)."""
    if name not in _GENERATORS:
        raise RuntimeError(f"No such ray generation method: {name}")
    return _GENERATORS[name]


def find_refined_ray_generation_method(name: str):
    """Fine-pass registry (reference: diff_ray_marching.py:24-33): "cube"
    the cube-validity variant, "nerf*" the NeRF variant, anything else the
    default."""
    if name == "cube":
        return refine_cube_ray_generation
    if name.startswith("nerf"):
        return nerf_refine_ray_generation
    return refine_ray_generation
