"""Volume rendering: alpha compositing + render/blend/tone-map registries.

Port of `pointnerf_tpu/ops/ray_march.py` (reference diff_ray_marching.py:
508-554 and diff_render_func.py).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch


def alpha_blend(opacity, acc_transmission):
    """w = alpha * T (reference: diff_render_func.py:36)."""
    return opacity * acc_transmission


def alpha2_blend(opacity, acc_transmission):
    """Collocated-light round trip: w = alpha * T^2 (diff_render_func.py:40)."""
    return opacity * acc_transmission * acc_transmission


def find_blend_function(name: str) -> Callable:
    if name == "alpha":
        return alpha_blend
    if name == "alpha2":
        return alpha2_blend
    raise RuntimeError(f"Unknown blend function: {name}")


def radiance_render(ray_feature):
    """Channels 1:4 are RGB (reference: diff_render_func.py:48)."""
    return ray_feature[..., 1:4]


def white_color(ray_feature):
    return torch.ones_like(ray_feature[..., 1:4])


def find_render_function(name: str) -> Callable:
    if name == "radiance":
        return radiance_render
    if name == "white":
        return white_color
    raise RuntimeError(f"Unknown render function: {name}")


def simple_tone_map(color, gamma=2.2, exposure=1.0):
    """Gamma tonemap (reference: diff_render_func.py:57)."""
    return torch.clamp(torch.pow(color * exposure + 1e-5, 1.0 / gamma), 0.0, 1.0)


def no_tone_map(color, gamma=2.2, exposure=1.0):
    return color


def normalize_tone_map(color):
    n = color / torch.clamp(torch.linalg.norm(color, dim=-1, keepdim=True),
                            min=1e-12)
    return n * 0.5 + 0.5


def find_tone_map(name: str) -> Callable:
    if name == "gamma":
        return simple_tone_map
    if name == "normalize":
        return normalize_tone_map
    if name == "off":
        return no_tone_map
    raise RuntimeError(f"Unknown tone map: {name}")


class _Transmission(torch.autograd.Function):
    """torch.cumprod along the last axis of a tensor with no zero entry,
    with torch's own backward for that case, reversed_cumsum(out·ct) / x,
    but without torch's test for zeros, whose flag comes back to the host
    (a sync, which a train step captured in a CUDA graph cannot make)."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, ct):
        x, out = ctx.saved_tensors
        if x.shape[-1] == 1:
            return ct
        return torch.flip(torch.cumsum(torch.flip(out * ct, [-1]), -1),
                          [-1]) / x


def transmission(x: torch.Tensor) -> torch.Tensor:
    """cumprod(x) along the last axis; x > 0 everywhere (1 - opacity +
    1e-10)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Transmission.apply(x)
    return torch.cumprod(x, dim=-1)


def ray_march(ray_dist: torch.Tensor, ray_valid: torch.Tensor,
              ray_features: torch.Tensor, render_func: Callable,
              blend_func: Callable, bg_color: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, ...]:
    """Alpha-composite per-sample features along each ray.

    ray_dist/ray_valid [B,R,S]; ray_features [B,R,S,C] with channel 0 =
    sigma. Returns (ray_color [B,R,3], point_color, opacity,
    acc_transmission, blend_weight [B,R,S,1], background_transmission
    [B,R,1], background_blend_weight).
    """
    point_color = render_func(ray_features)
    sigma = ray_features[..., 0] * ray_valid.to(ray_features.dtype)
    opacity = 1.0 - torch.exp(-sigma * ray_dist)
    acc = transmission(1.0 - opacity + 1e-10)
    background_transmission = acc[:, :, -1:]
    acc = torch.cat([torch.ones_like(acc[:, :, :1]), acc[:, :, :-1]], dim=-1)
    blend_weight = blend_func(opacity, acc)[..., None]
    ray_color = torch.sum(point_color * blend_weight, dim=-2)
    if bg_color is not None:
        ray_color = ray_color + bg_color.reshape(
            background_transmission.shape[0], 1, 3).to(ray_color.dtype) \
            * background_transmission
    background_blend_weight = blend_func(1.0, background_transmission)
    return (ray_color, point_color, opacity, acc, blend_weight,
            background_transmission, background_blend_weight)
