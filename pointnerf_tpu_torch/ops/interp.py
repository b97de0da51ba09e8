"""Bilinear and nearest resampling (port of `pointnerf_tpu/ops/interp.py`).

`grid_sample_2d` is torch's grid_sample (zeros or border padding, either
align_corners) written out as JAX writes it: four gathered taps, zero
padding per tap, and JAX's weight products in JAX's order. Each step is
its own elementwise op, so the card and the CPU compute the same bits
from the same inputs: the point samples feed thresholds (the hull's
alpha > 0.1) and sit at silhouette edges, where `F.grid_sample`'s
coordinate arithmetic, which differs between its CPU and CUDA code by an
ulp of the pixel coordinate, moves a color by up to that ulp times the
edge's step. The cost volume's dense warp (`sample_channels_first`) is
`F.grid_sample`: 160 M samples a view, and no threshold downstream.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def sample_channels_first(feat: torch.Tensor, grid: torch.Tensor,
                          align_corners: bool = True,
                          padding_mode: str = "zeros") -> torch.Tensor:
    """`F.grid_sample` of feat [C,H,W] at grid [..., 2] (normalized x, y).
    Returns [C, ...]: the layout the cost volume wants, with no transpose.
    Agrees with grid_sample_2d to a few ulps (its weights are rounded in
    another order)."""
    lead = grid.shape[:-1]
    out = F.grid_sample(feat[None], grid.reshape(1, 1, -1, 2),
                        mode="bilinear", padding_mode=padding_mode,
                        align_corners=align_corners)
    return out.reshape(feat.shape[0], *lead)


def grid_sample_2d(feat: torch.Tensor, grid: torch.Tensor,
                   align_corners: bool = True,
                   padding_mode: str = "zeros") -> torch.Tensor:
    """feat [C,H,W]; grid [..., 2] normalized (x, y). Returns [..., C]."""
    C, H, W = feat.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        x = (gx + 1.0) * 0.5 * (W - 1)
        y = (gy + 1.0) * 0.5 * (H - 1)
    else:
        x = ((gx + 1.0) * W - 1.0) * 0.5
        y = ((gy + 1.0) * H - 1.0) * 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0)[..., None], (y - y0)[..., None]
    # clamped before the cast: far taps stay out of range, NaN takes 0
    # (XLA's float-to-int conversion saturates, and takes NaN to 0)
    x0i = torch.nan_to_num(x0.clamp(-2, W + 1)).long()
    y0i = torch.nan_to_num(y0.clamp(-2, H + 1)).long()
    rows = feat.reshape(C, H * W).t().contiguous()            # [HW, C]

    def tap(xi, yi):
        v = rows[yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)]
        if padding_mode == "zeros":
            inb = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
            v = v * inb[..., None].to(v.dtype)
        return v

    v00 = tap(x0i, y0i)
    v01 = tap(x0i + 1, y0i)
    v10 = tap(x0i, y0i + 1)
    v11 = tap(x0i + 1, y0i + 1)
    return (v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy)
            + v10 * (1 - wx) * wy + v11 * wx * wy)


def resize_nearest(x: torch.Tensor, size) -> torch.Tensor:
    """torch F.interpolate(mode='nearest') of [C,H,W] to `size`, by the
    integer source index i·H // H2 (JAX's form)."""
    _, H, W = x.shape
    H2, W2 = size
    yi = torch.arange(H2, device=x.device) * H // H2
    xi = torch.arange(W2, device=x.device) * W // W2
    return x[:, yi][:, :, xi]


def upsample2x_bilinear_ac(x: torch.Tensor) -> torch.Tensor:
    """F.interpolate(scale_factor=2, mode='bilinear', align_corners=True) of
    [C,H,W], with the source coordinates of jnp.linspace(0, H-1, 2H)."""
    _, H, W = x.shape

    def coords(n):
        div = 2 * n - 1
        s = torch.arange(div, dtype=torch.float32, device=x.device) / div
        pos = (n - 1.0) * s
        return torch.cat([pos, pos.new_full((1,), n - 1.0)])

    ys, xs = coords(H), coords(W)
    y0, x0 = ys.floor().long(), xs.floor().long()
    y1, x1 = (y0 + 1).clamp(max=H - 1), (x0 + 1).clamp(max=W - 1)
    wy = (ys - y0)[None, :, None]
    wx = (xs - x0)[None, None, :]
    a = x[:, y0][:, :, x0]
    b = x[:, y0][:, :, x1]
    c = x[:, y1][:, :, x0]
    d = x[:, y1][:, :, x1]
    return (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
            + c * wy * (1 - wx) + d * wy * wx)
