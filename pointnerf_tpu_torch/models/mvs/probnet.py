"""Learned-probability point init, manual_depth_view -1 (port of
`pointnerf_tpu/models/mvs/probnet.py`).

Reference: models/mvs/models.py, the MVSNeRF variant of MVSNet
(build_volume_costvar_img :891-948), its 8-channel CostRegNet (:760-811)
and ProbNet (:813-821); the sampler and filter (mvs_points_model.py:
142-195). Per depth view: the FPN's coarsest features (32 channels at
H/4) → a plane-sweep cost volume over depth_grid camera depths on a
feature grid padded by `pad` (channels: the views' RGB, 3 each, and the
features' variance, 32) → a 3D U-Net → ProbNet's softmax over depth → a
per-pixel expected ndc depth and std → Gaussian point samples and the
probability-mass filter. The JAX package's deltas from the reference
(its module docstring) are kept: the filter's slice is expected·D, the
points unproject with the feature-resolution intrinsic shifted by `pad`,
and each point's conf is its mass.

What keeps it equal to JAX's:
* the images are downsampled as `jax.image.resize(method="linear")` does,
  antialiased: a triangle filter as wide as the scale factor per axis, one
  weight matrix per axis (`resize_linear`), not `F.interpolate`'s two taps;
* the warp normalises by (W-1)/2 and samples with align_corners=True; its
  in-bounds mask is strict, |g| < 1;
* the variance is E[x²]·(1/n) − (E[x]·(1/n))² over the views in bounds.
The dense warps are `F.grid_sample` (`sample_channels_first`); nothing
downstream thresholds them bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.grid import true_div
from ...ops.interp import sample_channels_first
from .nets import COSTREG_SPEC, COSTREG_UP, ConvBnAct, _Up

COST_CHANNELS = 41     # 3 views' RGB + the 32 feature channels' variance


class MVSNeRFCostReg(nn.Module):
    """[N,41,D,H,W] → [N,8,D,H,W]: the 3D U-Net of CostRegNet with its
    first layer taking the cost volume's 41 channels and no prob head
    (the reference comments conv12 out). D, H and W must be multiples
    of 8."""

    def __init__(self, in_ch: int = COST_CHANNELS, generator=None):
        super().__init__()
        spec = [("conv0", in_ch, 8, 1)] + COSTREG_SPEC[1:]
        for name, cin, cout, stride in spec:
            self.add_module(name, ConvBnAct(cin, cout, 3, stride, 1, dims=3,
                                            generator=generator))
        for name, cin, cout in COSTREG_UP:
            self.add_module(name, _Up(cin, cout, generator))

    def forward(self, x, batch_stats: bool = False):
        bs = batch_stats
        c0 = self.conv0(x, bs)
        c2 = self.conv2(self.conv1(c0, bs), bs)
        c4 = self.conv4(self.conv3(c2, bs), bs)
        x = self.conv6(self.conv5(c4, bs), bs)
        x = c4 + self.conv7(x, bs)
        del c4
        x = c2 + self.conv9(x, bs)
        del c2
        return c0 + self.conv11(x, bs)


class ProbNet(nn.Module):
    """The U-Net (`costreg`) and the prob head (`prob`: conv, BatchNorm,
    ReLU to one channel), the JAX package's `init_probnet` tree."""

    def __init__(self, generator=None):
        super().__init__()
        self.costreg = MVSNeRFCostReg(COST_CHANNELS, generator)
        self.prob = ConvBnAct(8, 1, 3, 1, 1, dims=3, generator=generator)


# ------------------------------------------------------------------ resize
def _linear_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_in, n_out] weights of one axis of jax.image.resize(method=
    "linear", antialias=True) (jax.image.scale_and_translate's
    compute_weight_mat): a triangle kernel widened by the downscale
    factor, each column normalised, columns sampled outside the input
    zeroed."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    sample_f = (torch.arange(n_out, dtype=torch.float32, device=device)
                + 0.5) * f32(inv_scale) - 0.5
    x = torch.abs(sample_f[None, :] - torch.arange(
        n_in, dtype=torch.float32, device=device)[:, None]) / f32(kernel_scale)
    w = torch.clamp(1.0 - torch.abs(x), min=0.0)
    total = w.sum(dim=0, keepdim=True)
    tiny = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(torch.abs(total) > tiny,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_linear(imgs: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """jax.image.resize(imgs, (..., h, w), method="linear") of [..., H, W]
    (antialiased, as JAX's default is)."""
    H, W = imgs.shape[-2:]
    h, w = hw
    out = imgs
    if h != H:
        out = torch.einsum("...hw,hk->...kw", out, _linear_weights(
            H, h, imgs.device).to(imgs.dtype))
    if w != W:
        out = torch.einsum("...hw,wk->...hk", out, _linear_weights(
            W, w, imgs.device).to(imgs.dtype))
    return out


# ------------------------------------------------------------------ warping
def homo_warp_pad(src: torch.Tensor, proj: torch.Tensor,
                  depth_values: torch.Tensor, pad: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warp a src image or feature map onto the ref view's depth planes
    over a target grid padded by `pad` (reference homo_warp with pad,
    mvs_utils.py:264-296). src [C,h,w]; proj [3,4]. Returns ([C,D,h+2p,
    w+2p] warped, [D,h+2p,w+2p] in-bounds mask)."""
    C, H, W = src.shape
    D = depth_values.shape[0]
    dev = src.device
    rot, trans = proj[:3, :3], proj[:3, 3:4]
    y, x = torch.meshgrid(
        torch.arange(-pad, H + pad, dtype=src.dtype, device=dev),
        torch.arange(-pad, W + pad, dtype=src.dtype, device=dev),
        indexing="ij")
    HP, WP = H + 2 * pad, W + 2 * pad
    xyz = torch.stack([x.reshape(-1), y.reshape(-1),
                       torch.ones(HP * WP, dtype=src.dtype, device=dev)])
    rot_xyz = rot @ xyz
    proj_xyz = rot_xyz[:, None, :] * depth_values[None, :, None] \
        + trans[:, :, None]                                    # [3,D,HPWP]
    proj_xy = proj_xyz[:2] / proj_xyz[2:3]
    gx = true_div(proj_xy[0], (W - 1) / 2.0) - 1.0
    gy = true_div(proj_xy[1], (H - 1) / 2.0) - 1.0
    warped = sample_channels_first(src, torch.stack([gx, gy], dim=-1),
                                   align_corners=True, padding_mode="zeros")
    inb = (torch.abs(gx) < 1.0) & (torch.abs(gy) < 1.0)
    return warped.reshape(C, D, HP, WP), inb.reshape(D, HP, WP)


def build_volume_costvar_img(imgs: torch.Tensor, feats: torch.Tensor,
                             proj_mats: torch.Tensor,
                             depth_values: torch.Tensor, pad: int, vid: int
                             ) -> torch.Tensor:
    """Cost volume [3V+32, D, h+2p, w+2p]: the ref view's RGB, each src
    view's warped RGB, the features' variance over the views in bounds
    (reference models.py:891-948). imgs [V,3,H,W] full size; feats
    [V,32,h,w]; proj_mats [V,3,4] relative to ref = vid."""
    V = imgs.shape[0]
    C, h, w = feats.shape[1:]
    D = depth_values.shape[0]
    imgs_s = resize_linear(imgs, (h, w))
    ref_feat = F.pad(feats[vid], (pad, pad, pad, pad))
    ref_img = F.pad(imgs_s[vid], (pad, pad, pad, pad))
    HP, WP = h + 2 * pad, w + 2 * pad
    vol_sum = ref_feat[:, None].expand(C, D, HP, WP)
    vol_sq = torch.square(vol_sum)
    masks = torch.ones((D, HP, WP), dtype=feats.dtype, device=imgs.device)
    img_blocks = [ref_img[:, None].expand(3, D, HP, WP)]
    for sv in range(V):
        if sv == vid:
            continue
        wf, inb = homo_warp_pad(feats[sv], proj_mats[sv], depth_values, pad)
        wi, _ = homo_warp_pad(imgs_s[sv], proj_mats[sv], depth_values, pad)
        img_blocks.append(wi)
        vol_sum = vol_sum + wf
        vol_sq = vol_sq + torch.square(wf)
        masks = masks + inb.to(masks.dtype)
        del wf, wi
    count = 1.0 / masks
    var = vol_sq * count - torch.square(vol_sum * count)
    del vol_sum, vol_sq
    return torch.cat(img_blocks + [var], dim=0)


def check_views(n_views: int, feat_ch: int) -> None:
    """The U-Net's first layer takes 41 channels: 3 views' RGB and 32
    feature channels. Raises ValueError for another bundle (dtu's
    feed-forward bundles hold 3 source views and the target: JAX's conv
    fails there on 44 channels)."""
    if 3 * n_views + feat_ch != COST_CHANNELS:
        raise ValueError(
            f"manual_depth_view -1: ProbNet's cost volume takes 3 views "
            f"({COST_CHANNELS} channels), this bundle has {n_views} "
            f"({3 * n_views + feat_ch} channels)")


def check_volume(depth_grid: int, h: int, w: int, pad: int) -> None:
    """The U-Net halves D, H and W three times and adds the skips back:
    each must be a multiple of 8. Raises ValueError naming the option."""
    if depth_grid % 8:
        raise ValueError(f"the ProbNet U-Net needs depth_grid a multiple of "
                         f"8, got {depth_grid}")
    bad = [n for n in (h + 2 * pad, w + 2 * pad) if n % 8]
    if bad:
        raise ValueError(f"the ProbNet U-Net needs the padded feature grid "
                         f"(H/4 + 2·pad, W/4 + 2·pad) = ({h + 2 * pad}, "
                         f"{w + 2 * pad}) in multiples of 8: change pad "
                         f"({pad}) or img_wh")


def prob_volume(net: ProbNet, cost: torch.Tensor, training: bool = False
                ) -> torch.Tensor:
    """Cost volume [41,D,hp,wp] → prob volume [D,hp,wp]: the U-Net, the
    prob head, the softmax over depth (reference ProbNet.forward
    :817-820). training: BatchNorm on the batch's statistics."""
    vol = net.costreg(cost[None], batch_stats=training)
    logits = net.prob(vol, batch_stats=training)[0, 0]
    return torch.softmax(logits, dim=0)


def probnet_forward(net: ProbNet, imgs, feats, proj_mats, depth_values,
                    pad: int, vid: int, training: bool = False
                    ) -> torch.Tensor:
    """The whole learned-prob pipeline → prob volume [D, h+2p, w+2p]."""
    check_views(imgs.shape[0], feats.shape[1])
    check_volume(depth_values.shape[0], feats.shape[-2], feats.shape[-1],
                 pad)
    cost = build_volume_costvar_img(imgs, feats, proj_mats, depth_values,
                                    pad, vid)
    return prob_volume(net, cost, training)


# ------------------------------------------------------------------ sampling
def prob_moments(prob: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expected ndc depth and std of the prob volume [D,h,w] (reference
    gau_single_sampler :144-151), bins at (i + 0.5)/D."""
    D = prob.shape[0]
    v = 1.0 / D
    d = (0.5 * v + torch.arange(D, dtype=prob.dtype, device=prob.device)
         * v)[:, None, None]
    e = torch.sum(prob * d, dim=0)
    var = torch.sum(prob * torch.square(d - e[None]), dim=0)
    return e, torch.sqrt(torch.clamp(var, min=1e-12))


def prob_filter_mass(prob: torch.Tensor, expected_ndc: torch.Tensor,
                     num_neighbor: int) -> torch.Tensor:
    """The probability mass of the num_neighbor slices around slice
    floor(expected·D), clipped to the volume (reference prob_filter
    :185-195 with the JAX package's slice index). [h,w]."""
    D = prob.shape[0]
    center = torch.floor(expected_ndc * D).to(torch.int32)
    lo = center - num_neighbor // 2
    shifts = torch.arange(num_neighbor, dtype=torch.int32,
                          device=prob.device)
    idx = torch.clamp(lo[None] + shifts[:, None, None], 0, D - 1)
    return torch.sum(torch.gather(prob, 0, idx.long()), dim=0)
