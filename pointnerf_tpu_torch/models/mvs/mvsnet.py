"""Official MVSNet depth estimation (port of
`pointnerf_tpu/models/mvs/mvsnet.py`).

Reference: models/depth_estimators/{mvsnet.py,module.py}. Each view's
features are warped onto the reference view's depth planes; their variance
is the cost; a 3D U-Net regularizes it; the softmax-expected depth and a
4-bin probability sum give depth and photometric confidence.

Three JAX details are kept as they are:
* every view is warped, the reference view too, with its identity
  projection; the warp normalises by (W-1)/2 but samples with
  align_corners=False, so the identity warp is not the identity (the
  reference repeats the reference feature instead);
* the variance is mean(x²) − mean(x)²;
* the confidence sums 4 bins padded (1, 2) at the regressed index
  truncated to int32.
The volume is built view by view: the sum and the sum of squares are
accumulated in JAX's order (view 0, 1, 2, ...), so the [V, C, D, h, w]
stack is never held (at 800², D=128 one view's volume is 655 MB).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ...ops.grid import true_div
from ...ops.interp import sample_channels_first
from .nets import MVSNet


def homo_warping(src_fea: torch.Tensor, proj: torch.Tensor,
                 depth_values: torch.Tensor) -> torch.Tensor:
    """Warp src features onto the ref view's depth planes (reference:
    module.py:36-71). src_fea [C,h,w]; proj [3,4] or [4,4] (src_proj @
    inv(ref_proj)); depth_values [D]. Returns [C,D,h,w]."""
    C, H, W = src_fea.shape
    D = depth_values.shape[0]
    dev = src_fea.device
    rot, trans = proj[:3, :3], proj[:3, 3:4]
    y, x = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                          torch.arange(W, dtype=torch.float32, device=dev),
                          indexing="ij")
    xyz = torch.stack([x.reshape(-1), y.reshape(-1),
                       torch.ones(H * W, device=dev)])           # [3, HW]
    rot_xyz = rot @ xyz
    proj_xyz = rot_xyz[:, None, :] * depth_values[None, :, None] \
        + trans[:, :, None]                                      # [3, D, HW]
    proj_xy = proj_xyz[:2] / proj_xyz[2:3]
    grid = torch.stack([true_div(proj_xy[0], (W - 1) / 2.0) - 1.0,
                        true_div(proj_xy[1], (H - 1) / 2.0) - 1.0], dim=-1)
    # torch's grid_sample default here: align_corners=False
    warped = sample_channels_first(src_fea, grid, align_corners=False,
                                   padding_mode="zeros")         # [C, D, HW]
    return warped.reshape(C, D, H, W)


def depth_regression(prob: torch.Tensor, depth_values: torch.Tensor
                     ) -> torch.Tensor:
    """prob [D,h,w]; depth_values [D] → [h,w] (reference: module.py:73-77)."""
    return torch.sum(prob * depth_values[:, None, None], dim=0)


def depth_index(prob: torch.Tensor) -> torch.Tensor:
    """The regressed bin index before truncation, [h,w]: conf jumps where it
    crosses an integer."""
    D = prob.shape[0]
    return depth_regression(prob, torch.arange(D, dtype=torch.float32,
                                               device=prob.device))


def cost_variance(features: torch.Tensor, proj_mats: torch.Tensor,
                  depth_values: torch.Tensor) -> torch.Tensor:
    """Per-voxel variance over the views of their warped features:
    mean(x²) − mean(x)², with the sums taken view by view. [C,D,h,w]."""
    V = features.shape[0]
    s = q = None
    for v in range(V):
        w = homo_warping(features[v], proj_mats[v], depth_values)
        if s is None:
            s, q = w, w * w
        else:
            s.add_(w)
            q.add_(w.mul_(w))
        del w
    s = true_div(s, V)
    q = true_div(q, V)
    return q.sub_(s.mul_(s))


def mvsnet_forward(net: MVSNet, imgs: torch.Tensor, proj_mats: torch.Tensor,
                   depth_values: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """imgs [V,3,H,W]; proj_mats [V,3,4] (view 0 the reference, identity);
    depth_values [D]. Returns (depth [h,w], photometric confidence [h,w],
    prob volume [D,h,w]) with h = H/4 (reference: mvsnet.py:98-143)."""
    D = depth_values.shape[0]
    features = net.feature(imgs)                                # [V,32,h,w]
    variance = cost_variance(features, proj_mats, depth_values)
    del features
    cost = net.cost_regularization(variance[None])[0, 0]        # [D,h,w]
    del variance
    prob = F.softmax(cost, dim=0)
    depth = depth_regression(prob, depth_values)
    # 4 bins around the regressed index (reference mvsnet.py:131-134:
    # avg_pool3d(4) * 4 with pad (1, 2))
    padded = F.pad(prob, (0, 0, 0, 0, 1, 2))
    sum4 = padded[:-3] + padded[1:-2] + padded[2:-1] + padded[3:]
    index = depth_index(prob).to(torch.int32).clamp(0, D - 1).long()
    conf = torch.gather(sum4, 0, index[None])[0]
    return depth, conf, prob


