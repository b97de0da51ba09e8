"""Multi-view depth fusion: geometric-consistency filtering and the visual
hull (port of `pointnerf_tpu/models/mvs/fusion.py`).

Reference: models/mvs/filter_utils.py (gpu path :157-291) and
mvs_utils.alpha_masking (:573-605). Runs once per scene at init.

Products of points with a camera's 3×3 or 4×4 matrix go through
`apply_mat`, term by term, and divisions by constants through
`ops.grid.true_div`, so that the card and the CPU round them alike: the
masks below (and the z-buffer cells of `points_model`) are thresholds of
these values. The matrices themselves (inverses, relative transforms) are
small host data, computed on the CPU for the same reason.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...ops.grid import true_div
from ...ops.interp import grid_sample_2d


def apply_mat(x: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """x [N,k] @ M.T for a small M [m,k], one elementwise product per term,
    summed pairwise for k = 4 ((t0 + t1) + (t2 + t3)) and left to right
    otherwise: the order XLA:CPU's dot sums these shapes in (for k = 3, in
    the first two output columns), and no FMA, on either device."""
    t = [x[:, k:k + 1] * M[:, k] for k in range(M.shape[1])]
    if len(t) == 4:
        return (t[0] + t[1]) + (t[2] + t[3])
    out = t[0]
    for term in t[1:]:
        out = out + term
    return out


def _hom(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[:, :1])], dim=-1)


def _inv(m: torch.Tensor, left: Optional[torch.Tensor] = None
         ) -> torch.Tensor:
    """inv(m), or left @ inv(m), of small matrices, computed on the CPU and
    put on m's device (the card's solver and product may round the last
    bit otherwise)."""
    out = torch.linalg.inv(m.cpu())
    if left is not None:
        out = left.cpu() @ out
    return out.to(m.device)


def _project(xyz: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Camera points [N,3] → pixel xy [N,2], dividing by |z| (at least
    1e-9) with z's sign, as the reference does."""
    Kx = apply_mat(xyz, K)
    z = Kx[:, 2:3]
    return Kx[:, :2] / torch.clamp(z.abs(), min=1e-9) * torch.sign(z)


def reproject_with_depth(depth_ref, K_ref, E_ref, depth_src, K_src, E_src):
    """ref depth map → src view → sampled src depth → back to ref
    (reference: filter_utils.py:157-200). depth_*: [H,W]; K: [3,3]; E:
    [4,4] (w2c). Returns (depth_reprojected, x_reproj, y_reproj, oor)."""
    H, W = depth_ref.shape
    dev = depth_ref.device
    y, x = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                          torch.arange(W, dtype=torch.float32, device=dev),
                          indexing="ij")
    pix = torch.stack([x.reshape(-1), y.reshape(-1),
                       torch.ones(H * W, device=dev)], dim=-1)     # [HW,3]
    xyz_ref = apply_mat(pix * depth_ref.reshape(-1, 1), _inv(K_ref))
    xyz_src = apply_mat(_hom(xyz_ref), _inv(E_ref, E_src)[:3])
    xy_src = _project(xyz_src, K_src)
    x_src = xy_src[:, 0].reshape(H, W)
    y_src = xy_src[:, 1].reshape(H, W)
    oor = (x_src >= W) | (x_src < 0) | (y_src >= H) | (y_src < 0)

    grid = torch.stack([true_div(x_src * 2, W - 1) - 1,
                        true_div(y_src * 2, H - 1) - 1], dim=-1)
    sampled = grid_sample_2d(depth_src[None], grid.reshape(-1, 2),
                             align_corners=True, padding_mode="border")[:, 0]
    xyz_src2 = apply_mat(_hom(xy_src) * sampled[:, None], _inv(K_src))
    xyz_re = apply_mat(_hom(xyz_src2), _inv(E_src, E_ref)[:3])
    depth_re = xyz_re[:, 2].reshape(H, W)
    xy_re = _project(xyz_re, K_ref)
    return depth_re, xy_re[:, 0].reshape(H, W), xy_re[:, 1].reshape(H, W), oor


def check_geometric_consistency(depth_ref, K_ref, E_ref, depth_src, K_src,
                                E_src):
    """< 1 px reprojection and < 1% relative depth (reference: :204-220).
    Returns (mask, vis_mask, depth_reprojected)."""
    H, W = depth_ref.shape
    dev = depth_ref.device
    y, x = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                          torch.arange(W, dtype=torch.float32, device=dev),
                          indexing="ij")
    depth_re, x_re, y_re, oor = reproject_with_depth(
        depth_ref, K_ref, E_ref, depth_src, K_src, E_src)
    dist = torch.sqrt(torch.square(x_re - x) + torch.square(y_re - y))
    rel = torch.abs(depth_re - depth_ref) / torch.clamp(depth_ref, min=1e-9)
    mask = (dist < 1.0) & (rel < 0.01)
    return mask, ~oor, torch.where(mask, depth_re, torch.zeros_like(depth_re))


def filter_by_masks(depths: torch.Tensor, intrinsics: torch.Tensor,
                    extrinsics: torch.Tensor, confidences: torch.Tensor,
                    nearfar_masks: torch.Tensor, depth_conf_thresh: float,
                    geo_cnsst_num: int):
    """Per-view fused depth and keep mask (reference: filter_by_masks_gpu
    :222-291, manual_depth_view 1). depths/conf/nearfar [V,H,W];
    intrinsics [V,3,3]; extrinsics [V,4,4]. Returns (depth_avg [V,H,W],
    keep [V,H,W] bool, conf [V,H,W], geo_sum [V,H,W] int32, the number of
    other views agreeing). JAX vmaps over (ref, src) with the src == ref
    entry zeroed; here the loop skips it, and the sums keep JAX's order."""
    V = depths.shape[0]
    avgs, keeps, sums = [], [], []
    for ref in range(V):
        geo_sum = torch.zeros_like(depths[ref], dtype=torch.int32)
        depth_sum = torch.zeros_like(depths[ref])
        for src in range(V):
            if src == ref:
                continue
            geo, _, depth_re = check_geometric_consistency(
                depths[ref], intrinsics[ref], extrinsics[ref],
                depths[src], intrinsics[src], extrinsics[src])
            geo_sum = geo_sum + geo.to(torch.int32)
            depth_sum = depth_sum + depth_re
        avgs.append((depth_sum + depths[ref]) / (geo_sum + 1))
        final = (confidences[ref] > depth_conf_thresh) & \
            (nearfar_masks[ref] > 0)
        if V > 1:
            final = final & (geo_sum >= geo_cnsst_num)
        keeps.append(final)
        sums.append(geo_sum)
    return (torch.stack(avgs), torch.stack(keeps), confidences,
            torch.stack(sums))


def reassign_conf(conf: torch.Tensor, geo_sum: torch.Tensor,
                  geo_cnsst_num: int) -> torch.Tensor:
    """Confidence scaled by multi-view agreement (reference:
    filter_utils.reassign_conf :296-299, --default_conf > 1):
    conf · (1 − 1.14869^−clip(geo_sum − geo_cnsst_num + 1, 1, 10))."""
    n = torch.clamp(geo_sum - geo_cnsst_num + 1, 1, 10).to(torch.float32)
    base = torch.tensor(1.14869, dtype=torch.float32, device=conf.device)
    return conf * (1.0 - torch.pow(base, -n))


def alpha_masking(points_w: torch.Tensor, alphas: torch.Tensor,
                  intrinsics: torch.Tensor, w2cs: torch.Tensor,
                  ranges: Optional[np.ndarray] = None) -> torch.Tensor:
    """Visual-hull keep mask: a world point survives if it projects into
    the foreground (alpha > 0.1) of every view it is visible in (reference:
    mvs_utils.alpha_masking :573-605). points_w [N,3]; alphas [V,H,W];
    returns bool [N]."""
    V, H, W = alphas.shape
    hom = _hom(points_w)
    keep = torch.ones(points_w.shape[0], dtype=torch.bool,
                      device=points_w.device)
    for v in range(V):
        cam = apply_mat(hom, w2cs[v][:3])
        z = cam[:, 2]
        xy = _project(cam, intrinsics[v])
        inb = (z > 1e-4) & (xy[:, 0] >= 0) & (xy[:, 0] <= W - 1) \
            & (xy[:, 1] >= 0) & (xy[:, 1] <= H - 1)
        grid = torch.stack([true_div(xy[:, 0] * 2, W - 1) - 1,
                            true_div(xy[:, 1] * 2, H - 1) - 1], dim=-1)
        a = grid_sample_2d(alphas[v][None], grid, align_corners=True)[:, 0]
        keep &= ~inb | (a > 0.1)
    if ranges is not None:
        r = torch.as_tensor(np.asarray(ranges, np.float32),
                            device=points_w.device)
        keep &= torch.all((points_w >= r[:3]) & (points_w <= r[3:]), dim=-1)
    return keep
