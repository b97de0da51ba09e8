"""MVS point generation and per-point embeddings (port of
`pointnerf_tpu/models/mvs/points_model.py`).

Reference: models/mvs/mvs_points_model.py: gen_points (depth estimation →
Gaussian depth samples → camera-space points, :262-341), filter_by_masks,
query_embedding (points reprojected into the views, FPN features, colors,
per-view directions and confidence sampled there, compressed 63 → C by a
small MLP, :198-259), forward (:345-383).

Covered: manual_depth_view 0 (given depths), 1 (MVSNet depth with fusion)
and ≥ 2 (top-k depth hypotheses), `far_plane_shift`, `default_conf > 1`
(`reassign_conf`), `depth_occ`. The ProbNet branch (manual_depth_view −1)
is not ported (ROADMAP §1 item 8, with generalizable training).

The Gaussian depth jitter is drawn from a torch generator, or injected
(`noise`, standard normal draws), so that a test can feed JAX's draws.

`gen_points(training=True)` is the feed-forward path's (JAX's
`gen_points(..., training=True)`): MVSNet and the fusion stay frozen under
no_grad (`run/train.py:52-57` of the JAX package splits them off), while
the FPN, with BatchNorm on batch statistics, and the premlp record
gradients into the embeddings wherever the caller enables them.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ...ops.grid import true_div
from ...ops.interp import grid_sample_2d, resize_nearest
from ..networks import init_mlp
from . import fusion
from .fusion import apply_mat
from .mvsnet import depth_index, mvsnet_forward
from .nets import MVSNet, FPNFeatureNet

ROW_KEYS = ("xyz_w", "embedding", "color", "dir", "conf", "keep")


class MvsPoints(nn.Module):
    """The nets of the MVS point init: `mvsnet` (depth), `featurenet` (the
    FPN features each point samples) and, with shading_feature_mlp_layer0
    > 0, `premlp` (63 → point_features_dim). Weights come from `generator`
    (torch's default generator if None); BatchNorm is in eval mode and
    nothing requires grad. On `device`, the card unless the caller names
    another."""

    def __init__(self, opt, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        if opt.manual_depth_view == -1:
            raise NotImplementedError(
                "the ProbNet point init (manual_depth_view -1) is not ported "
                "(ROADMAP §1 item 8)")
        self.mvsnet = MVSNet(generator)
        self.featurenet = FPNFeatureNet(generator)
        self.premlp = None
        if opt.shading_feature_mlp_layer0 > 0:
            dims = [63] + [opt.point_features_dim] * \
                opt.shading_feature_mlp_layer0
            self.premlp = init_mlp(dims, opt.act_type, final_act=True,
                                   generator=generator)
        self.to(device).eval().requires_grad_(False)


# ------------------------------------------------------------------ geometry
def ndc_2_cam(ndc_xyz: torch.Tensor, near_far: torch.Tensor,
              intrinsic_inv: torch.Tensor, W: int, H: int) -> torch.Tensor:
    """[..., 3] ndc (x, y in [0, 1] of the pixel range, z in [0, 1] of the
    depth range) → camera coords (reference: mvs_utils.ndc_2_cam :92-99).
    Takes inv(intrinsic)."""
    inv_scale = torch.tensor([W - 1, H - 1], dtype=torch.float32,
                             device=ndc_xyz.device)
    cam_z = ndc_xyz[..., 2:3] * (near_far[1] - near_far[0]) + near_far[0]
    cam_xy = ndc_xyz[..., :2] * inv_scale * cam_z
    cam = torch.cat([cam_xy, cam_z], dim=-1)
    return apply_mat(cam.reshape(-1, 3), intrinsic_inv).reshape(cam.shape)


def depth2point(sampled_depth: torch.Tensor, intrinsic_inv: torch.Tensor,
                near_far: torch.Tensor) -> torch.Tensor:
    """ndc depth [N,H,W] → camera xyz [N,H,W,3] (reference:
    mvs_points_model.py:170-182). Takes inv(intrinsic)."""
    _, H, W = sampled_depth.shape
    dev = sampled_depth.device
    vx = true_div(torch.arange(W, dtype=torch.float32, device=dev), W - 1)
    vy = true_div(torch.arange(H, dtype=torch.float32, device=dev), H - 1)
    gy, gx = torch.meshgrid(vy, vx, indexing="ij")
    ndc = torch.stack([gx.expand_as(sampled_depth),
                       gy.expand_as(sampled_depth), sampled_depth], dim=-1)
    return ndc_2_cam(ndc, near_far, intrinsic_inv, W, H)


def topk_depth_hypotheses(prob: torch.Tensor, depth_values: torch.Tensor,
                          dnum: int, HW):
    """The dnum most probable depth slices of each pixel as hypotheses,
    nearest-upsampled to HW (reference mvs_points_model.py:322-334).
    prob [D,h,w]; returns (depths [dnum,H,W], conf [dnum,H,W])."""
    conf_k, idx_k = torch.topk(prob, dnum, dim=0)
    return (resize_nearest(depth_values[idx_k], HW),
            resize_nearest(conf_k, HW))


def gau_sample_depth(cam_depth: torch.Tensor, std: float, num: int,
                     near_far: torch.Tensor, noise: Optional[torch.Tensor]):
    """Depth to ndc, jittered by std·noise and clamped to [0, 1]
    (reference: gau_single_sampler + sample_by_gau :141-168). cam_depth
    [...]; noise: standard normal draws [num, ...] (None when num is 1
    and std 0). Returns (ndc depth [num, ...], near/far mask [...])."""
    mask = (cam_depth >= near_far[0]) & (cam_depth <= near_far[1])
    ndc = (cam_depth - near_far[0]) / (near_far[1] - near_far[0])
    if num == 1 and std == 0.0:
        return ndc[None], mask
    return torch.clamp(ndc[None] + noise * std, 0.0, 1.0), mask


# ------------------------------------------------------------------ embedding
def _to_src(cam_xyz: torch.Tensor, c2w_ref, w2c_src) -> torch.Tensor:
    """Ref-camera points into the src camera: (hom @ c2w.T) @ w2c.T, JAX's
    association; the points themselves when w2c_src is None."""
    if w2c_src is None:
        return cam_xyz
    hom = torch.cat([cam_xyz, torch.ones_like(cam_xyz[:, :1])], dim=-1)
    return apply_mat(apply_mat(hom, c2w_ref), w2c_src[:3])


def _pixels(src: torch.Tensor, intrinsic: torch.Tensor) -> torch.Tensor:
    z = src[:, 2:3]
    return apply_mat(src / torch.clamp(z.abs(), min=1e-9) * torch.sign(z),
                     intrinsic)[:, :2]


def _grid(xy: torch.Tensor, H: int, W: int) -> torch.Tensor:
    return torch.stack([true_div(xy[:, 0], (W - 1) / 2.0) - 1.0,
                        true_div(xy[:, 1], (H - 1) / 2.0) - 1.0], dim=-1)


def homo_warp_nongrid(c2w_ref, w2c_src, intrinsic, cam_xyz, H, W):
    """Ref-camera points projected into a src view: normalized grid and
    in-bounds mask (reference: mvs_utils.homo_warp_nongrid :299-316,
    unfiltered)."""
    src = _to_src(cam_xyz, c2w_ref, w2c_src)
    xy = _pixels(src, intrinsic)
    mask = (xy[:, 0] >= 0) & (xy[:, 0] <= W - 1) & \
        (xy[:, 1] >= 0) & (xy[:, 1] <= H - 1) & (src[:, 2] > 1e-9)
    return _grid(xy, H, W), mask


def homo_warp_nongrid_occ(c2w_ref, w2c_src, intrinsic, cam_xyz, H, W,
                          tolerate: float = 0.1):
    """Occlusion-aware projection with a per-pixel z-buffer (reference:
    mvs_utils.homo_warp_nongrid_occ :333-369): a point is kept only if its
    src depth is within `tolerate` of the least depth that projects into
    the same (ceil) pixel cell, cell id ceil(x)·H + ceil(y). The z-buffer
    is a scatter-min (`scatter_reduce_` "amin") over the W·H cells."""
    src = _to_src(cam_xyz, c2w_ref, w2c_src)
    z = src[:, 2]
    xy = _pixels(src, intrinsic)
    hard = torch.ceil(xy)
    inb = (xy[:, 0] >= 0) & (hard[:, 0] <= W - 1) & \
        (xy[:, 1] >= 0) & (hard[:, 1] <= H - 1) & (z > 1e-9)
    cell = torch.where(inb, hard[:, 0] * H + hard[:, 1],
                       torch.full_like(z, W * H)).long()
    zbuf = torch.full((W * H + 1,), 3.0e38, dtype=torch.float32,
                      device=z.device)
    zbuf.scatter_reduce_(0, cell, z, "amin")
    zmin = zbuf[cell.clamp(max=W * H - 1)]
    return _grid(xy, H, W), inb & (z <= zmin + tolerate)


def extract_2d(img_feats: Sequence[torch.Tensor], view_ids, layer_ids,
               intrinsics, c2ws, w2cs, cam_xyz, H, W, cam_vid: int,
               depth_occ: int = 0, vis: Optional[List] = None):
    """Per-view feature pyramids sampled at the points' projections
    (reference: extract_2d :198-218; with depth_occ the projection is
    z-buffer filtered, :203). Returns (feats [N,F], colors [N,3V'] or
    None); `vis`, if given, receives each view's visibility mask."""
    feats, colors = [], []
    for vid in view_ids:
        w2c = None if vid == cam_vid else w2cs[vid]
        warp = homo_warp_nongrid_occ if depth_occ > 0 else homo_warp_nongrid
        grid, mask = warp(c2ws[cam_vid], w2c, intrinsics[vid], cam_xyz, H, W)
        if vis is not None:
            vis.append(mask)
        m = mask[:, None].to(cam_xyz.dtype)
        for lid in layer_ids:
            sampled = grid_sample_2d(img_feats[lid][vid], grid,
                                     align_corners=True) * m
            (colors if lid == 0 else feats).append(sampled)
    return torch.cat(feats, dim=-1), (torch.cat(colors, dim=-1) if colors
                                      else None)


def query_embedding(mvs: MvsPoints, opt, img_feats, cam_xyz: torch.Tensor,
                    conf: Optional[torch.Tensor], intrinsics, c2ws, w2cs,
                    H: int, W: int, cam_vid: int,
                    vis: Optional[List] = None):
    """Per-point features, colors, dirs and conf (reference:
    query_embedding :225-259). cam_xyz [N,3] in view cam_vid's camera
    frame. Returns (embedding, colors, dirs, conf)."""
    emb_parts, colors, dirs, pconf = [], None, None, None
    for feat_str in opt.appr_feature_str0:
        if feat_str.startswith("imgfeat"):
            _, vids, lids = feat_str.split("_")
            feats, colors = extract_2d(
                img_feats, [int(a) for a in vids], [int(a) for a in lids],
                intrinsics, c2ws, w2cs, cam_xyz, H, W, cam_vid,
                depth_occ=opt.depth_occ, vis=vis)
            emb_parts.append(feats)
        elif feat_str.startswith("dir"):
            _, vids = feat_str.split("_")
            cam_pos_w = c2ws[[int(a) for a in vids]][:, :, 3]       # [V,4]
            cam_pos_cam = apply_mat(cam_pos_w, w2cs[cam_vid][:3])
            d = cam_xyz[:, None, :] - cam_pos_cam[None]               # [N,V,3]
            d = d / (torch.linalg.norm(d, dim=-1, keepdim=True) + 1e-6)
            d = apply_mat(d.reshape(-1, 3), c2ws[cam_vid][:3, :3])
            d = apply_mat(d, c2ws[opt.ref_vid][:3, :3])               # ref cam
            dirs = d.reshape(cam_xyz.shape[0], -1)
        elif feat_str.startswith("point_conf"):
            pconf = conf if conf is not None else \
                torch.ones_like(cam_xyz[:, :1])
    emb = torch.cat(emb_parts, dim=-1)
    if mvs.premlp is not None:
        emb = mvs.premlp(torch.cat([emb, colors, dirs, pconf], dim=-1))
    return emb, colors, dirs, pconf


def synchronize(dev: torch.device) -> None:
    """Wait for the device (the CPU needs no wait): phase timers."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _depth_values(sample: Dict, D: int, dev) -> torch.Tensor:
    """nfd[0] + (nfd[1] − nfd[0]) / D · arange(D): the step in numpy
    float32, then two float32 ops, as JAX computes it."""
    nfd = np.asarray(sample["near_fars_depth"], np.float32)
    step = (nfd[1] - nfd[0]) / np.float32(D)
    return torch.arange(D, dtype=torch.float32, device=dev) \
        * float(step) + float(nfd[0])


def gen_points(mvs: MvsPoints, opt, sample: Dict,
               noise: Optional[Sequence[torch.Tensor]] = None,
               generator: Optional[torch.Generator] = None,
               stats: Optional[Dict] = None,
               maps: Optional[Dict] = None, training: bool = False,
               depths: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    """Depth estimation, fusion and embedding for one init view bundle
    (reference: gen_points :262-341 + forward :345-383), on mvs's device.

    training: the FPN normalises with batch statistics, and the embedding
    half (FPN, point samples, premlp) runs with autograd as the caller sets
    it; otherwise all of it runs under no_grad. depths: `mvs_depths`'s
    output for this sample, computed before (the frozen half is then
    skipped).

    sample: `get_init_item`'s un-batched arrays (mvs_images [V,3,H,W],
    proj_mats [V,V,3,4], intrinsics [V,3,3], w2cs/c2ws [V,4,4], near_fars
    [V,2], near_fars_depth [2], depths_h [V,H,W] for mode 0). noise: per
    depth view, standard normal draws [num_each_depth, (dnum,) H, W] for
    the depth jitter; drawn from `generator` (on the CPU) when None.
    Returns xyz_w [N,3], embedding, color, dir, conf [N,1] and the keep
    mask [N], rows ordered depth view, sample, (hypothesis,) pixel, then
    each view's far_plane_shift shell rows.

    `stats`, if given, receives host seconds by phase (the device
    synchronized at each phase's end): mvs_s (depth: MVSNet or top-k),
    fusion_s, embed_s (jitter, unprojection, features, premlp). `maps`
    receives per depth view the depth, conf and prob maps of MVSNet
    (`depth`, `conf`, `prob`, `index`: the regressed bin index before
    truncation) and the rows' visibility in each sampled view (`vis`,
    [N, views] per depth view).
    """
    if depths is None:
        depths = mvs_depths(mvs, opt, sample, stats, maps)
    with torch.set_grad_enabled(training and torch.is_grad_enabled()):
        return _embed_points(mvs, opt, sample, depths, noise, generator,
                             stats, maps, training)


def _on(sample: Dict, dev):
    return lambda k: torch.as_tensor(np.asarray(sample[k], np.float32),
                                     device=dev)


@torch.no_grad()
def mvs_depths(mvs: MvsPoints, opt, sample: Dict,
               stats: Optional[Dict] = None,
               maps: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    """The frozen half of `gen_points`: per depth view the MVSNet depth (or
    the given depths, mode 0) and the fusion's keep mask and confidence.
    Returns {"depth", "keep", "conf"}, each [Vd, (dnum,) H, W]."""
    if opt.manual_depth_view == -1:
        raise NotImplementedError(
            "the ProbNet point init (manual_depth_view -1) is not ported "
            "(ROADMAP §1 item 8)")
    dev = next(mvs.parameters()).device
    on = _on(sample, dev)
    imgs = on("mvs_images")
    _, _, H, W = imgs.shape
    depth_vids = [int(v) for v in str(opt.depth_vid)]
    near_far = on("near_fars")[0]
    intrinsics, w2cs = on("intrinsics"), on("w2cs")
    stats = {} if stats is None else stats
    for k in ("mvs_s", "fusion_s", "embed_s"):
        stats.setdefault(k, 0.0)

    dnum = opt.manual_depth_view
    t0 = time.perf_counter()
    depths, confs, nf_masks = [], [], []
    for vid in depth_vids:
        if dnum >= 1:
            dvals = _depth_values(sample, opt.depth_grid, dev)
            d, c, prob = mvsnet_forward(mvs.mvsnet, imgs,
                                        on("proj_mats")[vid], dvals)
            if maps is not None:
                for k, v in (("depth", d), ("conf", c), ("prob", prob),
                             ("index", depth_index(prob))):
                    maps.setdefault(k, []).append(v)
            if dnum == 1:
                # nearest upsample h/4 → full res (reference :330-333)
                d = resize_nearest(d[None], (H, W))[0]
                c = resize_nearest(c[None], (H, W))[0]
            else:
                d, c = topk_depth_hypotheses(prob, dvals, dnum, (H, W))
            del prob
        elif dnum == 0:
            d = on("depths_h")[vid]
            c = torch.ones_like(d)
        else:
            raise NotImplementedError(f"manual_depth_view {dnum}")
        depths.append(d)
        confs.append(c)
        nf_masks.append((d >= near_far[0]) & (d <= near_far[1]))
    depths = torch.stack(depths)
    confs = torch.stack(confs)
    nf_masks = torch.stack(nf_masks)
    synchronize(dev)
    t1 = time.perf_counter()
    stats["mvs_s"] += t1 - t0

    if dnum >= 2:
        # multi-hypothesis init: confidence threshold and near/far only,
        # conf scaled by 0.3 after (reference filter_utils.py:230-235)
        depth_avg = depths
        keep = (confs > opt.depth_conf_thresh) & nf_masks
        confs = confs * 0.3
    elif dnum != 0:
        depth_avg, keep, confs, geo_sum = fusion.filter_by_masks(
            depths, intrinsics[depth_vids], w2cs[depth_vids], confs,
            nf_masks.to(torch.float32), opt.depth_conf_thresh,
            opt.geo_cnsst_num)
        if opt.default_conf > 1.0:
            # multi-view-agreement confidence (reference filter_utils.py:268)
            confs = fusion.reassign_conf(confs, geo_sum, opt.geo_cnsst_num)
    else:
        depth_avg = depths
        keep = nf_masks
    synchronize(dev)
    stats["fusion_s"] += time.perf_counter() - t1
    return {"depth": depth_avg, "keep": keep, "conf": confs}


def _embed_points(mvs, opt, sample, depths, noise, generator, stats, maps,
                  training):
    """The embedding half of `gen_points`: jitter, unprojection, FPN
    features, point samples and the premlp, depth view by depth view."""
    dev = next(mvs.parameters()).device
    on = _on(sample, dev)
    imgs = on("mvs_images")
    _, _, H, W = imgs.shape
    depth_vids = [int(v) for v in str(opt.depth_vid)]
    near_far = on("near_fars")[0]
    intrinsics, w2cs, c2ws = on("intrinsics"), on("w2cs"), on("c2ws")
    Kinv = torch.linalg.inv(torch.as_tensor(
        np.asarray(sample["intrinsics"], np.float32))).to(dev)
    W2Cinv = torch.linalg.inv(torch.as_tensor(
        np.asarray(sample["w2cs"], np.float32))).to(dev)
    depth_avg, keep, confs = depths["depth"], depths["keep"], depths["conf"]
    stats = {} if stats is None else stats
    stats.setdefault("embed_s", 0.0)
    t2 = time.perf_counter()

    img_feats = mvs.featurenet(imgs, batch_stats=training)
    num = opt.num_each_depth
    out = {k: [] for k in ROW_KEYS}
    for i, vid in enumerate(depth_vids):
        draw = None
        if not (num == 1 and opt.manual_std_depth == 0.0):
            draw = noise[i].to(dev) if noise is not None else torch.randn(
                (num,) + tuple(depth_avg[i].shape), generator=generator
            ).to(dev)
        ndc_depth, nf = gau_sample_depth(depth_avg[i], opt.manual_std_depth,
                                         num, near_far, draw)
        cam_xyz = depth2point(ndc_depth.reshape(-1, H, W), Kinv[vid],
                              near_far).reshape(-1, 3)
        conf_rows = confs[i].reshape(-1, 1).repeat(num, 1)
        keep_rows = (keep[i] & nf).reshape(-1).repeat(num)
        if opt.far_plane_shift is not None:
            # background shell: a point at far + shift on the ray of every
            # pixel whose depth no hypothesis kept, conf 0.02 (reference
            # filter_utils.py:273-281)
            far_z = near_far[1] + float(np.float32(opt.far_plane_shift))
            ndc_far = (far_z - near_far[0]) / (near_far[1] - near_far[0])
            bg_xyz = depth2point(ndc_far.expand(1, H, W), Kinv[vid],
                                 near_far).reshape(-1, 3)
            cam_xyz = torch.cat([cam_xyz, bg_xyz], dim=0)
            conf_rows = torch.cat([conf_rows, torch.full(
                (H * W, 1), 0.02, device=dev)], dim=0)
            kp = keep[i] if keep[i].dim() == 2 else keep[i].any(dim=0)
            keep_rows = torch.cat([keep_rows, ~kp.reshape(-1)], dim=0)
        vis = [] if maps is not None else None
        emb, col, drs, cf = query_embedding(
            mvs, opt, img_feats, cam_xyz, conf_rows, intrinsics, c2ws, w2cs,
            H, W, vid, vis=vis)
        if vis is not None:
            maps.setdefault("vis", []).append(torch.stack(vis, dim=-1))
        # to world (reference xyz_ref_lst :364-367, the ref frame = world)
        hom = torch.cat([cam_xyz, torch.ones_like(cam_xyz[:, :1])], dim=-1)
        out["xyz_w"].append(apply_mat(hom, W2Cinv[vid][:3]))
        out["embedding"].append(emb)
        out["color"].append(col)
        out["dir"].append(drs)
        out["conf"].append(cf)
        out["keep"].append(keep_rows)
    synchronize(dev)
    stats["embed_s"] += time.perf_counter() - t2
    return {k: torch.cat(v, dim=0) for k, v in out.items()}
