"""Point aggregator: per-neighbor shading MLP + inverse-distance interpolation.

PyTorch port of `pointnerf_tpu/models/aggregator.py`: every distance mode
(-1, 0, 1, 2, 10, 20, 30) and `dist_xyz_deno`; the fixed distance kernels
(linear, numlinear, quadric, numquadric, avg, trilinear; axis weights) and
the learned ones that read point channels (sh_intrp, gau_intrp); the conf
clamp; orders 0, 1 and 2; block1, block2 and block3; float32 or bfloat16
products (`networks.apply_mlp`); the fused-trunk branch and the fused-shade
branch (`ops/trunk.py`). Every (shading point, neighbor) row is computed;
invalid neighbors are removed by the weight mask, so shapes stay static.
Option sets that fail in the JAX package too raise ValueError
(`check_envelope`).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.geometry import compute_world2local_dist
from ..ops.grid import true_div
from ..ops.pe import positional_encoding
from ..ops.sh import sh_basis
from .networks import (COMPUTE_DTYPES, apply_mlp, apply_mlp_pieces, init_mlp,
                       linears, make_mlp)

BRANCHES = ("block1", "block2", "block3", "alpha_branch", "color_branch")


def dist_dim(opt) -> int:
    """Reference: point_aggregators.py:243."""
    if opt.agg_dist_pers > 9:
        return 4 if opt.agg_dist_pers == 30 else 6
    return 3


def _kernel_feat_consumed(opt) -> int:
    if opt.agg_distance_kernel in ("feat_intrp", "meta_intrp"):
        return opt.weight_feat_dim
    if opt.agg_distance_kernel == "sh_intrp":
        return opt.sh_degree ** 2
    if opt.agg_distance_kernel == "gau_intrp":
        return 7
    return 0


def aggregator_dims(opt) -> Dict[str, int]:
    """Mirror viewmlp_init's channel bookkeeping (reference: :276-345)."""
    dd = dist_dim(opt)
    dist_xyz_dim = dd if opt.dist_xyz_freq == 0 else 2 * abs(opt.dist_xyz_freq) * dd
    pnt_channels = (2 * opt.num_pos_freqs * 3) if opt.num_pos_freqs > 0 else 3
    viewdir_channels = (2 * opt.num_viewdir_freqs * 3 + opt.view_ori * 3) \
        if opt.num_viewdir_freqs > 0 else 3

    in_ch = opt.point_features_dim \
        + (0 if opt.agg_feat_xyz_mode == "None" else pnt_channels) \
        - _kernel_feat_consumed(opt)
    in_ch += (2 * opt.num_feat_freqs * in_ch if opt.num_feat_freqs > 0 else 0) \
        + (dist_xyz_dim if opt.agg_intrp_order > 0 else 0)
    block1_in = in_ch

    b1_out = opt.shading_feature_num if opt.shading_feature_mlp_layer1 > 0 else block1_in
    block2_in = b1_out \
        + (0 if opt.agg_feat_xyz_mode == "None" else pnt_channels) \
        + (dist_xyz_dim if (opt.agg_intrp_order > 0 and opt.num_feat_freqs == 0) else 0)
    b2_out = opt.shading_feature_num if opt.shading_feature_mlp_layer2 > 0 else \
        (block2_in if opt.shading_feature_mlp_layer2 > 0 else b1_out)

    block3_in = b2_out \
        + (3 if "1" in list(opt.point_color_mode) else 0) \
        + (4 if "1" in list(opt.point_dir_mode) else 0)
    b3_out = opt.shading_feature_num if opt.shading_feature_mlp_layer3 > 0 else block3_in

    alpha_in = opt.shading_feature_num + \
        (0 if opt.agg_alpha_xyz_mode == "None" else pnt_channels)
    color_in = opt.shading_feature_num + viewdir_channels + \
        (0 if opt.agg_color_xyz_mode == "None" else pnt_channels)
    return {
        "dist_dim": dd, "dist_xyz_dim": dist_xyz_dim,
        "pnt_channels": pnt_channels, "viewdir_channels": viewdir_channels,
        "block1_in": block1_in, "block2_in": block2_in, "block3_in": block3_in,
        "alpha_in": alpha_in, "color_in": color_in, "feat_out": b3_out,
    }


class Aggregator(nn.Module):
    """The aggregator's MLP branches, each an nn.Sequential (Linear at even
    indices). Under a parent attribute named ``aggregator`` the state_dict
    keys are the reference checkpoint's (``aggregator.block1.0.weight``)."""

    def __init__(self, branches: Dict[str, nn.Sequential]):
        super().__init__()
        for name, seq in branches.items():
            if name == "feat_weight_mlp":
                raise ValueError("feat_weight_mlp belongs to "
                                 "agg_distance_kernel feat_intrp, which both "
                                 "packages refuse")
            if name not in BRANCHES:
                raise ValueError(f"unknown aggregator branch {name}")
            setattr(self, name, seq)

    def has(self, name: str) -> bool:
        return hasattr(self, name)


DIST_MODES = (0, 1, 2, 10, 20, 30)        # and any negative mode


def check_envelope(opt) -> None:
    """Raise ValueError, naming the option, for the option sets the JAX
    package fails on as well: the feat_intrp and meta_intrp kernels (JAX's
    compute_weights raises); an agg_*_xyz_mode other than "None" (its dims
    add channels no forward piece supplies); order 0 with a point color or
    dir mode "1" (block3's extras are per neighbor, its input per shading
    point); block2 with num_feat_freqs > 0 at order > 0 (block2 is sized
    without the distances the forward passes it); sh_intrp reading more
    channels than the points hold. Also an unknown distance mode, order
    or compute dtype."""
    k = opt.agg_distance_kernel
    if k in ("feat_intrp", "meta_intrp"):
        raise ValueError(f"agg_distance_kernel {k} is unsupported (the JAX "
                         "package's compute_weights raises for it too)")
    for name in ("agg_feat_xyz_mode", "agg_alpha_xyz_mode",
                 "agg_color_xyz_mode"):
        if getattr(opt, name) != "None":
            raise ValueError(f"{name} {getattr(opt, name)}: the aggregator "
                             "takes only None (no piece supplies the point "
                             "channels its dims count)")
    if k == "sh_intrp" and opt.sh_degree ** 2 > opt.point_features_dim:
        raise ValueError(f"sh_degree {opt.sh_degree} reads "
                         f"{opt.sh_degree ** 2} point channels of "
                         f"{opt.point_features_dim}")
    if opt.agg_intrp_order not in (0, 1, 2):
        raise ValueError(f"agg_intrp_order {opt.agg_intrp_order}")
    if opt.agg_intrp_order == 0 and ("1" in list(opt.point_color_mode)
                                     or "1" in list(opt.point_dir_mode)):
        raise ValueError("agg_intrp_order 0 takes point_color_mode and "
                         "point_dir_mode 0 (block3's color and dir inputs "
                         "are per neighbor)")
    if opt.shading_feature_mlp_layer2 > 0 and opt.num_feat_freqs > 0 \
            and opt.agg_intrp_order > 0:
        raise ValueError("shading_feature_mlp_layer2 > 0 takes "
                         "num_feat_freqs 0 at agg_intrp_order > 0 (block2 "
                         "is sized without the distances it is passed)")
    if opt.agg_dist_pers >= 0 and opt.agg_dist_pers not in DIST_MODES:
        raise ValueError(f"illegal agg_dist_pers {opt.agg_dist_pers}")
    if opt.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {opt.compute_dtype}")


def init_aggregator_params(opt, generator: torch.Generator = None,
                           device="cuda") -> Aggregator:
    """Build and initialize the aggregator (reference: viewmlp_init :276-348)
    on `device` (the card unless the caller names another)."""
    check_envelope(opt)
    dims = aggregator_dims(opt)
    f = opt.shading_feature_num
    act = opt.act_type
    branches = {}
    for name, n_layers, key in (("block1", opt.shading_feature_mlp_layer1,
                                 "block1_in"),
                                ("block2", opt.shading_feature_mlp_layer2,
                                 "block2_in"),
                                ("block3", opt.shading_feature_mlp_layer3,
                                 "block3_in")):
        if n_layers > 0:
            branches[name] = init_mlp([dims[key]] + [f] * n_layers, act,
                                      generator=generator)
    half = int(f / 2)
    branches["alpha_branch"] = init_mlp(
        [dims["alpha_in"]] + [half] * (opt.shading_alpha_mlp_layer - 1) + [1],
        act, final_act=False, generator=generator)
    branches["color_branch"] = init_mlp(
        [dims["color_in"]] + [half] * (opt.shading_color_mlp_layer - 1) + [3],
        act, final_act=False, generator=generator)
    return Aggregator(branches).to(device)


def aggregator_from_layers(layers: Dict[str, list], act: str = "LeakyReLU"
                           ) -> Aggregator:
    """Aggregator whose branches have the given per-layer (w [out,in], b)
    arrays; hidden layers carry `act`, the alpha/color heads end linear."""
    branches = {}
    for name, ls in layers.items():
        dims = [ls[0][0].shape[1]] + [w.shape[0] for w, _ in ls]
        final_act = name not in ("alpha_branch", "color_branch")
        seq = make_mlp(dims, act, final_act)
        with torch.no_grad():
            for lin, (w, b) in zip(linears(seq), ls):
                lin.weight.copy_(torch.tensor(np.asarray(w, np.float32)))
                lin.bias.copy_(torch.tensor(np.asarray(b, np.float32)))
        branches[name] = seq
    return Aggregator(branches)


# --------------------------------------------------------------------- pieces
def raw2out_density(opt, raw):
    """softplus(x-1) mip-nerf stabilization (reference: :262-267)."""
    if opt.act_super > 0:
        return F.softplus(raw - 1.0)
    return torch.relu(raw)


def raw2out_color(opt, raw):
    """widened sigmoid (reference: :269-273)."""
    c = torch.sigmoid(raw)
    if opt.act_super > 0:
        c = c * (1 + 2 * 0.001) - 0.001
    return c


def gradient_clamp(x, mn=0.0001, mx=1.0):
    """clamp forward, identity backward (reference: :722-724)."""
    return x - (x - torch.clamp(x, mn, mx)).detach()


def unit_axis_weight(opt) -> bool:
    """agg_axis_weight is unset or all ones (the JAX `_axis_weight_arr`
    returns None)."""
    aw = opt.agg_axis_weight
    return aw is None or bool(np.allclose(np.asarray(aw, np.float32), 1.0))


FIXED_KERNELS = ("linear", "numlinear", "quadric", "numquadric", "avg",
                 "trilinear")
SH_ACTS = {"sigmoid": torch.sigmoid, "tanh": torch.tanh,
           "passfunc": lambda x: x}
SH_DIST_FUNCS = {
    "sh_linear": lambda n: 1.0 / torch.clamp(n, min=1e-8),
    "sh_quadric": lambda n: 1.0 / torch.clamp(torch.square(n), min=1e-8),
    "passfunc": torch.ones_like}


def compute_weights(opt, dists, pnt_mask, grid_vox_sz: float = 0.0,
                    coefs=None, vsize=None):
    """The distance kernels (reference :355-485; JAX
    aggregator.py:151-219): dists [B,R,SR,K,C], pnt_mask float
    [B,R,SR,K] → weights [B,R,SR,K]. A non-unit agg_axis_weight scales the
    xy radius and |z| (linear kernels) or the squared channels (quadric
    kernels); numlinear divides by the neighbor count, the num* kernels
    and trilinear skip the later normalisation, and trilinear takes the
    lattice pitch `grid_vox_sz`. The learned kernels read `coefs`, the
    point channels they consume (`_kernel_feat_consumed`): sh_intrp a
    spherical-harmonics lobe over the neighbor's direction times a
    distance falloff, gau_intrp an anisotropic gaussian of radius up to
    20·vsize[2]."""
    name = opt.agg_distance_kernel
    if name == "sh_intrp":
        dist_norm = torch.linalg.norm(dists, dim=-1)
        dirs = dists / torch.clamp(dist_norm[..., None], min=1e-8)
        shall = sh_basis(dirs, opt.sh_degree, flip_dir=False)
        return pnt_mask * torch.sum(SH_ACTS[opt.sh_act](shall * coefs),
                                    dim=-1) \
            * SH_DIST_FUNCS[opt.sh_dist_func](dist_norm)
    if name == "gau_intrp":
        if vsize is None:
            raise ValueError("gau_intrp needs the grid's vsize")
        scale = torch.abs(coefs[..., 0])
        radii = float(vsize[2]) * 20 * torch.sigmoid(coefs[..., 1:4])
        rotations = torch.clamp(coefs[..., 4:7], -np.pi / 4, np.pi / 4)
        gau = compute_world2local_dist(dists[..., :3], radii,
                                       rotations)[..., 0]
        return pnt_mask * scale * torch.exp(
            -0.5 * torch.sum(torch.square(gau), dim=-1))
    if name not in FIXED_KERNELS:
        raise ValueError(f"unsupported agg_distance_kernel {name}")
    aw = None if unit_axis_weight(opt) else torch.tensor(
        np.asarray(opt.agg_axis_weight, np.float32), device=dists.device)

    def axis_radius():
        return torch.sqrt(torch.sum(torch.square(dists[..., :2]), dim=-1)) \
            * aw[0] + torch.abs(dists[..., 2]) * aw[1]

    if name == "linear":
        r = torch.linalg.norm(dists[..., :3], dim=-1) if aw is None \
            else axis_radius()
        return pnt_mask * (1.0 / torch.clamp(r, min=1e-6))
    if name == "numlinear":
        r = torch.linalg.norm(dists, dim=-1) if aw is None else axis_radius()
        w = pnt_mask * (1.0 / torch.clamp(r, min=1e-6))
        return w / torch.clamp(torch.sum(pnt_mask, dim=-1, keepdim=True),
                               min=1.0)
    if name in ("quadric", "numquadric"):
        if aw is not None:
            q = torch.sum(torch.square(dists) * aw, dim=-1)
        elif name == "quadric":
            q = torch.sum(torch.square(dists[..., :3]), dim=-1)
        else:
            q = torch.sum(torch.square(dists), dim=-1)
        return pnt_mask * (1.0 / torch.clamp(q, min=1e-8))
    if name == "avg":
        return pnt_mask * 1.0
    d = 1.0 - torch.abs(dists * pnt_mask[..., None] / grid_vox_sz)
    w = pnt_mask * d[..., 0] * d[..., 1] * d[..., 2]
    return w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-8)


def compute_dists(opt, sampled_xyz, sampled_xyz_pers, sample_loc,
                  sample_loc_w, sample_ray_dirs):
    """The agg_dist_pers modes (reference :748-796; JAX aggregator.py:
    222-252): < 0 the sample's world location itself; 0 the world diff; 1
    the perspective diff; 2 the depth-scaled perspective diff; 10 [world,
    perspective]; 20 [world, depth-scaled perspective]; 30 [the world
    diff's projection on the ray, world diff]."""
    mode = opt.agg_dist_pers
    if mode < 0:
        return sample_loc_w[..., None, :].expand(sampled_xyz.shape)
    w_d = sampled_xyz - sample_loc_w[..., None, :]
    if mode == 0:
        return w_d
    if mode == 1:
        return sampled_xyz_pers - sample_loc[..., None, :]
    if mode in (2, 20):
        xd = sampled_xyz_pers[..., 0] * sampled_xyz_pers[..., 2] \
            - sample_loc[..., None, 0] * sample_loc[..., None, 2]
        yd = sampled_xyz_pers[..., 1] * sampled_xyz_pers[..., 2] \
            - sample_loc[..., None, 1] * sample_loc[..., None, 2]
        zd = sampled_xyz_pers[..., 2] - sample_loc[..., None, 2]
        pers = torch.stack([xd, yd, zd], dim=-1)
        return pers if mode == 2 else torch.cat([w_d, pers], dim=-1)
    if mode == 10:
        return torch.cat([w_d, sampled_xyz_pers - sample_loc[..., None, :]],
                         dim=-1)
    if mode == 30:
        proj = torch.sum(w_d * sample_ray_dirs[..., None, :], dim=-1,
                         keepdim=True)
        return torch.cat([proj, w_d], dim=-1)
    raise ValueError(f"illegal agg_dist_pers {mode}")


def dist_denominator(opt, vsize) -> float:
    """dist_xyz_deno · ‖vsize‖ in float32, the JAX package's divisor."""
    if vsize is None:
        raise ValueError("dist_xyz_deno needs the grid's vsize")
    return float(np.float32(opt.dist_xyz_deno
                            * np.linalg.norm(np.asarray(vsize, np.float64))))


def _rot3(v, M):
    """v [..., 3] @ M [..., 3, 3], elementwise (exact in float32)."""
    return torch.sum(v[..., :, None] * M, dim=-2)


# --------------------------------------------------------------------- forward
def aggregator_forward(agg: Aggregator, opt,
                       sampled_color, sampled_Rw2c, sampled_dir, sampled_conf,
                       sampled_embedding, sampled_xyz_pers, sampled_xyz,
                       sample_pnt_mask, sample_loc, sample_loc_w,
                       sample_ray_dirs, grid_vox_sz: float = 0.0,
                       vsize=None):
    """Shading forward pass (reference PointAggregator.forward + viewmlp).

    Inputs are [B,R,SR,K,*] / [B,R,SR,*] tensors; grid_vox_sz is the
    lattice pitch the trilinear kernel divides by, vsize the grid's voxel
    size (gau_intrp's radius and dist_xyz_deno's divisor). The products run
    in opt.compute_dtype, as every caller of the JAX package's
    aggregator_forward passes it. Returns (decoded [B,R,SR,4], ray_valid
    [B,R,SR] bool, weight [B,R,SR,K], conf_coefficient [B,R,SR,K]).
    """
    from ..ops.trunk import (fused_shade, fused_shade_ok, fused_trunk,
                             fused_trunk_ok, pack_trunk_params)
    check_envelope(opt)
    cd = opt.compute_dtype
    B, R, SR, K, _ = sampled_xyz.shape
    mask_f = sample_pnt_mask.to(torch.float32)
    ray_valid = torch.any(sample_pnt_mask, dim=-1)
    S_pt = B * R * SR
    order = opt.agg_intrp_order
    order1 = order == 1

    # sampled_Rw2c: [3,3], or per neighbor [B,R,SR,K,3,3] (scene editing,
    # reference viewmlp :492-506): the ray's view direction then turns
    # with its first neighbor's rotation, the distances and the point dirs
    # with each neighbor's (JAX aggregator.py:312-318, 379-384, 480-486)
    uni = sampled_Rw2c.dim() == 2
    RT = sampled_Rw2c.transpose(-1, -2).to(sample_ray_dirs.dtype)
    viewdirs = _rot3(sample_ray_dirs, RT if uni else RT[:, :, :, 0])
    if opt.num_viewdir_freqs > 0:
        vd = positional_encoding(viewdirs, opt.num_viewdir_freqs, ori=True)
        ori_viewdirs, viewdirs_pe = vd[..., :3], vd[..., 3:]
    else:
        ori_viewdirs, viewdirs_pe = viewdirs, viewdirs

    def heads(feat_pt, alpha):
        if alpha is None:
            alpha = raw2out_density(opt, apply_mlp(agg.alpha_branch, feat_pt,
                                                   cd))
        color = raw2out_color(opt, apply_mlp_pieces(
            agg.color_branch, [feat_pt, viewdirs_pe.reshape(S_pt, -1)], cd))
        out = torch.cat([alpha, color], dim=-1).reshape(B, R, SR, 4)
        return out * ray_valid[..., None].to(out.dtype)

    # fused shade (ops/trunk.py): distances, weights, conf and the trunk in
    # one kernel, whose backward emits the per-attribute cotangents, so
    # dists, weight and w_eff are never formed here. As in the JAX package:
    # on CUDA it runs when fused_shade != 0, the products are float32 and
    # the config is inside fused_shade_ok; on the CPU when fused_shade > 0
    # (the plain versions); otherwise the paths below run.
    fs = int(getattr(opt, "fused_shade", 0))
    use_shade = (fs != 0 and uni and cd == "float32" and fused_shade_ok(opt)
                 and (sampled_xyz.device.type == "cuda" or fs > 0)
                 and all(t is not None for t in (sampled_conf, sampled_color,
                                                 sampled_dir)))
    if use_shade:
        Fd = sampled_embedding.shape[-1]
        rows = lambda t: t.reshape(-1, t.shape[-1]).contiguous()
        ops = pack_trunk_params(agg, Fd, dist_dim(opt), opt.num_feat_freqs,
                                abs(opt.dist_xyz_freq), with_alpha=not order1)
        feat_pt, alpha, w_row, conf_row = fused_shade(
            opt.shading_feature_mlp_layer1, opt.shading_feature_mlp_layer3,
            opt.num_feat_freqs, abs(opt.dist_xyz_freq), K, opt.act_super > 0,
            order1, opt.agg_dist_pers, rows(sampled_embedding),
            rows(sampled_xyz), rows(sampled_xyz_pers), rows(sampled_color),
            rows(sampled_dir), rows(sampled_conf), mask_f.reshape(-1, 1),
            rows(sample_loc), rows(sample_loc_w), rows(ori_viewdirs),
            RT.to(torch.float32).contiguous(), ops)
        return (heads(feat_pt, alpha), ray_valid, w_row.reshape(B, R, SR, K),
                conf_row.reshape(B, R, SR, K))

    dists = compute_dists(opt, sampled_xyz, sampled_xyz_pers, sample_loc,
                          sample_loc_w, sample_ray_dirs)
    # a learned kernel reads the first channels of each point's embedding;
    # the rest is what the trunk sees
    n_k = _kernel_feat_consumed(opt)
    weight = compute_weights(opt, dists, mask_f, grid_vox_sz,
                             sampled_embedding[..., :n_k], vsize)
    emb = sampled_embedding[..., n_k:]
    # no second normalisation for trilinear and the num* kernels (JAX
    # aggregator.py:294-297)
    name = opt.agg_distance_kernel
    if opt.agg_weight_norm > 0 and name != "trilinear" \
            and not name.startswith("num"):
        weight = weight / torch.clamp(torch.sum(weight, dim=-1, keepdim=True),
                                      min=1e-8)
    conf_coefficient = torch.ones_like(weight)
    if sampled_conf is not None:
        conf_coefficient = gradient_clamp(sampled_conf[..., 0], 0.0001, 1.0)
    w_eff = weight * conf_coefficient                          # [B,R,SR,K]
    Fe = emb.shape[-1]

    def trunk(pieces, d_flat, extra):
        """block1, block2 (with the distances at order > 0) and block3
        (with the color and dir inputs), each where present."""
        x = apply_mlp_pieces(agg.block1, pieces, cd) if agg.has("block1") \
            else torch.cat(pieces, dim=-1)
        if agg.has("block2"):
            x = apply_mlp_pieces(agg.block2, [x] + d_flat, cd)
        if agg.has("block3"):
            x = apply_mlp_pieces(agg.block3, [x] + extra, cd)
        return x

    if order == 0:
        # the K-weighted embedding is shaded once per point (JAX
        # aggregator.py:335-341, 517-523)
        feat = torch.sum(emb * w_eff[..., None], dim=-2).reshape(S_pt, Fe)
        pieces = [feat]
        if opt.num_feat_freqs > 0:
            pieces.append(positional_encoding(feat, opt.num_feat_freqs))
        x = trunk(pieces, [], [])
        return (heads(x, raw2out_density(opt, apply_mlp(agg.alpha_branch, x,
                                                        cd))),
                ray_valid, weight, conf_coefficient)

    d = dists
    if opt.dist_xyz_deno > 0.0:
        d = true_div(d, dist_denominator(opt, vsize))
    # world → local on the first three channels, whatever they hold (under
    # mode 30 [proj, wdx, wdy]; JAX aggregator.py:379-383)
    d_raw = torch.cat([_rot3(d[..., :3], RT), d[..., 3:]], dim=-1)
    color_feats = []             # block3's extra inputs (ex3 for the kernel)
    if sampled_color is not None and "1" in list(opt.point_color_mode):
        color_feats.append(sampled_color.reshape(-1, 3))
    if sampled_dir is not None and "1" in list(opt.point_dir_mode):
        sdir = _rot3(sampled_dir, RT).reshape(-1, 3)
        ovd = ori_viewdirs[..., None, :].expand(B, R, SR, K, 3).reshape(-1, 3)
        color_feats += [sdir - ovd,
                        torch.sum(sdir * ovd, dim=-1, keepdim=True)]

    # fused trunk (ops/trunk.py): on CUDA, K1 runs wherever the products
    # are float32 and the config is inside its envelope, whatever
    # use_fused_trunk says. On the CPU, use_fused_trunk=1 picks the
    # kernel's plain version; other values the unfused composition below.
    # Under bfloat16 both packages run the composition. K1 takes d_raw and
    # the dirs already rotated, so a per-neighbor Rw2c (scene editing)
    # runs it too; JAX composes that trunk in XLA (ROADMAP §2).
    uf = int(getattr(opt, "use_fused_trunk", 0))
    if uf > 0 and cd == "float32" and not fused_trunk_ok(opt):
        raise ValueError("use_fused_trunk=1 with an unsupported aggregator "
                         "config")
    use_fused = cd == "float32" and fused_trunk_ok(opt) and (
        sampled_xyz.device.type == "cuda" or uf > 0)
    if use_fused:
        ex3 = torch.cat(color_feats, dim=-1)
        ops = pack_trunk_params(agg, Fe, d_raw.shape[-1], opt.num_feat_freqs,
                                abs(opt.dist_xyz_freq), with_alpha=not order1)
        feat_pt, alpha = fused_trunk(
            opt.shading_feature_mlp_layer1, opt.shading_feature_mlp_layer3,
            opt.num_feat_freqs, abs(opt.dist_xyz_freq), K, opt.act_super > 0,
            order1, emb.reshape(-1, Fe).contiguous(),
            d_raw.reshape(-1, d_raw.shape[-1]).contiguous(), ex3.contiguous(),
            w_eff.reshape(-1, 1).contiguous(), ops)
        return heads(feat_pt, alpha), ray_valid, weight, conf_coefficient

    if opt.dist_xyz_freq != 0:
        d_raw = positional_encoding(d_raw, abs(opt.dist_xyz_freq))
    d_flat = d_raw.reshape(-1, d_raw.shape[-1])
    pieces = [emb.reshape(-1, Fe)]
    if opt.num_feat_freqs > 0:
        pe = positional_encoding(emb, opt.num_feat_freqs)
        pieces.append(pe.reshape(-1, pe.shape[-1]))
    pieces.append(d_flat)
    x = trunk(pieces, [d_flat], color_feats)

    Fo = x.shape[-1]
    feat_pt = torch.sum(x.reshape(B, R, SR, K, Fo) * w_eff[..., None],
                        dim=-2).reshape(-1, Fo)
    alpha = None
    if not order1:
        # per-neighbor alpha, then interpolate (reference :601-639)
        alpha_k = raw2out_density(opt, apply_mlp(agg.alpha_branch, x, cd))
        alpha = torch.sum(alpha_k.reshape(B, R, SR, K, 1) * w_eff[..., None],
                          dim=-2).reshape(-1, 1)
    return heads(feat_pt, alpha), ray_valid, weight, conf_coefficient
