"""Point-NeRF's shading, ray march and losses in plain PyTorch, float32.

What a batch of rays renders from a point cloud, its grid and the
aggregator's weights, for the world-coordinate query with the linear
inverse-distance kernel, distance mode 20 and interpolation order 2 (the
options of the lego and Truck presets; `check_options` refuses others).
It follows the published model (Xu et al. 2022, the reference
implementation's PointAggregator and ray marcher) as the port computes
it, and imports nothing of the port:

* eval (`render`): every occupied sample of every ray is shaded; no row
  budget. This is what the port's budget ladder must give.
* train (`train_forward`): the rows a train step shades are the first
  budget rows of the batch in ray order (SR_budget rows, or under the
  auto budget -1 a sixth of the rows, rounded up to 128), and of the kept
  rows with two or more neighbors only the first k_tier_wide_frac of the
  budget; a row dropped there shades as empty (`train_rows`). The port's
  train step drops the same rows, and counts them in `sr_overflow`.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from .grid import Spec
from .query import neighbors, occupied_samples, sample_depths

NEG_SLOPE = 0.1
REQUIRED = dict(NN=2, wcoord_query=-1, agg_distance_kernel="linear",
                agg_dist_pers=20, agg_intrp_order=2, agg_weight_norm=1,
                act_type="LeakyReLU", act_super=1, dist_xyz_deno=0.0,
                shading_feature_mlp_layer2=0, point_color_mode="1",
                point_dir_mode="1", point_conf_mode="1", view_ori=0,
                which_render_func="radiance", which_blend_func="alpha",
                which_tonemap_func="off", raydist_mode_unit=1, inverse=0,
                which_ray_generation="near_far_linear", comp_groups=1,
                sparse_loss_weight=0.0, depth_loss_items=[],
                bg_loss_items=[], l2_size_loss_items=[],
                zero_one_loss_items=["conf_coefficient"], alter_step=0,
                lr_policy="iter_exponential_decay", xyz_grad=0, feat_grad=1,
                conf_grad=1, color_grad=1, dir_grad=1, k_tier=-1,
                compute_dtype="float32", agg_feat_xyz_mode="None",
                agg_alpha_xyz_mode="None", agg_color_xyz_mode="None")


def check_options(o: Dict) -> None:
    """Raise ValueError where the options leave what this model covers."""
    for k, v in REQUIRED.items():
        got = o[k]
        if (list(got) if isinstance(got, (list, tuple)) else got) != v:
            raise ValueError(f"the reference covers {k}={v!r}, not {got!r}")
    aw = o.get("agg_axis_weight")
    if aw is not None and not np.allclose(aw, 1.0):
        raise ValueError("the reference covers unit agg_axis_weight")
    if o["SR_budget"] == 0 or o["SR_budget"] < -1:
        raise ValueError("the reference covers the auto or an explicit "
                         "SR_budget")


def layer_dims(o: Dict) -> Dict[str, list]:
    """Widths of each branch's layers (reference viewmlp_init)."""
    f = o["shading_feature_num"]
    dd = 6                                    # distance mode 20
    dist_ch = 2 * abs(o["dist_xyz_freq"]) * dd
    feat = o["point_features_dim"]
    b1_in = feat + 2 * o["num_feat_freqs"] * feat + dist_ch
    b3_in = f + 3 + 4                         # point colour and direction
    view_ch = 2 * o["num_viewdir_freqs"] * 3
    half = f // 2
    return {
        "block1": [b1_in] + [f] * o["shading_feature_mlp_layer1"],
        "block3": [b3_in] + [f] * o["shading_feature_mlp_layer3"],
        "alpha_branch": [f] + [half] * (o["shading_alpha_mlp_layer"] - 1)
        + [1],
        "color_branch": [f + view_ch]
        + [half] * (o["shading_color_mlp_layer"] - 1) + [3],
    }


def weight_shapes(o: Dict) -> Dict[str, tuple]:
    """Every weight by its checkpoint name ({branch}.{2i}.weight [out,in],
    .bias [out]), in a fixed order."""
    out = {}
    for name, dims in layer_dims(o).items():
        for i in range(len(dims) - 1):
            out[f"{name}.{2 * i}.weight"] = (dims[i + 1], dims[i])
            out[f"{name}.{2 * i}.bias"] = (dims[i + 1],)
    return out


def trunk_macs(o: Dict) -> int:
    """Multiply-adds a (shading row, neighbor) row takes forward: block1,
    block3 and the alpha head, which run per neighbor."""
    d = layer_dims(o)
    return sum(a * b for n in ("block1", "block3", "alpha_branch")
               for a, b in zip(d[n][:-1], d[n][1:]))


def head_macs(o: Dict) -> int:
    """Multiply-adds of the colour head, once per shading row."""
    d = layer_dims(o)["color_branch"]
    return sum(a * b for a, b in zip(d[:-1], d[1:]))


def _pe(x: torch.Tensor, freqs: int) -> torch.Tensor:
    """sin(x·2^f + p·π/2), columns ordered channel, frequency, sin|cos."""
    bands = 2.0 ** torch.arange(freqs, dtype=x.dtype, device=x.device)
    pts = (x[..., None] * bands).reshape(x.shape[:-1] + (-1,))
    both = pts[..., :, None].expand(pts.shape + (2,)).reshape(
        pts.shape[:-1] + (2 * pts.shape[-1],))
    phase = torch.tensor([0.0, np.float32(np.pi / 2)], dtype=x.dtype,
                         device=x.device).repeat(pts.shape[-1])
    return torch.sin(both + phase)


def _view_pe(v: torch.Tensor, freqs: int) -> torch.Tensor:
    """[sin(v·2^f)..., cos(v·2^f)...], channel-major."""
    bands = 2.0 ** torch.arange(freqs, dtype=v.dtype, device=v.device)
    pts = (v[..., None] * bands).reshape(v.shape[:-1] + (-1,))
    return torch.cat([torch.sin(pts), torch.cos(pts)], dim=-1)


def _mlp(W: Dict, name: str, x: torch.Tensor, final_act: bool):
    n = sum(1 for k in W if k.startswith(name + ".") and k.endswith("weight"))
    for i in range(n):
        x = F.linear(x, W[f"{name}.{2 * i}.weight"], W[f"{name}.{2 * i}.bias"])
        if final_act or i < n - 1:
            x = F.leaky_relu(x, NEG_SLOPE)
    return x


def _clamp_identity(x, mn=0.0001, mx=1.0):
    """clamp forward, identity backward."""
    return x - (x - torch.clamp(x, mn, mx)).detach()


def _pers(p, campos, rot):
    """World → camera (x/z, y/z, z): p [...,3], campos [3], rot c2w [3,3]."""
    c = torch.sum((p - campos)[..., None, :] * rot.T, dim=-1)
    return torch.stack([c[..., 0] / c[..., 2], c[..., 1] / c[..., 2],
                        c[..., 2]], dim=-1)


def shade(W: Dict, o: Dict, pts: Dict, pidx: torch.Tensor,
          loc_w: torch.Tensor, raydir: torch.Tensor, campos, rot):
    """Shade N rows with neighbor indices pidx [N,K] (-1 none) at world
    samples loc_w [N,3] on rays raydir [N,3]: (decoded [N,4] alpha and
    colour, conf [N,K] clamped conf of each slot, point 0's where empty)."""
    valid = pidx >= 0
    safe = pidx.clamp(min=0)
    xyz = pts["xyz"][safe]
    emb = pts["embedding"][safe]
    conf = _clamp_identity(pts["conf"][safe][..., 0])
    mask = valid.to(torch.float32)
    w_d = xyz - loc_w[:, None, :]
    xp = _pers(xyz, campos, rot)
    sp = _pers(loc_w, campos, rot)[:, None, :]
    pers = torch.stack([xp[..., 0] * xp[..., 2] - sp[..., 0] * sp[..., 2],
                        xp[..., 1] * xp[..., 2] - sp[..., 1] * sp[..., 2],
                        xp[..., 2] - sp[..., 2]], dim=-1)
    dists = torch.cat([w_d, pers], dim=-1)                    # [N,K,6]
    w = mask / torch.clamp(torch.linalg.norm(w_d, dim=-1), min=1e-6)
    w = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-8)
    w_eff = w * conf
    N, K = pidx.shape
    vd = raydir[:, None, :].expand(N, K, 3)
    sdir = pts["dir"][safe]
    x = torch.cat([emb, _pe(emb, o["num_feat_freqs"]),
                   _pe(dists, abs(o["dist_xyz_freq"]))], dim=-1)
    x = _mlp(W, "block1", x, True)
    x = torch.cat([x, pts["color"][safe], sdir - vd,
                   torch.sum(sdir * vd, dim=-1, keepdim=True)], dim=-1)
    x = _mlp(W, "block3", x, True)
    feat = torch.sum(x * w_eff[..., None], dim=1)
    alpha_k = F.softplus(_mlp(W, "alpha_branch", x, False) - 1.0)
    alpha = torch.sum(alpha_k * w_eff[..., None], dim=1)
    rgb = torch.sigmoid(_mlp(W, "color_branch", torch.cat(
        [feat, _view_pe(raydir, o["num_viewdir_freqs"])], dim=-1), False))
    rgb = rgb * (1 + 2 * 0.001) - 0.001
    out = torch.cat([alpha, rgb], dim=-1)
    return out * valid.any(dim=-1, keepdim=True).to(out.dtype), conf


def march(decoded, row_valid, loc_w, campos, rot, vz: float, bg):
    """Alpha compositing along each ray: decoded [R,SR,4], row_valid
    [R,SR], loc_w [R,SR,3] → colour [R,3]."""
    zs = torch.cummax(_pers(loc_w, campos, rot)[..., 2], dim=-1).values
    dist = torch.cat([zs[..., 1:] - zs[..., :-1],
                      torch.full_like(zs[..., :1], vz)], dim=-1)
    dist = torch.where((dist < 1e-8) | (dist > 2 * vz), vz, dist)
    v = row_valid.to(torch.float32)
    dist = dist * v
    opacity = 1.0 - torch.exp(-(decoded[..., 0] * v) * dist)
    trans = torch.cumprod(1.0 - opacity + 1e-10, dim=-1)
    before = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], -1)
    colour = torch.sum(decoded[..., 1:4] * (opacity * before)[..., None],
                       dim=-2)
    return colour + bg * trans[..., -1:]


def row_budget(o: Dict, rows: int) -> int:
    """The compaction budget of a row space: SR_budget where it is
    explicit, else (auto) a sixth, rounded up to 128, at least 128."""
    if o["SR_budget"] > 0:
        return int(o["SR_budget"])
    return max(128, -(-rows // (6 * 128)) * 128)


def wide_budget(o: Dict, budget: int) -> int:
    return min(budget, max(128, int(round(budget * o["k_tier_wide_frac"]))))


def _samples(o, grid, spec, campos, raydir, u, near, far):
    t = sample_depths(raydir[None], o["z_depth_dim"], near, far,
                      None if u is None else u[None])
    loc, smask = occupied_samples(campos[None], raydir[None], t, grid, spec,
                                  o["SR"])
    return loc[0], smask[0]


@torch.no_grad()
def train_rows(o: Dict, grid: Dict, spec: Spec, loc: torch.Tensor,
               smask: torch.Tensor):
    """The rows a train step of R rays shades, from its occupied samples
    (loc [R,SR,3], smask [R,SR]): (kept, the first budget rows in ray
    order, flat; shaded [n_kept,K], their neighbors with a dropped wide
    row's all -1; has [n_kept], a neighbor found; overflow, the rows past
    the budget and the dropped wide rows)."""
    R, SR = smask.shape
    rows = torch.nonzero(smask.reshape(-1)).reshape(-1)
    budget = row_budget(o, R * SR)
    if budget >= R * SR:            # no compaction, and no tiers
        pidx = neighbors(loc.reshape(-1, 3)[rows], grid, spec, o["K"])
        return rows, pidx, (pidx >= 0).any(dim=-1), 0
    kept = rows[:budget]
    overflow = rows.shape[0] - kept.shape[0]
    pidx = neighbors(loc.reshape(-1, 3)[kept], grid, spec, o["K"])
    has = (pidx >= 0).any(dim=-1)
    wide = (pidx[:, 1:] >= 0).any(dim=-1)
    in_wide = wide & (torch.cumsum(wide.to(torch.int64), 0)
                      <= wide_budget(o, budget))
    overflow += int((wide & ~in_wide).sum())
    shaded = pidx.clone()
    shaded[wide & ~in_wide] = -1
    return kept, shaded, has, overflow


def train_forward(W: Dict, o: Dict, pts: Dict, grid: Dict, spec: Spec,
                  batch: Dict, u: torch.Tensor):
    """One train batch (one camera, R rays): (loss_total, items) with the
    row budget and the wide-tier budget of a train step."""
    campos, rot = batch["campos"], batch["camrotc2w"]
    raydir, gt = batch["raydir"], batch["gt_image"]
    R = raydir.shape[0]
    SR = o["SR"]
    with torch.no_grad():
        loc, smask = _samples(o, grid, spec, campos, raydir, u,
                              batch["near"], batch["far"])
        kept, shaded, has, overflow = train_rows(o, grid, spec, loc, smask)
        row_valid = torch.zeros(R * SR, dtype=torch.bool, device=loc.device)
        row_valid[kept] = has
        ray_of = torch.div(kept, SR, rounding_mode="floor")
    dec, conf = shade(W, o, pts, shaded, loc.reshape(-1, 3)[kept],
                      raydir[ray_of], campos, rot)
    decoded = torch.zeros((R * SR, 4), dtype=dec.dtype, device=dec.device)
    decoded = decoded.index_put((kept,), dec)
    colour = march(decoded.reshape(R, SR, 4), row_valid.reshape(R, SR), loc,
                   campos, rot, float(spec.vsize[2]), batch["bg_color"])
    ray_mask = row_valid.reshape(R, SR).any(dim=-1)
    return losses(o, colour, gt, ray_mask, conf, R * SR * o["K"],
                  {"sr_overflow": overflow})


def losses(o: Dict, colour, gt, ray_mask, conf, n_total: int, extra: Dict):
    """The lego and Truck presets' losses: the ray-masked colour MSE
    (weight 1), the miss and plain colour MSE (weight 0) and the conf
    zero-one term over the whole row space (weight from the options)."""
    weights = dict(zip(o["color_loss_items"], o["color_loss_weights"]))
    m = ray_mask.to(torch.float32)
    sq = torch.square(colour - gt)
    den = torch.sum(m) * 3
    items = {
        "loss_ray_masked_coarse_raycolor": torch.where(
            den > 0, torch.sum(sq * m[:, None]) / torch.clamp(den, min=1.0),
            torch.zeros((), device=colour.device)),
        "loss_ray_miss_coarse_raycolor": torch.sum(sq * (1 - m)[:, None]) / 3,
        "loss_coarse_raycolor": torch.mean(sq),
    }
    total = 0.0
    for name in o["color_loss_items"]:
        total = total + items["loss_" + name] * weights[name] + 1e-6
    eps = o["zero_epsilon"]
    const = math.log(np.float32(eps)) + math.log(np.float32(1.0 - eps))
    v = torch.clamp(conf, eps, 1.0 - eps)
    term = torch.sum(torch.log(v) + torch.log(1.0 - v))
    conf_loss = (term + (n_total - conf.numel()) * const) / n_total
    items["loss_conf_coefficient"] = conf_loss
    total = total + conf_loss * o["zero_one_loss_weights"][0]
    items["loss_total"] = total
    items.update({k: torch.tensor(float(v)) for k, v in extra.items()})
    return total, items


@torch.no_grad()
def render(W: Dict, o: Dict, pts: Dict, grid: Dict, spec: Spec, campos, rot,
           raydir: torch.Tensor, bg, block: int = 28800):
    """Colours [R,3] of the rays raydir [R,3] at eval: every occupied
    sample shaded, no budget; in blocks of rays."""
    out = []
    for s in range(0, raydir.shape[0], block):
        rd = raydir[s:s + block]
        loc, smask = _samples(o, grid, spec, campos, rd, None,
                              o["near_plane"], o["far_plane"])
        R, SR = smask.shape
        rows = torch.nonzero(smask.reshape(-1)).reshape(-1)
        pidx = neighbors(loc.reshape(-1, 3)[rows], grid, spec, o["K"])
        has = (pidx >= 0).any(dim=-1)
        rows, pidx = rows[has], pidx[has]
        decoded = torch.zeros((R * SR, 4), device=rd.device)
        for c in range(0, rows.shape[0], 131072):
            r = rows[c:c + 131072]
            decoded[r] = shade(W, o, pts, pidx[c:c + 131072],
                               loc.reshape(-1, 3)[r],
                               rd[torch.div(r, SR, rounding_mode="floor")],
                               campos, rot)[0]
        row_valid = torch.zeros(R * SR, dtype=torch.bool, device=rd.device)
        row_valid[rows] = True
        out.append(march(decoded.reshape(R, SR, 4), row_valid.reshape(R, SR),
                         loc, campos, rot, float(spec.vsize[2]), bg))
    return torch.cat(out)


def _rows(pidx: torch.Tensor) -> tuple:
    n = (pidx >= 0).sum(dim=-1)
    return int(n.sum()), int((n > 0).sum())


@torch.no_grad()
def count_rows(o: Dict, grid: Dict, spec: Spec, campos, raydir, u,
               near, far, block: int = 28800) -> Dict[str, tuple]:
    """What a batch of rays asks of the trunk, whatever the program does,
    as (neighbor rows, shading rows): the (occupied sample among a ray's
    first SR, neighbor within the radius, up to K) rows and the samples
    with at least one such neighbor. "needed": every such row; "shaded":
    the rows the configured function shades, which for a train batch (u
    given: one camera's train step) are those `train_rows` keeps within
    the budgets, and at eval every needed row."""
    if u is not None:
        loc, smask = _samples(o, grid, spec, campos, raydir, u, near, far)
        _, shaded, _, _ = train_rows(o, grid, spec, loc, smask)
        pidx = neighbors(loc[smask], grid, spec, o["K"])
        return {"needed": _rows(pidx), "shaded": _rows(shaded)}
    nb = sh = 0
    for s in range(0, raydir.shape[0], block):
        loc, smask = _samples(o, grid, spec, campos, raydir[s:s + block],
                              None, near, far)
        a, b = _rows(neighbors(loc[smask], grid, spec, o["K"]))
        nb, sh = nb + a, sh + b
    return {"needed": (nb, sh), "shaded": (nb, sh)}
