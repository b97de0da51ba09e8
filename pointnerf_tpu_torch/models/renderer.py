"""Neural-point ray-marching renderer (port of
`pointnerf_tpu/models/renderer.py`, world-coordinate query).

Shapes stay static as in the JAX package: shading rows are compacted into a
fixed budget, the compacted rows split into a narrow (K=k_tier) and a wide
(full-K) neighbor tier, and rays that miss every occupied voxel march
through zero density, so their color is the background. The query phase
carries no gradient; the shade phase is differentiable in the aggregator's
weights and the point buffers, with the JAX package's gather-form
backwards for the tier reassembly and the compaction expansion.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from ..ops import ray_march as rm
from ..ops import raygen
from ..ops.camera import w2pers
from ..ops.grid import GridSpec
from ..ops.query import expand_compacted, query_grid_points
from . import neural_points as npc
from .aggregator import aggregator_forward, gradient_clamp


def _take_rows(a: torch.Tensor, src: torch.Tensor, valid: torch.Tensor, fill):
    """a [BG,N,...] gathered at src [BG,Nt] along dim 1; `fill` where invalid."""
    idx = src.long().reshape(src.shape + (1,) * (a.dim() - 2))
    out = torch.gather(a, 1, idx.expand(src.shape + a.shape[2:]))
    v = valid.reshape(valid.shape + (1,) * (a.dim() - 2))
    return torch.where(v, out, fill)


def _tier_map(m: torch.Tensor, cum: torch.Tensor, Nt: int):
    """Rows with m set, in order, packed into Nt slots: (src [BG,Nt] row of
    each slot, valid [BG,Nt], overflow [] rows past Nt)."""
    BG, Ncb = m.shape
    rank = torch.where(m & (cum <= Nt), cum - 1, Nt).long()  # Nt: dropped
    iot = torch.arange(Ncb, dtype=torch.int32, device=m.device)
    src = torch.zeros((BG, Nt + 1), dtype=torch.int32, device=m.device)
    src = src.scatter_(1, rank, iot.expand(BG, Ncb))[:, :Nt]
    valid = torch.arange(Nt, device=m.device)[None] < torch.clamp(
        cum[:, -1:], max=Nt)
    overflow = torch.clamp(cum[:, -1] - Nt, min=0).sum(dtype=torch.int32)
    return src, valid, overflow


def _bshape(m: torch.Tensor, ndim: int) -> torch.Tensor:
    return m.reshape(m.shape + (1,) * (ndim - m.dim()))


def _tier_assemble(valsA, valsB, base, mA, inB, rankA_c, rankB_c,
                   srcA, validA, srcB, validB):
    """Row i reads valsA[rankA[i]] in tier A, valsB[rankB[i]] in tier B
    (under the wide budget), else `base`.

    GATHER form of the tier partition's inverse. Its gradient is gathers
    too (JAX renderer.py:63-77): ct_valsA[r] = ct[srcA[r]] on the valid
    tier slots, likewise for B, and `base` takes the rows in neither tier
    (so the masked-slot conf0 keeps its gradient onto point slot 0)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (valsA, valsB, base)):
        return _TierAssemble.apply(valsA, valsB, base, mA, inB, rankA_c,
                                   rankB_c, srcA, validA, srcB, validB)
    return _tier_gather(valsA, valsB, base, mA, inB, rankA_c, rankB_c)


def _tier_gather(valsA, valsB, base, mA, inB, rankA_c, rankB_c):
    ones = torch.ones_like(mA)
    gA = _take_rows(valsA, rankA_c, ones, 0)
    gB = _take_rows(valsB, rankB_c, ones, 0)
    nd = valsA.dim()
    return torch.where(_bshape(mA, nd), gA,
                       torch.where(_bshape(inB, nd), gB, base))


class _TierAssemble(torch.autograd.Function):
    @staticmethod
    def forward(ctx, valsA, valsB, base, mA, inB, rankA_c, rankB_c, srcA,
                validA, srcB, validB):
        ctx.save_for_backward(mA, inB, srcA, validA, srcB, validB)
        return _tier_gather(valsA, valsB, base, mA, inB, rankA_c, rankB_c)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, ct):
        mA, inB, srcA, validA, srcB, validB = ctx.saved_tensors
        zero = torch.zeros((), dtype=ct.dtype, device=ct.device)
        d_base = torch.where(_bshape(~mA & ~inB, ct.dim()), ct, zero)
        return (_take_rows(ct, srcA, validA, 0),
                _take_rows(ct, srcB, validB, 0), d_base) + (None,) * 8


def _tiered_aggregate(agg, point_state, opt, c_pidx, comp_valid, c_loc,
                      c_loc_w, c_srd, camrotc2w, campos, kt):
    """Two-tier neighbor-count split of the compacted shade phase.

    Rows whose valid neighbors all sit in the first `kt` slots run a K=kt
    aggregator over the full row budget; the rest run the full-K aggregator
    over a k_tier_wide_frac budget, whose overflow is counted. The tiers
    partition the rows, so the result equals the single-tier computation,
    including the conf value masked slots carry (point slot 0's clamped
    conf, the safe-index-0 gather's).

    c_pidx [BG,Ncb,K]; c_loc/c_loc_w/c_srd [BG,Ncb,1,3]. Returns
    (c_decoded [BG,Ncb,1,4], c_weight [BG,Ncb,1,K], c_conf [BG,Ncb,1,K],
    wide_overflow []).
    """
    BG, Ncb, Kn = c_pidx.shape
    slot_valid = c_pidx >= 0
    wide = torch.any(slot_valid[..., kt:], dim=-1)
    mA = comp_valid & torch.any(slot_valid[..., :kt], dim=-1) & ~wide
    mB = comp_valid & wide

    frac = float(getattr(opt, "k_tier_wide_frac", 0.25))
    NtB = min(Ncb, max(128, int(round(Ncb * frac))))
    cumA = torch.cumsum(mA.to(torch.int32), dim=1, dtype=torch.int32)
    cumB = torch.cumsum(mB.to(torch.int32), dim=1, dtype=torch.int32)
    srcA, validA, _ = _tier_map(mA, cumA, Ncb)    # full budget: no overflow
    srcB, validB, ovB = _tier_map(mB, cumB, NtB)

    def run_tier(src, valid, Ktier):
        tp = _take_rows(c_pidx, src, valid, -1)[..., :Ktier]
        g = npc.gather_neighbors(point_state, tp[:, :, None, :], camrotc2w,
                                 campos)
        dec, _, w_t, cf_t = aggregator_forward(
            agg, opt, g["sampled_color"], g["Rw2c"], g["sampled_dir"],
            g["sampled_conf"], g["sampled_embedding"],
            g["sampled_xyz_pers"], g["sampled_xyz"], g["sample_pnt_mask"],
            _take_rows(c_loc, src, valid, 0.0),
            _take_rows(c_loc_w, src, valid, 0.0),
            _take_rows(c_srd, src, valid, 0.0))
        return dec, w_t, cf_t

    decA, wA, cfA = run_tier(srcA, validA, kt)
    decB, wB, cfB = run_tier(srcB, validB, Kn)

    conf = point_state.get("conf")
    if conf is not None:
        conf0 = gradient_clamp(conf[0, 0], 0.0001, 1.0)
    else:
        conf0 = torch.ones((), dtype=torch.float32, device=c_pidx.device)
    padK = Kn - kt
    wA = torch.cat([wA, torch.zeros(wA.shape[:-1] + (padK,), dtype=wA.dtype,
                                    device=wA.device)], dim=-1)
    cfA = torch.cat([cfA, conf0.expand(cfA.shape[:-1] + (padK,))
                     .to(cfA.dtype)], dim=-1)

    rankA_c = torch.clamp(cumA - 1, 0, Ncb - 1)
    rankB_c = torch.clamp(cumB - 1, 0, NtB - 1)
    inB = mB & (cumB - 1 < NtB)
    zero4 = torch.zeros((BG, Ncb, 1, decA.shape[-1]), dtype=decA.dtype,
                        device=decA.device)
    tiers = (mA, inB, rankA_c, rankB_c, srcA, validA, srcB, validB)
    c_decoded = _tier_assemble(decA, decB, zero4, *tiers)
    zeroW = torch.zeros((BG, Ncb, 1, Kn), dtype=wA.dtype, device=wA.device)
    c_weight = _tier_assemble(wA, wB, zeroW, *tiers)
    base_cf = conf0.expand((BG, Ncb, 1, Kn)).to(torch.float32)
    c_conf = _tier_assemble(cfA, cfB, base_cf, *tiers)
    return c_decoded, c_weight, c_conf, ovB


def effective_sr_budget(opt, rows: int) -> int:
    """Shading-row compaction budget for a row space of `rows` = B·R·SR:
    SR_budget > 0 explicit; -1 auto (1/6 of the rows, rounded up to 128);
    0 off."""
    Nc = int(opt.SR_budget)
    if Nc < 0:
        Nc = max(128, -(-rows // (6 * 128)) * 128)
    return Nc


class QueryOut(NamedTuple):
    """Result of the query phase."""
    sample_pidx: Optional[torch.Tensor]     # [B,R,SR,K] int32 (None if comp)
    sample_loc_w: torch.Tensor              # [B,R,SR,3]
    ray_mask: torch.Tensor                  # [B,R] bool
    sample_ray_dirs: Optional[torch.Tensor]  # frustum path only (None here)
    q_overflow: torch.Tensor                # [] int32 rows past the budget
    comp: Optional[tuple]                   # compacted query (see
                                            # ops.query.query_grid_points)
    occ_overflow: Optional[torch.Tensor] = None  # [] int32, always 0


TRAIN_JITTER = 0.3     # depth-sample jitter at train (point_query.py:78-81)


def render_query(point_state: Dict, grid: Dict, spec: GridSpec, opt,
                 batch: Dict, is_train: bool = False,
                 u: Optional[torch.Tensor] = None,
                 prob: bool = False) -> QueryOut:
    """Query phase: ray samples → voxel walk → KNN indices (world coords).
    No gradient flows through it. At train the depth samples are jittered
    by the uniform draws u [B,R,z_depth_dim] (on the rays' device). Probe
    mode needs every row's statistics, so it runs uncompacted."""
    if opt.wcoord_query == 0:
        raise NotImplementedError("the frustum querier is not ported")
    if opt.NN < 0:
        raise NotImplementedError("the NN<0 vox-grid querier is not ported")
    raydir, campos = batch["raydir"], batch["campos"]
    gen = raygen.find_ray_generation_method(
        "near_far_disparity_linear" if opt.inverse > 0 else "near_far_linear")
    if is_train and u is None:
        raise ValueError("a train query needs the jitter draws u")
    _, _, _, mid_ts = gen(campos, raydir, opt.z_depth_dim,
                          near=float(batch["near"]), far=float(batch["far"]),
                          jitter=TRAIN_JITTER if is_train else 0.0, u=u)
    B, R = raydir.shape[0], raydir.shape[1]
    if int(getattr(opt, "comp_groups", 1)) != 1:
        raise NotImplementedError("comp_groups > 1 is not ported")
    Nc = effective_sr_budget(opt, B * R * opt.SR) if not prob else 0
    (sample_pidx, sample_loc_w, ray_mask, q_overflow, comp,
     occ_over) = query_grid_points(
        campos, raydir, mid_ts, grid, spec, SR=opt.SR, K=opt.K, Nc=Nc)
    return QueryOut(sample_pidx, sample_loc_w, ray_mask, None, q_overflow,
                    comp, occ_over)


def render_shade(agg, point_state: Dict, spec: GridSpec, opt, batch: Dict,
                 query_out: QueryOut, prob: bool = False) -> Dict:
    """Shade phase: gather attributes → aggregate → ray march.

    Differentiable in `agg` and the point buffers. With compaction the
    output also holds the compact-form loss leaves (conf_compact,
    weight_compact, compact_valid, zero_one_total) that compute_losses
    reads in place of the full-shape conf and weight. With `prob` (an
    uncompacted query) it adds the probe statistics of point growing
    (reference: neural_points_volumetric_model.py:331-362): per ray the
    sample of largest opacity, its location, its distance to the nearest
    of its neighbors and the weight·conf-weighted neighbor attributes."""
    raydir, campos = batch["raydir"], batch["campos"]
    camrotc2w = batch["camrotc2w"]
    B, R, _ = raydir.shape
    (sample_pidx, sample_loc_w, ray_mask, _, q_overflow, q_comp,
     occ_overflow) = query_out

    sample_loc = w2pers(sample_loc_w, camrotc2w, campos)
    sample_ray_dirs = raydir[:, :, None, :].expand(sample_loc.shape)
    SR = sample_loc.shape[2]
    S = B * R * SR
    if prob and q_comp is not None:
        raise ValueError("probe mode needs an uncompacted query "
                         "(render_query(prob=True))")
    if q_comp is None and 0 < effective_sr_budget(opt, S) < S and not prob:
        raise NotImplementedError("shade-side compaction (frustum path) is "
                                  "not ported")
    if q_comp is not None:
        # rows with >= 1 candidate were compacted by the query into a
        # per-batch-row budget; the shade phase runs on those rows only
        comp_src, comp_valid, c_pidx_mat, ray_valid, counts = q_comp
        Ncb = comp_src.shape[1]
        RS = R * SR
        goff = (torch.arange(B, device=raydir.device) * RS)[:, None]
        gsrc = (comp_src + goff).reshape(-1).long()

        def compact(a):
            out = a.reshape((S,) + a.shape[3:])[gsrc]
            v = comp_valid.reshape((B * Ncb,) + (1,) * (out.dim() - 1))
            out = torch.where(v, out, torch.zeros((), dtype=out.dtype,
                                                  device=out.device))
            return out.reshape((B, Ncb, 1) + a.shape[3:])

        c_loc, c_loc_w = compact(sample_loc), compact(sample_loc_w)
        c_srd = compact(sample_ray_dirs)
        kt = int(getattr(opt, "k_tier", 0))
        if kt < 0:
            kt = 1
        Kn = c_pidx_mat.shape[-1]
        if 0 < kt < Kn:
            c_decoded, c_weight, c_conf, t_overflow = _tiered_aggregate(
                agg, point_state, opt, c_pidx_mat, comp_valid, c_loc,
                c_loc_w, c_srd, camrotc2w, campos, kt)
            q_overflow = q_overflow + t_overflow
        else:
            g = npc.gather_neighbors(point_state, c_pidx_mat[:, :, None, :],
                                     camrotc2w, campos)
            c_decoded, _, c_weight, c_conf = aggregator_forward(
                agg, opt, g["sampled_color"], g["Rw2c"], g["sampled_dir"],
                g["sampled_conf"], g["sampled_embedding"],
                g["sampled_xyz_pers"], g["sampled_xyz"],
                g["sample_pnt_mask"], c_loc, c_loc_w, c_srd)

        def scatter_back(c):
            out = expand_compacted(SR, c[:, :, 0], counts, comp_src,
                                   comp_valid)
            return out.reshape((B, R, SR) + c.shape[3:])

        decoded = scatter_back(c_decoded)
        weight = scatter_back(c_weight)
        conf_coefficient = scatter_back(c_conf)
        decoded = decoded * ray_valid[..., None].to(decoded.dtype)
        compact_losses = {
            "conf_compact": c_conf,                       # [B,Ncb,1,K]
            "weight_compact": c_weight.detach(),
            "compact_valid": comp_valid.reshape(B, Ncb, 1, 1),
            "zero_one_total": torch.full((), S * c_conf.shape[-1],
                                         dtype=torch.int64,
                                         device=c_conf.device),
        }
    else:
        compact_losses = {}
        g = npc.gather_neighbors(point_state, sample_pidx, camrotc2w, campos)
        decoded, ray_valid, weight, conf_coefficient = aggregator_forward(
            agg, opt, g["sampled_color"], g["Rw2c"], g["sampled_dir"],
            g["sampled_conf"], g["sampled_embedding"], g["sampled_xyz_pers"],
            g["sampled_xyz"], g["sample_pnt_mask"], sample_loc, sample_loc_w,
            sample_ray_dirs)
    sr_overflow = q_overflow

    # ray distances from the camera-depth cummax (reference volumetric :271-279)
    vz = float(spec.vsize[2])
    zs = torch.cummax(sample_loc[..., 2], dim=2).values
    ray_dist = torch.cat([zs[..., 1:] - zs[..., :-1],
                          torch.full(zs.shape[:-1] + (1,), vz, dtype=zs.dtype,
                                     device=zs.device)], dim=-1)
    bad = ray_dist < 1e-8
    if opt.raydist_mode_unit > 0:
        bad = bad | (ray_dist > 2 * vz)
    ray_dist = torch.where(bad, vz, ray_dist)
    ray_dist = ray_dist * ray_valid.to(ray_dist.dtype)

    render_func = rm.find_render_function(opt.which_render_func)
    blend_func = rm.find_blend_function(opt.which_blend_func)
    tonemap = rm.find_tone_map(opt.which_tonemap_func)
    bg_color = None if "bg_ray" in batch else batch.get("bg_color")
    (ray_color, _, opacity, acc_transmission, blend_weight,
     background_transmission, _) = rm.ray_march(
        ray_dist, ray_valid, decoded, render_func, blend_func, bg_color)
    ray_color = tonemap(ray_color)

    output = {
        **compact_losses,
        "coarse_raycolor": ray_color,                     # [B,R,3]
        "coarse_point_opacity": opacity,                  # [B,R,SR]
        "coarse_is_background": background_transmission,  # [B,R,1]
        "coarse_mask": 1.0 - background_transmission,
        "ray_mask": ray_mask,                             # [B,R] bool
        "queried_shading": torch.logical_not(
            torch.any(ray_valid, dim=-1, keepdim=True)
        ).to(torch.float32).repeat(1, 1, 3),
        "weight": weight.detach(),
        "blend_weight": blend_weight.detach(),
        "conf_coefficient": conf_coefficient,
        "sr_overflow": sr_overflow,
    }
    if occ_overflow is not None:
        output["occ_overflow"] = occ_overflow
    if "bg_ray" in batch:
        # rays that hit keep their color plus bg_ray attenuated by their
        # transmission; missed rays get bg_ray (reference fill_invalid)
        output["coarse_raycolor"] = ray_color \
            + batch["bg_ray"] * background_transmission
    if opt.compute_depth or opt.depth_loss_items:
        # camera-space z (cummax of the perspective sample z), as the JAX
        # package defines it
        w = opacity * acc_transmission
        output["coarse_depth"] = torch.sum(w * zs, dim=-1) / (
            torch.sum(w, dim=-1) + 1e-6)
    if prob:
        output.update(_probe_stats(opacity, sample_loc_w, weight,
                                   conf_coefficient, g))
    return output


def _probe_stats(opacity, sample_loc_w, weight, conf_coefficient,
                 g) -> Dict:
    """Per ray, at the sample of largest opacity (the first on ties, as
    jnp.argmax): the opacity, the world location, the distance to its
    nearest neighbor and each attribute's weight·conf-weighted neighbor
    sum (JAX renderer.py:573-601)."""
    op_max, op_ind = torch.max(opacity, dim=-1, keepdim=True)     # [B,R,1]
    B, R = op_ind.shape[:2]

    def take(a):                      # [B,R,SR,*] → [B,R,*] at op_ind
        idx = op_ind.reshape((B, R, 1) + (1,) * (a.dim() - 3))
        return torch.gather(a, 2, idx.expand((B, R, 1) + a.shape[3:]))[:, :, 0]

    loc = take(sample_loc_w)                                        # [B,R,3]
    sel_w = take(weight * conf_coefficient)[..., None]              # [B,R,K,1]
    out = {"ray_max_shading_opacity": op_max, "ray_max_sample_loc_w": loc}
    sxyz = take(g["sampled_xyz"])                                   # [B,R,K,3]
    out["ray_max_far_dist"] = torch.min(torch.linalg.norm(
        sxyz - loc[..., None, :], dim=-1), dim=-1, keepdim=True).values
    for name, key in (("shading_avg_color", "sampled_color"),
                      ("shading_avg_dir", "sampled_dir"),
                      ("shading_avg_conf", "sampled_conf"),
                      ("shading_avg_embedding", "sampled_embedding")):
        if g.get(key) is not None:
            out[name] = torch.sum(take(g[key]) * sel_w, dim=-2)
    return out


def render_forward(agg, point_state: Dict, grid: Dict, spec: GridSpec, opt,
                   batch: Dict, prob: bool = False) -> Dict:
    """Render a batch of rays (query + shade).

    batch: raydir [B,R,3], campos [B,3], camrotc2w [B,3,3], near/far
    scalars, bg_color [B,3]. Returns the reference output dict
    (coarse_raycolor, ray_mask, coarse_point_opacity, ...), with the probe
    statistics when `prob` is set (see render_shade).
    """
    q = render_query(point_state, grid, spec, opt, batch, prob=prob)
    return render_shade(agg, point_state, spec, opt, batch, q, prob=prob)
