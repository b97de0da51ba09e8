"""Neural-point ray-marching renderer (port of
`pointnerf_tpu/models/renderer.py`: the world-coordinate query, the
perspective-frustum one, `wcoord_query 0`, and the 8-corner vox-grid one,
`NN < 0`).

Shapes stay static as in the JAX package: shading rows are compacted into a
fixed budget, the compacted rows split into a narrow (K=k_tier) and a wide
(full-K) neighbor tier, and rays that miss every occupied voxel march
through zero density, so their color is the background. The query phase
carries no gradient; the shade phase is differentiable in the aggregator's
weights and the point buffers, with the JAX package's gather-form
backwards for the tier reassembly and the compaction expansion.

Where a tally is open (`utils.profiling.tally`: a train dispatch's steps,
render_image's groups) the shade phase counts its rows on the device:
per trunk tier (``narrow`` and ``wide`` of the K-tier split; the
untiered compacted trunk counts as ``wide``, the uncompacted one as
``dense``) the trunk rows, (shading row, neighbor slot) pairs, that carry
a valid neighbor (``trunk.rows.<tier>``) and the slots the trunk runs
(``trunk.slots.<tier>``, from the shapes); and the shading rows the
compaction saw (``shade.rows.occupied``: its kept rows and those past its
budget; uncompacted, the rows with a neighbor) and the rows the trunk
shades with a neighbor (``shade.rows.kept``).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from ..ops import ray_march as rm
from ..ops import raygen
from ..ops.camera import w2pers
from ..ops.frustum import build_frustum_grid, query_frustum_points
from ..ops.grid import GridSpec
from ..ops.query import (Shards, expand_compacted, query_grid_points,
                         row_share)
from ..ops.voxgrid import query_vox_grid
from ..utils import profiling
from . import neural_points as npc
from .aggregator import aggregator_forward, gradient_clamp


def _take_rows(a: torch.Tensor, src: torch.Tensor, valid: torch.Tensor, fill):
    """a [BG,N,...] gathered at src [BG,Nt] along dim 1; `fill` where invalid."""
    idx = src.long().reshape(src.shape + (1,) * (a.dim() - 2))
    out = torch.gather(a, 1, idx.expand(src.shape + a.shape[2:]))
    v = valid.reshape(valid.shape + (1,) * (a.dim() - 2))
    return torch.where(v, out, fill)


def _tier_map(m: torch.Tensor, cum: torch.Tensor, Nt: int, limit=None):
    """Rows with m set, in order, packed into Nt slots: (src [BG,Nt] row of
    each slot, valid [BG,Nt], overflow [] rows past Nt). limit ([BG,1],
    a piece's share, `ops.query.row_share`): only the rows of running
    count ≤ limit are kept, and the rest count as overflow."""
    BG, Ncb = m.shape
    lim = Nt if limit is None else limit
    rank = torch.where(m & (cum <= lim), cum - 1, Nt).long()  # Nt: dropped
    iot = torch.arange(Ncb, dtype=torch.int32, device=m.device)
    src = torch.zeros((BG, Nt + 1), dtype=torch.int32, device=m.device)
    src = src.scatter_(1, rank, iot.expand(BG, Ncb))[:, :Nt]
    valid = torch.arange(Nt, device=m.device)[None] < torch.clamp(
        torch.clamp(cum[:, -1:], max=Nt), max=lim)
    overflow = torch.clamp(cum[:, -1:] - lim, min=0).sum(dtype=torch.int32)
    return src, valid, overflow


def wide_budget(opt, Ncb: int) -> int:
    """The wide K tier's rows for a compaction budget of Ncb rows."""
    frac = float(getattr(opt, "k_tier_wide_frac", 0.25))
    return min(Ncb, max(128, int(round(Ncb * frac))))


def tier_k(opt, Kn: int) -> int:
    """The narrow tier's K for Kn neighbor slots; 0: no K-tier split."""
    kt = int(getattr(opt, "k_tier", 0))
    if kt < 0:
        kt = 1
    return kt if 0 < kt < Kn else 0


def wide_rows(c_pidx: torch.Tensor, kt: int) -> torch.Tensor:
    """Rows with a valid neighbor past the first kt slots (the wide tier's
    rows among the valid ones)."""
    return torch.any(c_pidx[..., kt:] >= 0, dim=-1)


def _tally_rows(tier: str, pidx: torch.Tensor, kept: torch.Tensor) -> None:
    """Into the open tally, if any: the trunk tier's neighbor slots pidx
    [..., K] (-1 empty) that carry a valid neighbor, the slots it runs,
    and its shading rows `kept` (bool) that carry one."""
    t = profiling.tallying()
    if t is not None:
        t.add("trunk.rows." + tier, (pidx >= 0).sum(dtype=torch.int64))
        t.add("trunk.slots." + tier, pidx.numel())
        t.add("shade.rows.kept", kept.sum(dtype=torch.int64))


def _tally_occupied(n: torch.Tensor) -> None:
    t = profiling.tallying()
    if t is not None:
        t.add("shade.rows.occupied", n.to(torch.int64))


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
                      c_loc_w, c_srd, camrotc2w, campos, kt,
                      grid_vox_sz: float = 0.0, vsize=None, share=None):
    """Two-tier neighbor-count split of the compacted shade phase.

    Rows whose valid neighbors all sit in the first `kt` slots run a K=kt
    aggregator over the full row budget; the rest run the full-K aggregator
    over a k_tier_wide_frac budget, whose overflow is counted. The tiers
    partition the rows, so the result equals the single-tier computation
    for every distance kernel, order and dtype (a masked slot carries zero
    weight in each kernel, and the normalisation sums over K), including
    the conf value masked slots carry (point slot 0's clamped
    conf, the safe-index-0 gather's).

    c_pidx [BG,Ncb,K]; c_loc/c_loc_w/c_srd [BG,Ncb,1,3]. Returns
    (c_decoded [BG,Ncb,1,4], c_weight [BG,Ncb,1,K], c_conf [BG,Ncb,1,K],
    wide_overflow []).

    share (`RowShare`, a piece of a camera row whose budget spans the
    pieces): the wide budget is the whole row's, and this piece's wide
    rows follow the wide rows the pieces before it keep.
    """
    BG, Ncb, Kn = c_pidx.shape
    wide = wide_rows(c_pidx, kt)
    mA = comp_valid & torch.any(c_pidx[..., :kt] >= 0, dim=-1) & ~wide
    mB = comp_valid & wide

    NtB, limB = wide_budget(opt, Ncb), None
    if share is not None:
        NtB, limB = share.wide_rows, share.wide_limit
    cumA = torch.cumsum(mA.to(torch.int32), dim=1, dtype=torch.int32)
    cumB = torch.cumsum(mB.to(torch.int32), dim=1, dtype=torch.int32)
    srcA, validA, _ = _tier_map(mA, cumA, Ncb)    # full budget: no overflow
    srcB, validB, ovB = _tier_map(mB, cumB, NtB, limB)

    def run_tier(src, valid, Ktier, tier):
        tp = _take_rows(c_pidx, src, valid, -1)[..., :Ktier]
        _tally_rows(tier, tp, valid)
        g = npc.gather_neighbors(point_state, tp[:, :, None, :], camrotc2w,
                                 campos)
        dec, _, w_t, cf_t = aggregator_forward(
            agg, opt, g["sampled_color"], g["Rw2c"], g["sampled_dir"],
            g["sampled_conf"], g["sampled_embedding"],
            g["sampled_xyz_pers"], g["sampled_xyz"], g["sample_pnt_mask"],
            _take_rows(c_loc, src, valid, 0.0),
            _take_rows(c_loc_w, src, valid, 0.0),
            _take_rows(c_srd, src, valid, 0.0), grid_vox_sz, vsize)
        return dec, w_t, cf_t

    decA, wA, cfA = run_tier(srcA, validA, kt, "narrow")
    decB, wB, cfB = run_tier(srcB, validB, Kn, "wide")

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
    inB = mB & (cumB <= (NtB if limB is None else limB))
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


def comp_budget(opt, B: int, R: int, SR: int, shards: Shards = Shards()):
    """(G, Ncb) of the query's compaction for B camera rows of R rays:
    each row's rays split into G contiguous groups of Ncb budget rows each
    (Ncb 0: no compaction). shards (b, r): this batch is one of b·r equal
    pieces of a batch of b·B rows by r·R rays (a rank's ray shard,
    `parallel.dp`), so the auto budget reads the global row count, the
    global budget splits over the b·B·comp_groups groups of the whole
    batch, and the piece holds comp_groups / r of each row's groups. A
    comp_groups that r does not divide raises ValueError."""
    b, r = shards.batch, shards.rays
    Bg, Rg = B * b, R * r
    Gg = max(1, int(getattr(opt, "comp_groups", 1)))
    if Gg % r:
        raise ValueError(f"comp_groups={Gg} must be a multiple of the "
                         f"{r} ray shards")
    Nc = effective_sr_budget(opt, Bg * Rg * SR)
    if not 0 < Nc < Bg * Rg * SR:
        return Gg // r, 0
    return Gg // r, -(-Nc // (Bg * Gg))


class QueryOut(NamedTuple):
    """Result of the query phase."""
    sample_pidx: Optional[torch.Tensor]     # [B,R,SR,K] int32 (None if comp)
    sample_loc_w: torch.Tensor              # [B,R,SR,3]
    ray_mask: torch.Tensor                  # [B,R] bool
    sample_ray_dirs: Optional[torch.Tensor]  # [B,R,SR,3], frustum path only
    q_overflow: torch.Tensor                # [] int32 rows past the budget
    comp: Optional[tuple]                   # compacted query (see
                                            # ops.query.query_grid_points)
    occ_overflow: Optional[torch.Tensor] = None  # [] int32, always 0
    share: Optional["RowShare"] = None      # a piece's budget shares


class RowShare(NamedTuple):
    """A piece's shares of its camera rows' budgets when a row's budget
    spans the ray shards (the frustum and vox-grid paths under `Shards`
    with a prefix; `ops.query.row_share`): the compaction's (the vox-grid
    compacts on the shade side; the frustum query has used it already) and
    the wide K tier's. Taken in the query phase, so the shade phase, which
    may run again in the backward pass, makes no collective."""
    limit: object = None        # [B,1] int32 compaction budget left, or None
    rows: int = 0               # its compaction buffer's rows
    wide_limit: object = None   # [B,1] int32 wide-tier budget left, or None
    wide_rows: int = 0          # its wide-tier buffer's rows


def _wide_share(opt, Ncb: int, c_pidx, kept, shards: Shards):
    """(wide_limit, wide_rows) of a piece whose kept rows are `kept`
    [B,N] with neighbor slots c_pidx [B,N,K], under the whole row's
    budget Ncb; (None, 0) without a K-tier split."""
    kt = tier_k(opt, c_pidx.shape[-1])
    if not kt:
        return None, 0
    n = (kept & wide_rows(c_pidx, kt)).sum(dim=1, dtype=torch.int32)
    return row_share(n, wide_budget(opt, Ncb), shards)


TRAIN_JITTER = 0.3     # depth-sample jitter at train (point_query.py:78-81)


def ray_depths(opt, near: float, far: float):
    """The host half of the world query's depth samples between near and
    far (`raygen.near_far_depths`, linear or under `inverse` in
    disparity), [z_depth_dim + 1] float32. A batch may carry them, as a
    tensor on its rays' device, as `depths` in place of near and far: a
    captured train step reads them as an input (`train.graph`)."""
    return raygen.near_far_depths(opt.z_depth_dim, near, far,
                                  disparity=opt.inverse > 0)


def render_query(point_state: Dict, grid: Optional[Dict], spec: GridSpec,
                 opt, batch: Dict, is_train: bool = False,
                 u: Optional[torch.Tensor] = None,
                 prob: bool = False,
                 generator: Optional[torch.Generator] = None,
                 shards: Shards = Shards(),
                 priorities: Optional[torch.Tensor] = None) -> QueryOut:
    """Query phase: ray samples → voxel walk → KNN indices. No gradient
    flows through it. Probe mode needs every row's statistics, so it runs
    uncompacted. The world-coordinate KNN query compacts the rows per ray
    group (`comp_budget`: opt.comp_groups groups per camera row; `shards`
    when the batch is a rank's piece of a wider one).

    World coordinates: at train the depth samples are jittered by the
    uniform draws u [B,R,z_depth_dim] (on the rays' device); the batch's
    `depths` (`ray_depths`), where it has them, stand for near and far.

    wcoord_query 0, the perspective frustum (`ops.frustum`): `spec` is a
    frustum spec, and the camera's grid is built here from the points
    unless `grid` is one already built (a dict holding "xyz_pers", as
    render_image passes once per image). At train u holds the shpnt_jitter
    draws [B,R,SR] (`ops.frustum.draw_jitter`). NN ≤ 0 ranks neighbors by
    `priorities` (`ops.frustum.query_frustum_points`), else by priorities
    drawn from `generator` (a fixed seed without one, as the JAX
    package's fixed key at eval). The samples carry their own ray
    directions.

    The frustum and vox-grid paths compact each camera row into one
    budget; under `shards` with a prefix (`ops.query.Shards`) that budget
    is the whole row's, shared across the ray shards in ray order
    (`RowShare`), so the pieces keep, shade and count what the whole batch
    keeps, shades and counts."""
    if opt.wcoord_query == 0:
        return _frustum_query(point_state, grid, spec, opt, batch, is_train,
                              u, prob, generator, shards, priorities)
    raydir, campos = batch["raydir"], batch["campos"]
    gen = raygen.find_ray_generation_method(
        "near_far_disparity_linear" if opt.inverse > 0 else "near_far_linear")
    if is_train and u is None:
        raise ValueError("a train query needs the jitter draws u")
    planes = {"depths": batch["depths"]} if "depths" in batch else \
        {"near": float(batch["near"]), "far": float(batch["far"])}
    _, _, _, mid_ts = gen(campos, raydir, opt.z_depth_dim,
                          jitter=TRAIN_JITTER if is_train else 0.0, u=u,
                          **planes)
    B, R = raydir.shape[0], raydir.shape[1]
    if opt.NN < 0:
        # vox-grid mode (JAX renderer.py:298-309): the occupancy select
        # (K3) picks the shading samples, and their K = 8 "neighbors" are
        # the corners of their lattice cell. The K = 1 KNN still runs,
        # uncompacted, because ray_mask is defined by it (a ray is valid
        # when a sample found a point within the radius); its indices are
        # dropped. The shade phase compacts the rows.
        _, sample_loc_w, ray_mask, q_overflow, _, occ_over = \
            query_grid_points(campos, raydir, mid_ts, grid, spec, SR=opt.SR,
                              K=1, Nc=0)
        sample_pidx = query_vox_grid(sample_loc_w, grid["vox_table"], spec)
        return QueryOut(sample_pidx, sample_loc_w, ray_mask, None,
                        q_overflow, None, occ_over,
                        None if prob else _vox_share(opt, sample_pidx,
                                                     shards))
    G, Ncb = comp_budget(opt, B, R, opt.SR, shards)
    (sample_pidx, sample_loc_w, ray_mask, q_overflow, comp,
     occ_over) = query_grid_points(
        campos, raydir, mid_ts, grid, spec, SR=opt.SR, K=opt.K,
        G=G, Ncb=0 if prob else Ncb)
    return QueryOut(sample_pidx, sample_loc_w, ray_mask, None, q_overflow,
                    comp, occ_over)


def _vox_share(opt, sample_pidx, shards: Shards) -> Optional[RowShare]:
    """A vox-grid piece's budget shares (the shade side compacts its rows
    with a neighbor into each camera row's budget), or None."""
    if shards.prefix is None:
        return None
    B, R, SR, Kn = sample_pidx.shape
    Bw = B * shards.batch
    Nc = effective_sr_budget(opt, Bw * R * shards.rays * SR)
    if not 0 < Nc < Bw * R * shards.rays * SR:
        return None
    Ncb = -(-Nc // Bw)
    vmat = torch.any(sample_pidx >= 0, dim=-1).reshape(B, R * SR)
    limit, rows = row_share(vmat.sum(dim=1, dtype=torch.int32), Ncb, shards)
    cum = torch.cumsum(vmat.to(torch.int32), dim=1, dtype=torch.int32)
    kept = vmat & (cum <= limit)
    wlim, wrows = _wide_share(opt, Ncb, sample_pidx.reshape(B, R * SR, Kn),
                              kept, shards)
    return RowShare(limit, rows, wlim, wrows)


def _frustum_query(point_state, grid, spec, opt, batch, is_train, u, prob,
                   generator, shards: Shards, priorities) -> QueryOut:
    raydir, campos = batch["raydir"], batch["campos"]
    if grid is not None and "xyz_pers" in grid:
        fgrid, xyz_pers = grid, grid["xyz_pers"]
    else:
        fgrid, xyz_pers = build_frustum_grid(
            point_state["xyz"].detach(), point_state["mask"],
            batch["camrotc2w"], campos, spec)
    if is_train and u is None and opt.shpnt_jitter != "passfunc":
        raise ValueError("a train query needs the shpnt_jitter draws u")
    B, R = raydir.shape[0], raydir.shape[1]
    Bw, Rw = B * shards.batch, R * shards.rays
    Nc = effective_sr_budget(opt, Bw * Rw * opt.SR) if not prob else 0
    (sample_pidx, sample_loc_w, sample_ray_dirs, ray_mask, q_overflow,
     comp) = query_frustum_points(
        raydir, batch["camrotc2w"], campos, xyz_pers, fgrid, spec, SR=opt.SR,
        K=opt.K, jitter=opt.shpnt_jitter, u=u, is_train=is_train, Nc=Nc,
        rand_mode=opt.NN <= 0, priorities=priorities, generator=generator,
        shards=shards)
    share = None
    if comp is not None and shards.prefix is not None:
        share = RowShare(None, 0, *_wide_share(opt, -(-Nc // Bw), comp[2],
                                               comp[1], shards))
    return QueryOut(sample_pidx, sample_loc_w, ray_mask, sample_ray_dirs,
                    q_overflow, comp, None, share)


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
    (sample_pidx, sample_loc_w, ray_mask, sample_ray_dirs, q_overflow,
     q_comp, occ_overflow, share) = query_out

    sample_loc = w2pers(sample_loc_w, camrotc2w, campos)
    if sample_ray_dirs is None:
        sample_ray_dirs = raydir[:, :, None, :].expand(sample_loc.shape)
    SR = sample_loc.shape[2]
    S = B * R * SR
    if prob and q_comp is not None:
        raise ValueError("probe mode needs an uncompacted query "
                         "(render_query(prob=True))")
    gvs = float(spec.vox_gvs)
    RS = R * SR
    Nc = effective_sr_budget(opt, S)
    if q_comp is None and (share is not None or 0 < Nc < S) and not prob:
        # shade-side compaction (JAX renderer.py:350-390, one group): the
        # vox-grid query returns full-shape indices, so the rows with a
        # neighbor are packed here, each batch row into ceil(Nc/B) slots
        # in row order (a piece of a camera row: its share of the row's,
        # `RowShare`); rows past the budget render empty and add to
        # q_overflow. Row r of batch row b reads back packed slot
        # b·Ncb + rank[r] (src_row), a zero row when not kept.
        Ncb, lim = (-(-Nc // B), None) if share is None else \
            (share.rows, share.limit)
        ray_valid = torch.any(sample_pidx >= 0, dim=-1)        # [B,R,SR]
        vmat = ray_valid.reshape(B, RS)
        cum = torch.cumsum(vmat.to(torch.int32), dim=1, dtype=torch.int32)
        comp_src, comp_valid, over = _tier_map(vmat, cum, Ncb, lim)
        q_overflow = q_overflow + over
        boff = torch.arange(B, dtype=torch.int32,
                            device=raydir.device)[:, None] * Ncb
        src_row = torch.where(vmat & (cum <= (Ncb if lim is None else lim)),
                              cum - 1 + boff, B * Ncb).reshape(-1).long()
        q_comp = (comp_src, comp_valid,
                  _take_rows(sample_pidx.reshape(B, RS, -1), comp_src,
                             comp_valid, -1), ray_valid, None)
    if q_comp is not None:
        # rows with >= 1 candidate were compacted by the query (or just
        # above) into a per-batch-row budget; the shade phase runs on
        # those rows only
        # comp_groups: the leading dim is B·G, each group a contiguous
        # block of RS / G rows of its camera row, and comp_src indexes
        # inside the block
        comp_src, comp_valid, c_pidx_mat, ray_valid, counts = q_comp
        BG, Ncb = comp_src.shape
        _tally_occupied(comp_valid.sum(dtype=torch.int64) + q_overflow)
        goff = (torch.arange(BG, device=raydir.device)
                * (RS // (BG // B)))[:, None]
        gsrc = (comp_src + goff).reshape(-1).long()

        def compact(a):
            out = a.reshape((S,) + a.shape[3:])[gsrc]
            v = comp_valid.reshape((BG * Ncb,) + (1,) * (out.dim() - 1))
            out = torch.where(v, out, torch.zeros((), dtype=out.dtype,
                                                  device=out.device))
            return out.reshape((BG, Ncb, 1) + a.shape[3:])

        c_loc, c_loc_w = compact(sample_loc), compact(sample_loc_w)
        c_srd = compact(sample_ray_dirs)
        kt = tier_k(opt, c_pidx_mat.shape[-1])
        if kt:
            c_decoded, c_weight, c_conf, t_overflow = _tiered_aggregate(
                agg, point_state, opt, c_pidx_mat, comp_valid, c_loc,
                c_loc_w, c_srd, camrotc2w, campos, kt, gvs, spec.vsize,
                share)
            q_overflow = q_overflow + t_overflow
        else:
            _tally_rows("wide", c_pidx_mat, comp_valid & torch.any(
                c_pidx_mat >= 0, dim=-1))
            g = npc.gather_neighbors(point_state, c_pidx_mat[:, :, None, :],
                                     camrotc2w, campos)
            c_decoded, _, c_weight, c_conf = aggregator_forward(
                agg, opt, g["sampled_color"], g["Rw2c"], g["sampled_dir"],
                g["sampled_conf"], g["sampled_embedding"],
                g["sampled_xyz_pers"], g["sampled_xyz"],
                g["sample_pnt_mask"], c_loc, c_loc_w, c_srd, gvs, spec.vsize)

        def scatter_back(c):
            if counts is None:      # the gather form of JAX's unique scatter
                flat = c.reshape((B * Ncb,) + c.shape[3:])
                flat = torch.cat([flat, flat.new_zeros((1,) + c.shape[3:])])
                return flat[src_row].reshape((B, R, SR) + c.shape[3:])
            out = expand_compacted(SR, c[:, :, 0], counts, comp_src,
                                   comp_valid)
            return out.reshape((B, R, SR) + c.shape[3:])

        decoded = scatter_back(c_decoded)
        weight = scatter_back(c_weight)
        conf_coefficient = scatter_back(c_conf)
        decoded = decoded * ray_valid[..., None].to(decoded.dtype)
        compact_losses = {
            "conf_compact": c_conf,                       # [BG,Ncb,1,K]
            "weight_compact": c_weight.detach(),
            "compact_valid": comp_valid.reshape(BG, Ncb, 1, 1),
            "zero_one_total": torch.full((), S * c_conf.shape[-1],
                                         dtype=torch.int64,
                                         device=c_conf.device),
        }
    else:
        compact_losses = {}
        if profiling.tallying() is not None:
            has = torch.any(sample_pidx >= 0, dim=-1)
            _tally_occupied(has.sum(dtype=torch.int64))
            _tally_rows("dense", sample_pidx, has)
        g = npc.gather_neighbors(point_state, sample_pidx, camrotc2w, campos)
        decoded, ray_valid, weight, conf_coefficient = aggregator_forward(
            agg, opt, g["sampled_color"], g["Rw2c"], g["sampled_dir"],
            g["sampled_conf"], g["sampled_embedding"], g["sampled_xyz_pers"],
            g["sampled_xyz"], g["sample_pnt_mask"], sample_loc, sample_loc_w,
            sample_ray_dirs, gvs, spec.vsize)
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


def render_forward(agg, point_state: Dict, grid: Optional[Dict],
                   spec: GridSpec, opt, batch: Dict, prob: bool = False,
                   shards: Shards = Shards()) -> Dict:
    """Render a batch of rays (query + shade), at eval.

    batch: raydir [B,R,3], campos [B,3], camrotc2w [B,3,3], near/far
    scalars, bg_color [B,3]. `grid`: the world grid, or on the frustum path
    None (built here) or a prebuilt camera grid (see render_query). Returns
    the reference output dict (coarse_raycolor, ray_mask,
    coarse_point_opacity, ...), with the probe statistics when `prob` is
    set (see render_shade).
    """
    q = render_query(point_state, grid, spec, opt, batch, prob=prob,
                     shards=shards)
    return render_shade(agg, point_state, spec, opt, batch, q, prob=prob)
