"""Fused per-neighbor shading trunk, forward and backward (port of
`ops/pallas_trunk.py`).

Per (shading point, neighbor) row:

    x1 = [emb, PE(emb), PE(dists)]
    h  = block1(x1)                 (1-2 LeakyReLU Linear layers)
    g  = block3([h, ex3])           (1-2 LeakyReLU Linear layers)
    a  = raw2out_density(alpha_branch(g))

then the weighted sum over each shading point's K contiguous neighbor rows.
`fused_trunk` is differentiable through `FusedTrunk`. On CUDA tensors the
forward launches `csrc/trunk_fwd.cu` (K1) and the backward
`csrc/trunk_bwd.cu` (K2); on CPU tensors they run their plain PyTorch
versions, `fused_trunk_reference` and `fused_trunk_bwd_reference`. As in
the JAX package, the PE selection constants get no gradient.

With bf16=True (the JAX kernels' bf16 form, `--trunk_dtype bfloat16`)
every MLP product takes operands rounded to bfloat16 and sums in float32,
at the JAX kernels' rounding sites (`_dot_bf16`); the PE projections, the
biases, the activations, dw and the K-sums stay float32. CUDA tensors
launch `csrc/trunk_fwd_bf16.cu` (K1b) and `csrc/trunk_bwd_bf16.cu` (K2b).

`fused_shade` (port of the JAX `fused_shade`, the `fused_shade`
configuration) moves the front half in front of the trunk: from the
neighbors' positions, colors, directions, confs and validity it forms the
distances, the 1/‖d‖ weights normalized over each K-group, the clamped conf
and ex3, then runs the trunk on them, and its backward returns the
per-attribute cotangents. `FusedShade` launches `csrc/shade_fwd.cu` (K4)
and `csrc/shade_bwd.cu` (K5) on CUDA tensors and runs
`fused_shade_reference` / `fused_shade_bwd_reference` on CPU tensors.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import kernels
from .pe import pe_args, pe_input_grad

NEG_SLOPE = 0.1
BWD_TILE = 32          # rows per K2/K5 tile (TILE in csrc/trunk_bwd.cuh)
BWD_MAX_WIDTH = 288    # widest product K2/K5 run in place (MAX_N there)
FWD_BF16_MAX_WIDTH = 576   # widest layer input K1b holds in shared memory
                           # (nine 64-column panels a warpgroup)


def pack_trunk_params(agg, F_emb: int, dd: int, n_feat_freqs: int,
                      n_dist_freqs: int, with_alpha: bool = True
                      ) -> List[torch.Tensor]:
    """Flatten block1/block3[/alpha_branch] into the kernel's operand list,
    in the JAX layout: weights [in, out] contiguous, biases [1, out]. The
    block1 first layer splits by piece [emb | PE(emb) | PE(dists)], block3's
    by [h | ex3]; the pieces are row views of one transposed weight, which
    the kernels read whole. The operands stay differentiable: gradients on
    them flow back to the Linear weights. with_alpha=False (order 1): the
    alpha head runs outside."""
    from ..models.networks import linears
    b1, b3 = linears(agg.block1), linears(agg.block3)
    pe_e = 2 * n_feat_freqs * F_emb
    pe_d = 2 * n_dist_freqs * dd
    wT = lambda lin: lin.weight.t().contiguous()
    bias = lambda lin: lin.bias.reshape(1, -1)
    w1 = wT(b1[0])
    if w1.shape[0] != F_emb + pe_e + pe_d:
        raise ValueError(f"block1 takes {w1.shape[0]} inputs, pieces give "
                         f"{F_emb}+{pe_e}+{pe_d}")
    ops = [w1[:F_emb], w1[F_emb:F_emb + pe_e], w1[F_emb + pe_e:], bias(b1[0])]
    for lin in b1[1:]:
        ops += [wT(lin), bias(lin)]
    w3 = wT(b3[0])
    H = b1[-1].out_features
    ops += [w3[:H], w3[H:], bias(b3[0])]
    for lin in b3[1:]:
        ops += [wT(lin), bias(lin)]
    if with_alpha:
        al = linears(agg.alpha_branch)[0]
        ops += [wT(al), bias(al)]
    return ops


def _unpack(ops, L1: int, L3: int, with_alpha: bool):
    """ops -> (w1e, w1p, w1d, b1, extra1, w3x, w3e, b3, extra3, wa, ba)."""
    n = 4 + 2 * (L1 - 1) + 3 + 2 * (L3 - 1) + (2 if with_alpha else 0)
    if len(ops) != n:
        raise ValueError(f"{len(ops)} trunk operands, expected {n}")
    w1e, w1p, w1d, b1 = ops[:4]
    i = 4
    extra1 = [(ops[i + 2 * j], ops[i + 2 * j + 1]) for j in range(L1 - 1)]
    i += 2 * (L1 - 1)
    w3x, w3e, b3 = ops[i:i + 3]
    i += 3
    extra3 = [(ops[i + 2 * j], ops[i + 2 * j + 1]) for j in range(L3 - 1)]
    i += 2 * (L3 - 1)
    wa, ba = (ops[i], ops[i + 1]) if with_alpha else (None, None)
    return w1e, w1p, w1d, b1, extra1, w3x, w3e, b3, extra3, wa, ba


def _rn(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (nearest, ties to even), kept in float32."""
    return x.bfloat16().float()


def _mm(a: torch.Tensor, b: torch.Tensor, bf16: bool) -> torch.Tensor:
    """a @ b in float32, or (bf16) of the operands rounded to bfloat16: the
    products of bfloat16 values are exact in float32 and sum in float32, as
    the JAX kernels' `_dot_bf16` (a product of bfloat16 tensors would round
    its output)."""
    return _rn(a) @ _rn(b) if bf16 else a @ b


def _leaky(x):
    return F.leaky_relu(x, NEG_SLOPE)


def _dleaky(z):
    return torch.where(z >= 0, 1.0, NEG_SLOPE)


def _alpha_act(za: torch.Tensor, act_super: bool) -> torch.Tensor:
    """raw2out_density: softplus(x-1) (mip-NeRF stabilisation) or relu."""
    return F.softplus(za - 1.0) if act_super else torch.relu(za)


def _dalpha_act(za: torch.Tensor, act_super: bool) -> torch.Tensor:
    return torch.sigmoid(za - 1.0) if act_super else (za >= 0).to(za.dtype)


def trunk_activations(L1: int, L3: int, n_feat_freqs: int,
                      n_dist_freqs: int, emb, d, ex3, ops, with_alpha: bool,
                      bf16: bool = False):
    """The trunk's forward per neighbor row, every layer kept: (t_e, t_d,
    zs1, hs, zs3, gs) with t_* the PE sine arguments, zs*/hs/gs each
    LeakyReLU layer's input and output in block1 and block3. bf16: the
    layer products take bfloat16-rounded operands (the PE arguments stay
    float32, as in the JAX kernel's `_fwd_tile`)."""
    w1e, w1p, w1d, b1, extra1, w3x, w3e, b3, extra3, _, _ = _unpack(
        ops, L1, L3, with_alpha)
    mm = lambda a, b: _mm(a, b, bf16)
    t_e = pe_args(emb, n_feat_freqs)
    t_d = pe_args(d, n_dist_freqs)
    zs1 = [mm(emb, w1e) + mm(torch.sin(t_e), w1p) + mm(torch.sin(t_d), w1d)
           + b1]
    hs = [_leaky(zs1[0])]
    for wl, bl in extra1:
        zs1.append(mm(hs[-1], wl) + bl)
        hs.append(_leaky(zs1[-1]))
    zs3 = [mm(hs[-1], w3x) + mm(ex3, w3e) + b3]
    gs = [_leaky(zs3[0])]
    for wl, bl in extra3:
        zs3.append(mm(gs[-1], wl) + bl)
        gs.append(_leaky(zs3[-1]))
    return t_e, t_d, zs1, hs, zs3, gs


def fused_trunk_reference(L1: int, L3: int, n_feat_freqs: int,
                          n_dist_freqs: int, K: int, act_super: bool,
                          order1: bool, emb, d, ex3, w, ops,
                          bf16: bool = False
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of the trunk forward (K1, or K1b with bf16):
    same arguments, same outputs as `fused_trunk`."""
    g = trunk_activations(L1, L3, n_feat_freqs, n_dist_freqs, emb, d, ex3,
                          ops, not order1, bf16)[-1][-1]
    S = emb.shape[0]

    def group_sum(x):
        return torch.sum(x.reshape(S // K, K, x.shape[1]), dim=1)

    feat = group_sum(g * w)
    if order1:
        return feat, None
    wa, ba = ops[-2:]
    return feat, group_sum(_alpha_act(_mm(g, wa, bf16) + ba, act_super) * w)


def fused_trunk_bwd_reference(L1: int, L3: int, n_feat_freqs: int,
                              n_dist_freqs: int, K: int, act_super: bool,
                              order1: bool, emb, d, ex3, w, ops, dfeat,
                              dalpha, bf16: bool = False):
    """Plain PyTorch version of the trunk backward (K2, or K2b with bf16),
    a transcription of the Pallas `_bwd_kernel`: recompute the forward,
    then chain the per-shading-point cotangents dfeat [S/K,H] and dalpha
    [S/K,1] (None for order 1) back through the alpha head, block3, block1
    and the PE sines. With bf16 every product rounds its operands, the PE
    input gradient (dx·cos) included before its sum. Returns (demb, dd,
    dex3, dw, dops), dops one gradient per op."""
    w1e, w1p, w1d, b1, extra1, w3x, w3e, b3, extra3, wa, ba = _unpack(
        ops, L1, L3, not order1)
    mm = lambda a, b: _mm(a, b, bf16)
    t_e, t_d, zs1, hs, zs3, gs = trunk_activations(
        L1, L3, n_feat_freqs, n_dist_freqs, emb, d, ex3, ops, not order1,
        bf16)
    pe_e, pe_d = torch.sin(t_e), torch.sin(t_d)
    g = gs[-1]

    dfeat_r = dfeat.repeat_interleave(K, dim=0)   # un-group to neighbor rows
    dw = torch.sum(g * dfeat_r, dim=1, keepdim=True)
    dg = dfeat_r * w
    head = []
    if not order1:
        za = mm(g, wa) + ba
        dalpha_r = dalpha.repeat_interleave(K, dim=0)
        dw = dw + _alpha_act(za, act_super) * dalpha_r
        dza = dalpha_r * w * _dalpha_act(za, act_super)
        dg = dg + mm(dza, wa.t())
        head = [mm(g.t(), dza), torch.sum(dza, dim=0, keepdim=True)]

    def back(dcur, zs, acts, extra):
        """Chain dcur back through the layers after a block's first:
        returns (dz of the first layer, [(dW, db) of the later layers])."""
        later = []
        for li in range(len(extra), 0, -1):
            dz = dcur * _dleaky(zs[li])
            later.insert(0, (mm(acts[li - 1].t(), dz),
                             torch.sum(dz, dim=0, keepdim=True)))
            dcur = mm(dz, extra[li - 1][0].t())
        return dcur * _dleaky(zs[0]), later

    dz3, later3 = back(dg, zs3, gs, extra3)
    dex3 = mm(dz3, w3e.t())
    dz1, later1 = back(mm(dz3, w3x.t()), zs1, hs, extra1)

    dops = [mm(emb.t(), dz1), mm(pe_e.t(), dz1), mm(pe_d.t(), dz1),
            torch.sum(dz1, dim=0, keepdim=True)]
    dops += [t for pair in later1 for t in pair]
    dops += [mm(hs[-1].t(), dz3), mm(ex3.t(), dz3),
             torch.sum(dz3, dim=0, keepdim=True)]
    dops += [t for pair in later3 for t in pair]
    dops += head
    # the PE selection's entries are powers of two (exact in bfloat16): its
    # product is the rounded gradient scaled and summed per channel
    sel = _rn if bf16 else (lambda x: x)
    demb = mm(dz1, w1e.t()) + pe_input_grad(
        sel(mm(dz1, w1p.t()) * torch.cos(t_e)), n_feat_freqs)
    dd = pe_input_grad(sel(mm(dz1, w1d.t()) * torch.cos(t_d)), n_dist_freqs)
    return demb, dd, dex3, dw, dops


def _device_of(emb: torch.Tensor, name: str) -> str:
    if emb.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {emb.device}")
    return emb.device.type


def _trunk_forward(cfg, emb, d, ex3, w, ops):
    *head, bf16 = cfg
    if _device_of(emb, "fused_trunk") == "cpu":
        return fused_trunk_reference(*head, emb, d, ex3, w, ops, bf16)
    return _launch(*head, emb, d, ex3, w, ops, bf16)


class FusedTrunk(torch.autograd.Function):
    """`fused_trunk` with the gradient of the Pallas custom VJP: the
    backward recomputes the forward (nothing but the inputs is saved) and
    returns demb, dd, dex3, dw and one gradient per trunk op. cfg is
    (L1, L3, n_feat_freqs, n_dist_freqs, K, act_super, order1, bf16)."""

    @staticmethod
    def forward(ctx, cfg, emb, d, ex3, w, *ops):
        ctx.cfg = cfg
        ctx.save_for_backward(emb, d, ex3, w, *ops)
        return _trunk_forward(cfg, emb, d, ex3, w, ops)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dfeat, dalpha):
        emb, d, ex3, w, *ops = ctx.saved_tensors
        *head, bf16 = ctx.cfg
        order1 = head[6]
        S, K = emb.shape[0], head[4]
        if dfeat is None:
            dfeat = emb.new_zeros((S // K, ops[-1].shape[1] if order1
                                   else ops[-2].shape[0]))
        if not order1 and dalpha is None:
            dalpha = emb.new_zeros((S // K, 1))
        demb, dd, dex3, dw, dops = trunk_bwd(
            *head, emb, d, ex3, w, ops, dfeat.contiguous(),
            None if order1 else dalpha.contiguous(), bf16)
        return (None, demb, dd, dex3, dw, *dops)


def trunk_bwd(L1: int, L3: int, n_feat_freqs: int, n_dist_freqs: int,
              K: int, act_super: bool, order1: bool, emb, d, ex3, w, ops,
              dfeat, dalpha, bf16: bool = False):
    """The trunk backward: K2 (K2b with bf16) on CUDA tensors, its plain
    version `fused_trunk_bwd_reference` on CPU tensors (same arguments,
    same returns: demb, dd, dex3, dw and one gradient per op)."""
    args = (L1, L3, n_feat_freqs, n_dist_freqs, K, act_super, order1, emb, d,
            ex3, w, ops, dfeat, dalpha, bool(bf16))
    if _device_of(emb, "trunk_bwd") == "cpu":
        return fused_trunk_bwd_reference(*args)
    return _launch_bwd(*args)


def fused_trunk(L1: int, L3: int, n_feat_freqs: int, n_dist_freqs: int,
                K: int, act_super: bool, order1: bool,
                emb: torch.Tensor, d: torch.Tensor, ex3: torch.Tensor,
                w: torch.Tensor, ops: Sequence[torch.Tensor],
                bf16: bool = False
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """emb/d/ex3 [S,*] per-NEIGHBOR rows (the K neighbors of each shading
    point contiguous), w [S,1] effective neighbor weights, ops from
    pack_trunk_params. Returns per-SHADING-POINT (feat_pt [S/K,H],
    alpha_pt [S/K,1]); order1 returns (feat_pt, None). bf16: the products
    take bfloat16-rounded operands (the JAX kernels' bf16 form).

    CPU tensors run the plain versions; CUDA tensors launch the kernels
    (K1 and K2, or K1b and K2b). Differentiable in every tensor argument.
    """
    cfg = (L1, L3, n_feat_freqs, n_dist_freqs, K, bool(act_super),
           bool(order1), bool(bf16))
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (emb, d, ex3, w, *ops)):
        return FusedTrunk.apply(cfg, emb, d, ex3, w, *ops)
    return _trunk_forward(cfg, emb, d, ex3, w, ops)


# ------------------------------------------------------------ fused shade
DIST_COLS = {0: 3, 20: 6}   # distance columns of each supported dist mode
SHADE_E3 = 7                # ex3 = [color | sdir - ovd | <sdir, ovd>]


class ShadeFront(NamedTuple):
    """The front half's values on [S,*] neighbor rows (S_w per group)."""
    d_world: torch.Tensor   # [S,3] neighbor minus sample, world frame
    n: torch.Tensor         # [S,1] ‖d_world‖
    nc: torch.Tensor        # [S,1] max(n, 1e-6)
    w_raw: torch.Tensor     # [S,1] mask / nc
    S_w: torch.Tensor       # [S/K,1] Σ_K w_raw
    S_wr: torch.Tensor      # [S,1] max(S_w, 1e-8), per row
    w_n: torch.Tensor       # [S,1] w_raw / S_wr
    conf_c: torch.Tensor    # [S,1] conf clamped to [1e-4, 1] (identity bwd)
    w_eff: torch.Tensor     # [S,1] w_n · conf_c
    d_raw: torch.Tensor     # [S,dd] [d_world·RT | perspective diffs]
    ex3: torch.Tensor       # [S,7]


def shade_front(xyz, xyzp, color, pdir, conf, mask, sl, slw, ovd, RT,
                dist_mode: int, K: int) -> ShadeFront:
    """The front half of the shade kernels (JAX `_shade_front`): neighbor
    rows [S,*] (xyz world, xyzp perspective, color, pdir, conf, mask as
    float validity), per-shading-point rows [S/K,3] (sl perspective and
    slw world sample location, ovd camera-frame view direction), RT =
    Rw2cᵀ [3,3]. Dist mode 20 appends the perspective diffs to the rotated
    world diff; mode 0 is the rotated world diff alone."""
    if dist_mode not in DIST_COLS:
        raise ValueError(f"fused_shade takes dist modes {sorted(DIST_COLS)},"
                         f" not {dist_mode}")
    S = xyz.shape[0]
    up = lambda x: x.repeat_interleave(K, dim=0)
    slr, ovdr = up(sl), up(ovd)
    d_world = xyz - up(slw)
    n = torch.sqrt(torch.sum(d_world * d_world, dim=1, keepdim=True))
    nc = torch.clamp(n, min=1e-6)
    w_raw = mask / nc
    S_w = torch.sum(w_raw.reshape(S // K, K, 1), dim=1)
    S_wr = up(torch.clamp(S_w, min=1e-8))
    w_n = w_raw / S_wr
    conf_c = conf - (conf - torch.clamp(conf, 1e-4, 1.0)).detach()
    d_raw = d_world @ RT
    if dist_mode == 20:
        xd = xyzp[:, 0:1] * xyzp[:, 2:3] - slr[:, 0:1] * slr[:, 2:3]
        yd = xyzp[:, 1:2] * xyzp[:, 2:3] - slr[:, 1:2] * slr[:, 2:3]
        zd = xyzp[:, 2:3] - slr[:, 2:3]
        d_raw = torch.cat([d_raw, xd, yd, zd], dim=1)
    sdir = pdir @ RT
    ex3 = torch.cat([color, sdir - ovdr,
                     torch.sum(sdir * ovdr, dim=1, keepdim=True)], dim=1)
    return ShadeFront(d_world, n, nc, w_raw, S_w, S_wr, w_n, conf_c,
                      w_n * conf_c, d_raw, ex3)


def fused_shade_reference(L1: int, L3: int, n_feat_freqs: int,
                          n_dist_freqs: int, K: int, act_super: bool,
                          order1: bool, dist_mode: int, emb, xyz, xyzp,
                          color, pdir, conf, mask, sl, slw, ovd, RT, ops):
    """Plain PyTorch version of the shade forward (K4): shade_front, then
    the trunk, the K-sum and (order 2) the alpha head. Returns (feat
    [S/K,H], alpha [S/K,1] | None, w_n [S,1], conf_c [S,1]), as the JAX
    `_shade_fwd_impl`."""
    f = shade_front(xyz, xyzp, color, pdir, conf, mask, sl, slw, ovd, RT,
                    dist_mode, K)
    feat, alpha = fused_trunk_reference(
        L1, L3, n_feat_freqs, n_dist_freqs, K, act_super, order1, emb,
        f.d_raw, f.ex3, f.w_eff, ops)
    return feat, alpha, f.w_n, f.conf_c


def fused_shade_bwd_reference(L1: int, L3: int, n_feat_freqs: int,
                              n_dist_freqs: int, K: int, act_super: bool,
                              order1: bool, dist_mode: int, emb, xyz, xyzp,
                              color, pdir, conf, mask, sl, slw, ovd, RT, ops,
                              dfeat, dalpha, dwout, dconfout):
    """Plain PyTorch version of the shade backward (K5), a transcription of
    the Pallas `_shade_bwd_kernel`: the trunk backward on the recomputed
    front, then the front's own backward from the cotangents dfeat [S/K,H],
    dalpha [S/K,1] (None for order 1), dwout and dconfout [S,1]. Returns
    (demb, dxyz, dxyzp, dcolor, ddir, dconf, dops), dops one gradient per
    op."""
    f = shade_front(xyz, xyzp, color, pdir, conf, mask, sl, slw, ovd, RT,
                    dist_mode, K)
    demb, dd_raw, dex3, dw_eff, dops = fused_trunk_bwd_reference(
        L1, L3, n_feat_freqs, n_dist_freqs, K, act_super, order1, emb,
        f.d_raw, f.ex3, f.w_eff, ops, dfeat, dalpha)
    S = emb.shape[0]
    up = lambda x: x.repeat_interleave(K, dim=0)
    dcolor = dex3[:, :3]
    ddir = (dex3[:, 3:6] + dex3[:, 6:7] * up(ovd)) @ RT.t()
    if dist_mode == 20:
        ddp = dd_raw[:, 3:6]
        xp, yp, zp = xyzp[:, 0:1], xyzp[:, 1:2], xyzp[:, 2:3]
        dxyzp = torch.cat([ddp[:, 0:1] * zp, ddp[:, 1:2] * zp,
                           ddp[:, 0:1] * xp + ddp[:, 1:2] * yp + ddp[:, 2:3]],
                          dim=1)
    else:
        dxyzp = torch.zeros_like(xyzp)
    # w_eff = w_n·conf_c, w_n = w_raw / max(Σ_K w_raw, 1e-8),
    # w_raw = mask / max(‖d_world‖, 1e-6); the conf clamp is identity-bwd
    dconf = dw_eff * f.w_n + dconfout
    dw_n = dw_eff * f.conf_c + dwout
    gate = up((f.S_w > 1e-8).to(dw_n.dtype))
    dwn_wn = up(torch.sum((dw_n * f.w_n).reshape(S // K, K, 1), dim=1))
    dw_raw = (dw_n - dwn_wn * gate) / f.S_wr
    dnc = -f.w_raw / f.nc * dw_raw * (f.n > 1e-6).to(dw_n.dtype)
    dxyz = dd_raw[:, :3] @ RT.t() + dnc * f.d_world / f.nc
    return demb, dxyz, dxyzp, dcolor, ddir, dconf, dops


SHADE_ROW_ARGS = 11     # emb, xyz, xyzp, color, pdir, conf, mask, sl, slw,
                        # ovd, RT


def _shade_forward(cfg, args, ops):
    if _device_of(args[0], "fused_shade") == "cpu":
        return fused_shade_reference(*cfg, *args, ops)
    return _launch_shade(*cfg, *args, ops)


class FusedShade(torch.autograd.Function):
    """`fused_shade` with the gradient of the Pallas custom VJP: the
    backward recomputes the forward and returns demb, dxyz, dxyzp, dcolor,
    ddir, dconf and one gradient per trunk op; mask, sl, slw, ovd and RT
    get none (query outputs, constant under the gradient)."""

    @staticmethod
    def forward(ctx, cfg, *args_ops):
        ctx.cfg = cfg
        ctx.save_for_backward(*args_ops)
        return _shade_forward(cfg, args_ops[:SHADE_ROW_ARGS],
                              args_ops[SHADE_ROW_ARGS:])

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dfeat, dalpha, dwout, dconfout):
        saved = ctx.saved_tensors
        args, ops = saved[:SHADE_ROW_ARGS], saved[SHADE_ROW_ARGS:]
        order1, K = ctx.cfg[6], ctx.cfg[4]
        emb = args[0]
        S = emb.shape[0]
        H = ops[-1].shape[1] if order1 else ops[-2].shape[0]
        zeros = lambda rows, cols: emb.new_zeros((rows, cols))
        dfeat = zeros(S // K, H) if dfeat is None else dfeat.contiguous()
        if order1:
            dalpha = None
        elif dalpha is None:
            dalpha = zeros(S // K, 1)
        else:
            dalpha = dalpha.contiguous()
        dwout = zeros(S, 1) if dwout is None else dwout.contiguous()
        dconfout = zeros(S, 1) if dconfout is None else dconfout.contiguous()
        demb, dxyz, dxyzp, dcolor, ddir, dconf, dops = shade_bwd(
            *ctx.cfg, *args, ops, dfeat, dalpha, dwout, dconfout)
        return (None, demb, dxyz, dxyzp, dcolor, ddir, dconf,
                None, None, None, None, None, *dops)


def shade_bwd(L1: int, L3: int, n_feat_freqs: int, n_dist_freqs: int,
              K: int, act_super: bool, order1: bool, dist_mode: int, emb,
              xyz, xyzp, color, pdir, conf, mask, sl, slw, ovd, RT, ops,
              dfeat, dalpha, dwout, dconfout):
    """The shade backward: K5 on CUDA tensors, its plain version
    `fused_shade_bwd_reference` on CPU tensors (same arguments, same
    returns)."""
    args = (L1, L3, n_feat_freqs, n_dist_freqs, K, act_super, order1,
            dist_mode, emb, xyz, xyzp, color, pdir, conf, mask, sl, slw, ovd,
            RT, ops, dfeat, dalpha, dwout, dconfout)
    if _device_of(emb, "shade_bwd") == "cpu":
        return fused_shade_bwd_reference(*args)
    return _launch_shade_bwd(*args)


def fused_shade(L1: int, L3: int, n_feat_freqs: int, n_dist_freqs: int,
                K: int, act_super: bool, order1: bool, dist_mode: int,
                emb, xyz, xyzp, color, pdir, conf, mask, sl, slw, ovd, RT,
                ops: Sequence[torch.Tensor]):
    """Front half + trunk in one kernel (the JAX `fused_shade`, without its
    TPU tile and interpret arguments).

    Per-NEIGHBOR rows [S,*]: emb, xyz (world), xyzp (perspective), color,
    pdir (point dirs), conf, mask (float validity). Per-SHADING-POINT rows
    [S/K,3]: sl (perspective sample location), slw (world sample
    location), ovd (camera-frame view dirs). RT = Rw2cᵀ [3,3]. Returns
    (feat_pt [S/K,H], alpha_pt [S/K,1] | None, weight [S,1] post-norm
    pre-conf, conf_coefficient [S,1]). CPU tensors run the plain versions;
    CUDA tensors launch K4 (and K5 in the backward). Differentiable in
    emb, xyz, xyzp, color, pdir, conf and the ops.
    """
    cfg = (L1, L3, n_feat_freqs, n_dist_freqs, K, bool(act_super),
           bool(order1), int(dist_mode))
    args = (emb, xyz, xyzp, color, pdir, conf, mask, sl, slw, ovd, RT)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (*args, *ops)):
        return FusedShade.apply(cfg, *args, *ops)
    return _shade_forward(cfg, args, ops)


def _joined(*pieces: torch.Tensor) -> torch.Tensor:
    """The [Σrows, H] matrix whose consecutive row blocks are `pieces`,
    without a copy. pack_trunk_params cuts a first layer's input pieces
    from one contiguous transposed weight, so the kernels read that weight
    whole; pieces laid out any other way are refused."""
    first = pieces[0]
    H = first.shape[1]
    base = first.untyped_storage().data_ptr()
    offset = first.storage_offset()
    for p in pieces:
        if (not p.is_contiguous() or p.dim() != 2 or p.shape[1] != H
                or p.untyped_storage().data_ptr() != base
                or p.storage_offset() != offset):
            raise ValueError("split trunk weights must be consecutive row "
                             "blocks of one buffer: pack them with "
                             "pack_trunk_params")
        offset += p.numel()
    rows = (offset - first.storage_offset()) // H
    return first.as_strided((rows, H), (H, 1))


def _trunk_rows(emb, d, ex3, w):
    """Validate the row inputs K1 and K2 take; returns (S, Fe, dd, E3)."""
    S, Fe = emb.shape
    dd, E3 = d.shape[1], ex3.shape[1]
    dev, f32 = emb.device, torch.float32
    kernels.require(emb, "emb", f32, dev, (S, Fe))
    kernels.require(d, "d", f32, dev, (S, dd))
    kernels.require(ex3, "ex3", f32, dev, (S, E3))
    kernels.require(w, "w", f32, dev, (S, 1))
    return S, Fe, dd, E3


def _weight_operands(L1, L3, nf, nd, K, order1, S, Fe, dd, E3, dev, ops):
    """Validate the trunk weights every trunk kernel takes, for S rows of
    Fe embedding, dd distance and E3 ex3 columns; returns (w1, w3, w12,
    b12, w32, b32)."""
    w1e, w1p, w1d, b1, extra1, w3x, w3e, b3, extra3, wa, ba = _unpack(
        ops, L1, L3, not order1)
    if L1 not in (1, 2) or L3 not in (1, 2):
        raise ValueError(f"kernel supports 1-2 layers per block, got "
                         f"L1={L1} L3={L3}")
    H1, H3 = b1.shape[1], b3.shape[1]
    if K < 1 or 64 % K or S % K:
        raise ValueError(f"K={K} must divide the 64-row tile and S={S}")
    if max(H1, H3) > 256 or H1 % 4 or H3 % 4:
        raise ValueError(f"kernel widths are multiples of 4 up to 256, got "
                         f"{H1}, {H3}")
    f32 = torch.float32
    w1 = _joined(w1e, w1p, w1d)
    w3 = _joined(w3x, w3e)
    kernels.require(w1, "w1", f32, dev,
                    (Fe + 2 * nf * Fe + 2 * nd * dd, H1))
    kernels.require(b1, "b1", f32, dev, (1, H1))
    kernels.require(w3, "w3", f32, dev, (H1 + E3, H3))
    kernels.require(b3, "b3", f32, dev, (1, H3))
    w12 = b12 = w32 = b32 = None
    if L1 == 2:
        w12, b12 = extra1[0]
        kernels.require(w12, "w12", f32, dev, (H1, H1))
        kernels.require(b12, "b12", f32, dev, (1, H1))
    if L3 == 2:
        w32, b32 = extra3[0]
        kernels.require(w32, "w32", f32, dev, (H3, H3))
        kernels.require(b32, "b32", f32, dev, (1, H3))
    if not order1:
        kernels.require(wa, "wa", f32, dev, (H3, 1))
        kernels.require(ba, "ba", f32, dev, (1, 1))
    return w1, w3, w12, b12, w32, b32


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _fwd_workspace(C1, H1, E3, H3, L1, L3, dev, bf16=False) -> torch.Tensor:
    """The workspace K1 and K4 split their weights into (TF32 hi and lo
    planes, csrc/tf32_mma.cuh), or K1b converts them into (their bf16
    shared-memory images, csrc/bf16_wgmma.cuh)."""
    lib = kernels.library()
    size = lib.trunk_fwd_bf16_workspace if bf16 else lib.trunk_fwd_workspace
    n = size(C1, H1, E3, H3, L1, L3)
    return torch.empty((n,), dtype=torch.float32, device=dev)


def _launch(L1, L3, nf, nd, K, act_super, order1, emb, d, ex3, w, ops,
            bf16=False):
    S, Fe, dd, E3 = _trunk_rows(emb, d, ex3, w)
    w1, w3, w12, b12, w32, b32 = _weight_operands(
        L1, L3, nf, nd, K, order1, S, Fe, dd, E3, emb.device, ops)
    _, _, _, b1, _, _, _, b3, _, wa, ba = _unpack(ops, L1, L3, not order1)
    H1, H3 = b1.shape[1], b3.shape[1]
    if bf16 and max(w1.shape[0], H1 + E3) > FWD_BF16_MAX_WIDTH:
        raise ValueError(f"the bfloat16 forward takes layer inputs up to "
                         f"{FWD_BF16_MAX_WIDTH} wide, got {w1.shape[0]} and "
                         f"{H1 + E3}")
    feat = torch.empty((S // K, H3), dtype=torch.float32, device=emb.device)
    alpha = None if order1 else torch.empty((S // K, 1), dtype=torch.float32,
                                            device=emb.device)
    ws = _fwd_workspace(w1.shape[0], H1, E3, H3, L1, L3, emb.device, bf16)
    lib = kernels.library()
    kernel, launch = ((kernels.TRUNK_FWD_BF16, lib.trunk_fwd_bf16) if bf16
                      else (kernels.TRUNK_FWD, lib.trunk_fwd))
    err = launch(
        _ptr(emb), _ptr(d), _ptr(ex3), _ptr(w), _ptr(w1), _ptr(b1),
        _ptr(w12), _ptr(b12), _ptr(w3), _ptr(b3), _ptr(w32), _ptr(b32),
        _ptr(wa), _ptr(ba), _ptr(feat), _ptr(alpha), _ptr(ws), ws.numel(), S,
        Fe, dd, E3, nf, nd, H1, H3, L1, L3, K, int(bool(act_super)),
        int(bool(order1)), kernels.stream_handle(emb))
    kernels.check(err, kernel)
    kernel.launches += 1
    return feat, alpha


def _grad_layout(C1, H1, X3, H3, L1, L3, order1):
    """(name, shape) of each layer's gradient, in the order K2 writes them
    into its one flat dW buffer."""
    out = [("w1", (C1, H1)), ("b1", (1, H1))]
    if L1 == 2:
        out += [("w12", (H1, H1)), ("b12", (1, H1))]
    out += [("w3", (X3, H3)), ("b3", (1, H3))]
    if L3 == 2:
        out += [("w32", (H3, H3)), ("b32", (1, H3))]
    if not order1:
        out += [("wa", (H3, 1)), ("ba", (1, 1))]
    return out


class _BwdOperands(NamedTuple):
    """What K2, K2b and K5 take beside their row inputs: the weights, the
    workspace (the weights' TF32 planes or bf16 shared-memory images, the
    scratch between the kernels' two phases, their partial sums; sized by
    the library) and the flat dW they sum into."""
    weights: tuple    # w1, b1, w12, b12, w3, b3, w32, b32, wa, ba
                      # (None where absent)
    ws: torch.Tensor
    dW: torch.Tensor
    dims: tuple       # (H1, H3)


def _bwd_operands(L1, L3, nf, nd, K, order1, S, Fe, dd, E3, dev, ops,
                  dfeat, dalpha, bf16=False) -> _BwdOperands:
    w1, w3, w12, b12, w32, b32 = _weight_operands(
        L1, L3, nf, nd, K, order1, S, Fe, dd, E3, dev, ops)
    _, _, _, b1, _, _, _, b3, _, wa, ba = _unpack(ops, L1, L3, not order1)
    H1, H3 = b1.shape[1], b3.shape[1]
    C1, X3 = w1.shape[0], w3.shape[0]
    f32 = torch.float32
    kernels.require(dfeat, "dfeat", f32, dev, (S // K, H3))
    if not order1:
        kernels.require(dalpha, "dalpha", f32, dev, (S // K, 1))
    if max(-(-C1 // 8), -(-X3 // 8)) * 8 > BWD_MAX_WIDTH:
        raise ValueError(f"the backward kernels take first-layer widths up "
                         f"to {BWD_MAX_WIDTH}, got {C1} and {X3}")
    n_w = sum(a * b for _, (a, b) in
              _grad_layout(C1, H1, X3, H3, L1, L3, order1))
    lib = kernels.library()
    size = lib.trunk_bwd_bf16_workspace if bf16 else lib.trunk_bwd_workspace
    n_ws = size(S, Fe, dd, E3, nf, nd, H1, H3, L1, L3, int(bool(order1)))
    weights = (w1, b1, w12, b12, w3, b3, w32, b32, wa, ba)
    # every dW entry is written by the kernels' sums when S > 0
    dW = (torch.empty if S > 0 else torch.zeros)((n_w,), dtype=f32,
                                                 device=dev)
    return _BwdOperands(weights, torch.empty((n_ws,), dtype=f32, device=dev),
                        dW, (H1, H3))


def _split_dW(dW, L1, L3, Fe, nf, C1, H1, X3, H3, order1):
    """The flat dW a backward kernel wrote, as one gradient per trunk op
    (pack_trunk_params order)."""
    grads, off = {}, 0
    for name, (a, b) in _grad_layout(C1, H1, X3, H3, L1, L3, order1):
        grads[name] = dW[off:off + a * b].view(a, b)
        off += a * b
    pe_e = 2 * nf * Fe
    dops = [grads["w1"][:Fe], grads["w1"][Fe:Fe + pe_e],
            grads["w1"][Fe + pe_e:], grads["b1"]]
    if L1 == 2:
        dops += [grads["w12"], grads["b12"]]
    dops += [grads["w3"][:H1], grads["w3"][H1:], grads["b3"]]
    if L3 == 2:
        dops += [grads["w32"], grads["b32"]]
    if not order1:
        dops += [grads["wa"], grads["ba"]]
    return dops


def _launch_bwd(L1, L3, nf, nd, K, act_super, order1, emb, d, ex3, w, ops,
                dfeat, dalpha, bf16=False):
    S, Fe, dd, E3 = _trunk_rows(emb, d, ex3, w)
    b = _bwd_operands(L1, L3, nf, nd, K, order1, S, Fe, dd, E3, emb.device,
                      ops, dfeat, dalpha, bf16)
    demb, ddist = torch.empty_like(emb), torch.empty_like(d)
    dex3, dw = torch.empty_like(ex3), torch.empty_like(w)
    if S > 0:
        lib = kernels.library()
        kernel, launch = ((kernels.TRUNK_BWD_BF16, lib.trunk_bwd_bf16)
                          if bf16 else (kernels.TRUNK_BWD, lib.trunk_bwd))
        err = launch(
            _ptr(emb), _ptr(d), _ptr(ex3), _ptr(w), _ptr(dfeat),
            _ptr(dalpha), *map(_ptr, b.weights), _ptr(demb), _ptr(ddist),
            _ptr(dex3), _ptr(dw), _ptr(b.ws), b.ws.numel(), _ptr(b.dW), S,
            Fe, dd, E3, nf, nd, *b.dims, L1, L3, K, int(bool(act_super)),
            int(bool(order1)), kernels.stream_handle(emb))
        kernels.check(err, kernel)
        kernel.launches += 1
    H1, H3 = b.dims
    C1 = Fe + 2 * nf * Fe + 2 * nd * dd
    dops = _split_dW(b.dW, L1, L3, Fe, nf, C1, H1, H1 + E3, H3, order1)
    return demb, ddist, dex3, dw, dops


def _shade_rows(K, dist_mode, emb, xyz, xyzp, color, pdir, conf, mask, sl,
                slw, ovd, RT):
    """Validate the row inputs K4 and K5 take; returns (S, Fe, dd)."""
    if dist_mode not in DIST_COLS:
        raise ValueError(f"fused_shade takes dist modes {sorted(DIST_COLS)},"
                         f" not {dist_mode}")
    S, Fe = emb.shape
    dev, f32 = emb.device, torch.float32
    kernels.require(emb, "emb", f32, dev, (S, Fe))
    for t, name, cols in ((xyz, "xyz", 3), (xyzp, "xyzp", 3),
                          (color, "color", 3), (pdir, "pdir", 3),
                          (conf, "conf", 1), (mask, "mask", 1)):
        kernels.require(t, name, f32, dev, (S, cols))
    if K < 1 or S % K:
        raise ValueError(f"K={K} must divide S={S}")
    for t, name in ((sl, "sl"), (slw, "slw"), (ovd, "ovd")):
        kernels.require(t, name, f32, dev, (S // K, 3))
    kernels.require(RT, "RT", f32, dev, (3, 3))
    return S, Fe, DIST_COLS[dist_mode]


def _launch_shade(L1, L3, nf, nd, K, act_super, order1, dist_mode, emb, xyz,
                  xyzp, color, pdir, conf, mask, sl, slw, ovd, RT, ops):
    rows = (emb, xyz, xyzp, color, pdir, conf, mask, sl, slw, ovd, RT)
    S, Fe, dd = _shade_rows(K, dist_mode, *rows)
    w1, w3, w12, b12, w32, b32 = _weight_operands(
        L1, L3, nf, nd, K, order1, S, Fe, dd, SHADE_E3, emb.device, ops)
    _, _, _, b1, _, _, _, b3, _, wa, ba = _unpack(ops, L1, L3, not order1)
    H1, H3 = b1.shape[1], b3.shape[1]
    new = lambda rows_, cols: torch.empty((rows_, cols), dtype=torch.float32,
                                          device=emb.device)
    feat = new(S // K, H3)
    alpha = None if order1 else new(S // K, 1)
    w_n, conf_c = new(S, 1), new(S, 1)
    ws = _fwd_workspace(w1.shape[0], H1, SHADE_E3, H3, L1, L3, emb.device)
    err = kernels.library().shade_fwd(
        *(_ptr(t) for t in rows), _ptr(w1), _ptr(b1), _ptr(w12), _ptr(b12),
        _ptr(w3), _ptr(b3), _ptr(w32), _ptr(b32), _ptr(wa), _ptr(ba),
        _ptr(feat), _ptr(alpha), _ptr(w_n), _ptr(conf_c), _ptr(ws),
        ws.numel(), S, Fe, dist_mode, nf, nd, H1, H3, L1, L3, K,
        int(bool(act_super)), int(bool(order1)), kernels.stream_handle(emb))
    kernels.check(err, kernels.SHADE_FWD)
    kernels.SHADE_FWD.launches += 1
    return feat, alpha, w_n, conf_c


def _launch_shade_bwd(L1, L3, nf, nd, K, act_super, order1, dist_mode, emb,
                      xyz, xyzp, color, pdir, conf, mask, sl, slw, ovd, RT,
                      ops, dfeat, dalpha, dwout, dconfout):
    rows = (emb, xyz, xyzp, color, pdir, conf, mask, sl, slw, ovd, RT)
    S, Fe, dd = _shade_rows(K, dist_mode, *rows)
    if BWD_TILE % K:
        raise ValueError(f"K={K} must divide K5's {BWD_TILE}-row tile: its "
                         "group sums stay inside a tile")
    dev = emb.device
    for t, name in ((dwout, "dwout"), (dconfout, "dconfout")):
        kernels.require(t, name, torch.float32, dev, (S, 1))
    b = _bwd_operands(L1, L3, nf, nd, K, order1, S, Fe, dd, SHADE_E3, dev,
                      ops, dfeat, dalpha)
    outs = [torch.empty_like(t) for t in (emb, xyz, xyzp, color, pdir, conf)]
    if S > 0:
        err = kernels.library().shade_bwd(
            *(_ptr(t) for t in rows), _ptr(dfeat), _ptr(dalpha),
            _ptr(dwout), _ptr(dconfout), *map(_ptr, b.weights),
            *(_ptr(t) for t in outs), _ptr(b.ws), b.ws.numel(), _ptr(b.dW),
            S, Fe, dist_mode, nf, nd, *b.dims, L1, L3, K,
            int(bool(act_super)), int(bool(order1)),
            kernels.stream_handle(emb))
        kernels.check(err, kernels.SHADE_BWD)
        kernels.SHADE_BWD.launches += 1
    H1, H3 = b.dims
    C1 = Fe + 2 * nf * Fe + 2 * nd * dd
    dops = _split_dW(b.dW, L1, L3, Fe, nf, C1, H1, H1 + SHADE_E3, H3, order1)
    return (*outs, dops)


def fused_trunk_ok(opt) -> bool:
    """Config envelope the kernels support (the lego/nerf-synth family)."""
    return (opt.act_type == "LeakyReLU"
            and opt.shading_feature_mlp_layer1 in (1, 2)
            and opt.shading_feature_mlp_layer2 == 0
            and opt.shading_feature_mlp_layer3 in (1, 2)
            and opt.shading_alpha_mlp_layer == 1
            and opt.agg_intrp_order in (1, 2)
            and opt.agg_feat_xyz_mode == "None"
            and opt.agg_alpha_xyz_mode == "None"
            and opt.num_feat_freqs > 0
            and abs(opt.dist_xyz_freq) > 0
            and "1" in list(opt.point_color_mode)
            and "1" in list(opt.point_dir_mode)
            and opt.agg_distance_kernel not in ("feat_intrp", "meta_intrp",
                                                "sh_intrp", "gau_intrp"))


def fused_shade_ok(opt) -> bool:
    """Envelope of the shade kernels (JAX `fused_shade_ok`): fused_trunk_ok
    plus the linear distance kernel with unit axis weights, weight
    normalization on, dist mode 0 or 20, no distance scaling and the conf
    channel on: the nerf_synth, scannet, tt, dtu_ft and dtu_inf presets."""
    from ..models.aggregator import unit_axis_weight
    return (fused_trunk_ok(opt)
            and opt.agg_distance_kernel == "linear"
            and unit_axis_weight(opt)
            and opt.agg_weight_norm > 0
            and opt.agg_dist_pers in DIST_COLS
            and float(opt.dist_xyz_deno) == 0.0
            and "1" in list(opt.point_conf_mode))
