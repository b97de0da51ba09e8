"""Fused per-neighbor shading trunk, forward (port of `ops/pallas_trunk.py`).

Per (shading point, neighbor) row:

    x1 = [emb, PE(emb), PE(dists)]
    h  = block1(x1)                 (1-2 LeakyReLU Linear layers)
    g  = block3([h, ex3])           (1-2 LeakyReLU Linear layers)
    a  = raw2out_density(alpha_branch(g))

then the weighted sum over each shading point's K contiguous neighbor rows.
`fused_trunk` launches the CUDA kernel `csrc/trunk_fwd.cu` on CUDA tensors
and runs `fused_trunk_reference`, the plain PyTorch composition of the same
math, on CPU tensors. The backward kernel is not ported yet: inputs that
require grad are refused rather than differentiated through the plain
version.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import kernels
from .pe import positional_encoding

NEG_SLOPE = 0.1


def pack_trunk_params(agg, F_emb: int, dd: int, n_feat_freqs: int,
                      n_dist_freqs: int, with_alpha: bool = True
                      ) -> List[torch.Tensor]:
    """Flatten block1/block3[/alpha_branch] into the kernel's operand list,
    in the JAX layout: weights [in, out] contiguous, biases [1, out]. The
    block1 first layer splits by piece [emb | PE(emb) | PE(dists)], block3's
    by [h | ex3]; the pieces are row views of one transposed weight, which
    the kernel reads whole. with_alpha=False (order 1): the alpha head runs
    outside."""
    from ..models.networks import linears
    b1, b3 = linears(agg.block1), linears(agg.block3)
    pe_e = 2 * n_feat_freqs * F_emb
    pe_d = 2 * n_dist_freqs * dd
    wT = lambda lin: lin.weight.detach().t().contiguous()
    bias = lambda lin: lin.bias.detach().reshape(1, -1)
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


def _alpha_act(za: torch.Tensor, act_super: bool) -> torch.Tensor:
    """raw2out_density: softplus(x-1) (mip-NeRF stabilisation) or relu."""
    return F.softplus(za - 1.0) if act_super else torch.relu(za)


def fused_trunk_reference(L1: int, L3: int, n_feat_freqs: int,
                          n_dist_freqs: int, K: int, act_super: bool,
                          order1: bool, emb, d, ex3, w, ops
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of `fused_trunk` (same arguments, same outputs)."""
    w1e, w1p, w1d, b1, extra1, w3x, w3e, b3, extra3, wa, ba = _unpack(
        ops, L1, L3, not order1)
    leaky = lambda x: F.leaky_relu(x, NEG_SLOPE)
    pe_e = positional_encoding(emb, n_feat_freqs)
    pe_d = positional_encoding(d, n_dist_freqs)
    h = leaky(emb @ w1e + pe_e @ w1p + pe_d @ w1d + b1)
    for wl, bl in extra1:
        h = leaky(h @ wl + bl)
    g = leaky(h @ w3x + ex3 @ w3e + b3)
    for wl, bl in extra3:
        g = leaky(g @ wl + bl)
    S = emb.shape[0]

    def group_sum(x):
        return torch.sum(x.reshape(S // K, K, x.shape[1]), dim=1)

    feat = group_sum(g * w)
    if order1:
        return feat, None
    return feat, group_sum(_alpha_act(g @ wa + ba, act_super) * w)


def fused_trunk(L1: int, L3: int, n_feat_freqs: int, n_dist_freqs: int,
                K: int, act_super: bool, order1: bool,
                emb: torch.Tensor, d: torch.Tensor, ex3: torch.Tensor,
                w: torch.Tensor, ops: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """emb/d/ex3 [S,*] per-NEIGHBOR rows (the K neighbors of each shading
    point contiguous), w [S,1] effective neighbor weights, ops from
    pack_trunk_params. Returns per-SHADING-POINT (feat_pt [S/K,H],
    alpha_pt [S/K,1]); order1 returns (feat_pt, None).

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    if any(t.requires_grad for t in (emb, d, ex3, w, *ops)):
        raise RuntimeError("fused_trunk has no backward yet: call it under "
                           "torch.inference_mode() or torch.no_grad()")
    if emb.device.type == "cpu":
        return fused_trunk_reference(L1, L3, n_feat_freqs, n_dist_freqs, K,
                                     act_super, order1, emb, d, ex3, w, ops)
    if emb.device.type != "cuda":
        raise ValueError(f"fused_trunk runs on cpu or cuda, not {emb.device}")
    return _launch(L1, L3, n_feat_freqs, n_dist_freqs, K, act_super, order1,
                   emb, d, ex3, w, ops)


def _joined(*pieces: torch.Tensor) -> torch.Tensor:
    """The [Σrows, H] matrix whose consecutive row blocks are `pieces`,
    without a copy. pack_trunk_params cuts a first layer's input pieces
    from one contiguous transposed weight, so the kernel reads that weight
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


def _launch(L1, L3, nf, nd, K, act_super, order1, emb, d, ex3, w, ops):
    w1e, w1p, w1d, b1, extra1, w3x, w3e, b3, extra3, wa, ba = _unpack(
        ops, L1, L3, not order1)
    if L1 not in (1, 2) or L3 not in (1, 2):
        raise ValueError(f"kernel supports 1-2 layers per block, got "
                         f"L1={L1} L3={L3}")
    S, Fe = emb.shape
    dd, E3 = d.shape[1], ex3.shape[1]
    H1, H3 = b1.shape[1], b3.shape[1]
    if K < 1 or 64 % K or S % K:
        raise ValueError(f"K={K} must divide the 64-row tile and S={S}")
    if max(H1, H3) > 256 or H1 % 4 or H3 % 4:
        raise ValueError(f"kernel widths are multiples of 4 up to 256, got "
                         f"{H1}, {H3}")
    dev = emb.device
    f32 = torch.float32
    w1 = _joined(w1e, w1p, w1d)
    w3 = _joined(w3x, w3e)
    kernels.require(emb, "emb", f32, dev, (S, Fe))
    kernels.require(d, "d", f32, dev, (S, dd))
    kernels.require(ex3, "ex3", f32, dev, (S, E3))
    kernels.require(w, "w", f32, dev, (S, 1))
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
    feat = torch.empty((S // K, H3), dtype=f32, device=dev)
    alpha = None if order1 else torch.empty((S // K, 1), dtype=f32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = kernels.library()
    err = lib.trunk_fwd(
        ptr(emb), ptr(d), ptr(ex3), ptr(w), ptr(w1), ptr(b1), ptr(w12),
        ptr(b12), ptr(w3), ptr(b3), ptr(w32), ptr(b32), ptr(wa), ptr(ba),
        ptr(feat), ptr(alpha), S, Fe, dd, E3, nf, nd, H1, H3, L1, L3, K,
        int(bool(act_super)), int(bool(order1)), kernels.stream_handle(emb))
    kernels.check(err, kernels.TRUNK_FWD)
    kernels.TRUNK_FWD.launches += 1
    return feat, alpha


def fused_trunk_ok(opt) -> bool:
    """Config envelope the kernel supports (the lego/nerf-synth family)."""
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
