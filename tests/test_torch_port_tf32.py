"""The numerics of the trunk kernels' tensor-core products, emulated on the
CPU: one TF32 pass against the 3xTF32 split the kernels use
(csrc/tf32_mma.cuh).

TF32 keeps 10 mantissa bits; `cvt.rna.tf32.f32` rounds to nearest with
ties away from zero, which `tf32_round` reproduces on the bit pattern. A
product of two TF32 values is exact in fp32, so `a_tf32 @ b_tf32` on fp32
tensors is what one tensor-core pass computes up to the summation order;
the split computes a_lo·b_hi + a_hi·b_lo + a_hi·b_hi. At lego widths, on the
inputs chip_smoke.py gives K1 (seeded with numpy), one pass misses the
rtol = atol = 1e-4 that K1 is held to against its plain fp32 version, and
the split stays within it; the same holds for K2's weight gradients, a sum
over thousands of rows held within 1e-4 of their largest entry.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pointnerf_tpu_torch.models.aggregator import init_aggregator_params
from pointnerf_tpu_torch.ops import trunk as tt
from pointnerf_tpu_torch.ops.pe import pe_args
from pointnerf_tpu_torch.run.workload import lego_options

K1_TOL = dict(rtol=1e-4, atol=1e-4)   # chip_smoke.py's K1_TOL
SUM_REL = 1e-4                        # chip_smoke.py's K2_SUM_REL


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero, as cvt.rna.tf32.f32: add half of the 13 dropped bits to the
    magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm_tf32(a, b):
    return tf32_round(a) @ tf32_round(b)


def mm_3xtf32(a, b):
    ah, bh = tf32_round(a), tf32_round(b)
    al, bl = tf32_round(a - ah), tf32_round(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def trunk_forward(mm, L1, L3, nf, nd, K, act_super, emb, d, ex3, w, ops):
    """K1's function with its layer products taken by `mm` (bias,
    LeakyReLU, the alpha head and the K-sum in fp32, as in the kernel)."""
    w1e, w1p, w1d, b1, extra1, w3x, w3e, b3, extra3, wa, ba = tt._unpack(
        ops, L1, L3, True)
    leaky = lambda z: F.leaky_relu(z, tt.NEG_SLOPE)
    x0 = torch.cat([emb, torch.sin(pe_args(emb, nf)),
                    torch.sin(pe_args(d, nd))], dim=1)
    h = leaky(mm(x0, torch.cat([w1e, w1p, w1d])) + b1)
    for wl, bl in extra1:
        h = leaky(mm(h, wl) + bl)
    g = leaky(mm(torch.cat([h, ex3], dim=1), torch.cat([w3x, w3e])) + b3)
    for wl, bl in extra3:
        g = leaky(mm(g, wl) + bl)
    S = emb.shape[0]
    ksum = lambda x: x.reshape(S // K, K, -1).sum(dim=1)
    za = g @ wa + ba
    a = F.softplus(za - 1.0) if act_super else torch.relu(za)
    return ksum(g * w), ksum(a * w), x0


def _lego_case(K=8, n_pts=512, seed=0):
    """Lego-width trunk operands (seeded random weights) and rows shaped as
    chip_smoke.py's K1 check makes them."""
    opt = lego_options()
    agg = init_aggregator_params(opt, torch.Generator().manual_seed(seed),
                                 device="cpu")
    nf, nd = opt.num_feat_freqs, abs(opt.dist_xyz_freq)
    Fe = opt.point_features_dim
    rng = np.random.RandomState(seed)
    S = n_pts * K
    rows = [rng.uniform(-0.5, 0.5, (S, Fe)), 0.02 * rng.normal(size=(S, 6)),
            rng.uniform(-1, 1, (S, 7)),
            rng.uniform(0, 1, (S, 1)) * (rng.rand(S, 1) < 0.3)]
    rows = [torch.as_tensor(r.astype(np.float32)) for r in rows]
    ops = [o.detach() for o in tt.pack_trunk_params(agg, Fe, 6, nf, nd)]
    cfg = (opt.shading_feature_mlp_layer1, opt.shading_feature_mlp_layer3,
           nf, nd, K, opt.act_super > 0)
    return cfg, rows, ops


def _excess(got, want, rtol, atol):
    """max(|got − want| − atol − rtol·|want|): > 0 where allclose fails."""
    return float(((got - want).abs() - atol - rtol * want.abs()).max())


def test_tf32_round_is_round_to_nearest_ties_away():
    one = 1.0
    half_ulp = 2.0 ** -11                 # half of TF32's ulp at 1
    x = torch.tensor([one + half_ulp, -(one + half_ulp),
                      one + half_ulp - 2.0 ** -23, 3.0, 0.0, -0.0],
                     dtype=torch.float32)
    want = torch.tensor([one + 2.0 ** -10, -(one + 2.0 ** -10), one, 3.0,
                         0.0, -0.0], dtype=torch.float32)
    assert torch.equal(tf32_round(x), want)
    v = torch.as_tensor(np.random.RandomState(1).normal(
        size=100_000).astype(np.float32))
    hi = tf32_round(v)
    lo = tf32_round(v - hi)
    for part in (hi, lo):
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    assert float(((hi - v) / v).abs().max()) <= 2.0 ** -11
    assert float(((hi + lo - v) / v).abs().max()) <= 2.0 ** -21


@pytest.mark.parametrize("K", [1, 8])
def test_k1_needs_the_3xtf32_split(K):
    """At lego widths one TF32 pass misses K1_TOL against the fp32 plain
    version; the 3xTF32 split holds it with a margin of 10x."""
    (L1, L3, nf, nd, K, act), rows, ops = _lego_case(K, n_pts=4096 // K)
    want = tt.fused_trunk_reference(L1, L3, nf, nd, K, act, False, *rows,
                                    ops)
    plain = trunk_forward(torch.matmul, L1, L3, nf, nd, K, act, *rows, ops)
    one = trunk_forward(mm_tf32, L1, L3, nf, nd, K, act, *rows, ops)
    split = trunk_forward(mm_3xtf32, L1, L3, nf, nd, K, act, *rows, ops)
    tenth = {k: v / 10 for k, v in K1_TOL.items()}
    for i in range(2):
        # the emulation's fp32 products equal the plain version's up to
        # summation order (it multiplies x0 whole, the plain version piece
        # by piece)
        torch.testing.assert_close(plain[i], want[i], **tenth)
        torch.testing.assert_close(split[i], want[i], **tenth)
    assert max(_excess(one[i], want[i], **K1_TOL) for i in range(2)) > 0


def test_k2_weight_gradient_needs_the_3xtf32_split():
    """K2's first-layer weight gradient x0ᵀ·dz over 8,192 rows: one TF32
    pass misses SUM_REL of the largest entry, the split holds it."""
    (L1, L3, nf, nd, K, act), rows, ops = _lego_case(8, n_pts=1024, seed=2)
    x0 = trunk_forward(torch.matmul, L1, L3, nf, nd, K, act, *rows, ops)[2]
    rng = np.random.RandomState(3)
    dz = torch.as_tensor(rng.normal(size=(x0.shape[0], 256)).astype(
        np.float32)) * (torch.as_tensor(rng.rand(x0.shape[0], 1)) < 0.3)
    want = (x0.double().t() @ dz.double()).float()
    top = float(want.abs().max())
    rel = lambda got: float((got - want).abs().max()) / top
    assert rel(x0.t() @ dz) <= SUM_REL / 10
    assert rel(mm_tf32(x0.t(), dz)) > SUM_REL
    assert rel(mm_3xtf32(x0.t(), dz)) <= SUM_REL / 10
