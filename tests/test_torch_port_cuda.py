"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: without a CUDA device every test skips (the kernels have no
CPU mode). Run on a GPU machine, where JAX may be absent, with

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

K6 (the row scatter-add) is held at rtol = atol = 1e-4, and each entry
within 1e-4 of the sum of |updates| reaching it: its float atomics sum
duplicates in no fixed order. K7 (the row select) must equal its plain
version. The driver tests train a few lego-width steps on a small plate
scene written by `run/workload.make_plate_scene` (no JAX, no imageio on a
GPU machine).

Tolerances: the trunk's and the shade kernels' outputs and per-row
cotangents rtol = atol = 1e-4 (fp32, another summation order over four
layers); weight gradients, which sum every row, within 1e-4 of their
largest entry; masks equal. Rows
whose LeakyReLU input lies within KINK of 0 get neighbor weight 0 in the
backward checks: the derivative jumps there, and the two summation orders
may take different slopes. Card against CPU: losses rtol 1e-4, gradients
within GRAD_REL in norm.
"""

import copy
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pointnerf_tpu_torch.config import Options
from pointnerf_tpu_torch.models import neural_points as npc
from pointnerf_tpu_torch.models.aggregator import init_aggregator_params
from pointnerf_tpu_torch.ops import grid as tgrid
from pointnerf_tpu_torch.ops import kernels
from pointnerf_tpu_torch.ops import query as tq
from pointnerf_tpu_torch.ops import raygen
from pointnerf_tpu_torch.ops import trunk as tt
from pointnerf_tpu_torch.ops.scatter import (scatter_add_rows,
                                             scatter_add_rows_reference)
from pointnerf_tpu_torch.train import trainer

pytestmark = pytest.mark.cuda
TOL = dict(rtol=1e-4, atol=1e-4)
SUM_REL = 1e-4
KINK = 1e-5
GRAD_REL = 1e-3
TRUNK_GRID = [(K, L1, L3, order, True) for K in (1, 8)
              for L1, L3 in ((1, 1), (2, 2), (1, 2))
              for order in (1, 2)] + [(8, 2, 2, 2, False)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _opt(L1=2, L3=2, order=2, **kw):
    return Options(**{**dict(
        point_features_dim=8, num_feat_freqs=2, dist_xyz_freq=3,
        num_viewdir_freqs=2, shading_feature_num=32,
        shading_feature_mlp_layer1=L1, shading_feature_mlp_layer3=L3,
        shading_alpha_mlp_layer=1, shading_color_mlp_layer=2,
        agg_intrp_order=order, agg_dist_pers=20), **kw})


@pytest.mark.parametrize("K,L1,L3,order,act_super", TRUNK_GRID)
def test_trunk_kernel_matches_plain(dev, K, L1, L3, order, act_super):
    opt = _opt(L1, L3, order)
    agg = init_aggregator_params(opt, torch.Generator().manual_seed(K),
                                 device=dev)
    g = torch.Generator().manual_seed(L1 + 2 * L3)
    S = 37 * K                                  # ragged against the tile
    args = [(torch.rand(S, 8, generator=g) - 0.5).to(dev),
            (0.05 * torch.randn(S, 6, generator=g)).to(dev),
            (2 * torch.rand(S, 7, generator=g) - 1).to(dev),
            torch.rand(S, 1, generator=g).to(dev)]
    ops = tt.pack_trunk_params(agg, 8, 6, 2, 3, with_alpha=order == 2)
    before = kernels.TRUNK_FWD.launches
    with torch.inference_mode():
        got = tt.fused_trunk(L1, L3, 2, 3, K, act_super, order == 1, *args,
                             ops)
        want = tt.fused_trunk_reference(L1, L3, 2, 3, K, act_super,
                                        order == 1, *args, ops)
    torch.cuda.synchronize()
    assert kernels.TRUNK_FWD.launches == before + 1
    torch.testing.assert_close(got[0], want[0], **TOL)
    if order == 2:
        torch.testing.assert_close(got[1], want[1], **TOL)
    else:
        assert got[1] is None


def _bwd_args(dev, K, L1, L3, order, act_super):
    """K2's arguments at small widths: seeded rows and cotangents, and rows
    near a LeakyReLU kink weighted 0."""
    opt = _opt(L1, L3, order)
    agg = init_aggregator_params(opt, torch.Generator().manual_seed(K),
                                 device=dev)
    g = torch.Generator().manual_seed(L1 + 2 * L3)
    S = 37 * K                                  # ragged against the tile
    emb = (torch.rand(S, 8, generator=g) - 0.5).to(dev)
    d = (0.05 * torch.randn(S, 6, generator=g)).to(dev)
    ex3 = (2 * torch.rand(S, 7, generator=g) - 1).to(dev)
    w = torch.rand(S, 1, generator=g).to(dev)
    dfeat = torch.randn(S // K, 32, generator=g).to(dev)
    dalpha = None if order == 1 else torch.randn(S // K, 1,
                                                 generator=g).to(dev)
    ops = [o.detach() for o in tt.pack_trunk_params(agg, 8, 6, 2, 3,
                                                    with_alpha=order == 2)]
    zs = tt.trunk_activations(L1, L3, 2, 3, emb, d, ex3, ops, order == 2)
    for z in zs[2] + zs[4]:
        w = w * (z.abs() >= KINK).all(dim=1, keepdim=True)
    return (L1, L3, 2, 3, K, act_super, order == 1, emb, d, ex3, w, ops,
            dfeat, dalpha)


@pytest.mark.parametrize("K,L1,L3,order,act_super", TRUNK_GRID)
def test_trunk_bwd_kernel_matches_plain(dev, K, L1, L3, order, act_super):
    args = _bwd_args(dev, K, L1, L3, order, act_super)
    before = kernels.TRUNK_BWD.launches
    got = tt.trunk_bwd(*args)
    want = tt.fused_trunk_bwd_reference(*args)
    torch.cuda.synchronize()
    assert kernels.TRUNK_BWD.launches == before + 1
    for a, b in zip(got[:4], want[:4]):
        torch.testing.assert_close(a, b, **TOL)
    assert len(got[4]) == len(want[4])
    for a, b in zip(got[4], want[4]):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= SUM_REL * float(b.abs().max())


DIST_WIDTHS = {3: 1, 4: 30, 6: 20}     # dd → an agg_dist_pers giving it


@pytest.mark.parametrize("K", [1, 8])
@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("dd", sorted(DIST_WIDTHS))
def test_trunk_kernels_at_distance_widths(dev, dd, order, K):
    """K1 and K2 at the distance widths of every mode (3: -1/1/2, 4: 30,
    6: 10/20), with dist_xyz_freq 5 (nd 5, lego's): C1 = 8 + 2·2·8 +
    2·5·dd, against their plain versions."""
    opt = _opt(order=order, dist_xyz_freq=5, agg_dist_pers=DIST_WIDTHS[dd])
    agg = init_aggregator_params(opt, torch.Generator().manual_seed(dd),
                                 device=dev)
    g = torch.Generator().manual_seed(10 * dd + K)
    S = 37 * K
    emb = (torch.rand(S, 8, generator=g) - 0.5).to(dev)
    d = (0.05 * torch.randn(S, dd, generator=g)).to(dev)
    ex3 = (2 * torch.rand(S, 7, generator=g) - 1).to(dev)
    w = torch.rand(S, 1, generator=g).to(dev)
    ops = [o.detach() for o in tt.pack_trunk_params(agg, 8, dd, 2, 5,
                                                    with_alpha=order == 2)]
    o1 = order == 1
    before = (kernels.TRUNK_FWD.launches, kernels.TRUNK_BWD.launches)
    with torch.inference_mode():
        got = tt.fused_trunk(2, 2, 2, 5, K, True, o1, emb, d, ex3, w, ops)
        want = tt.fused_trunk_reference(2, 2, 2, 5, K, True, o1, emb, d,
                                        ex3, w, ops)
    for a, b in zip(got, want):
        if b is not None:
            torch.testing.assert_close(a, b, **TOL)
    zs = tt.trunk_activations(2, 2, 2, 5, emb, d, ex3, ops, not o1)
    for z in zs[2] + zs[4]:
        w = w * (z.abs() >= KINK).all(dim=1, keepdim=True)
    dfeat = torch.randn(S // K, 32, generator=g).to(dev)
    dalpha = None if o1 else torch.randn(S // K, 1, generator=g).to(dev)
    args = (2, 2, 2, 5, K, True, o1, emb, d, ex3, w, ops, dfeat, dalpha)
    got = tt.trunk_bwd(*args)
    want = tt.fused_trunk_bwd_reference(*args)
    torch.cuda.synchronize()
    assert (kernels.TRUNK_FWD.launches, kernels.TRUNK_BWD.launches) \
        == (before[0] + 1, before[1] + 1)
    assert got[1].shape == (S, dd)
    for a, b in zip(got[:4], want[:4]):
        torch.testing.assert_close(a, b, **TOL)
    for a, b in zip(got[4], want[4]):
        assert float((a - b).abs().max()) <= SUM_REL * float(b.abs().max())


def test_trunk_bwd_weight_grads_are_reproducible(dev):
    """No float atomics: two launches give bit-equal weight gradients."""
    args = _bwd_args(dev, 8, 2, 2, 2, True)
    first, second = tt.trunk_bwd(*args), tt.trunk_bwd(*args)
    for a, b in zip(first[4], second[4]):
        assert torch.equal(a, b)


# the tile kernels' edges: S below one tile (32 rows in K2, 64 in K1) and
# ragged, K = 4, widths that are not multiples of 8 (H 36 and 252; C1 = 76
# and X3 = H + 7 at these widths), and enough rows that K2's weight-gradient
# phase splits them (8,008 rows: 8 splits)
EDGES = {"short": (8, 3, 2, 2, 2, 32), "one-row": (1, 1, 1, 1, 1, 32),
         "h36": (4, 50, 2, 2, 2, 36), "h36-l1-order1": (4, 50, 1, 2, 1, 36),
         "k4": (4, 37, 2, 1, 2, 32), "h252": (8, 40, 2, 2, 2, 252),
         "splits": (8, 1001, 2, 2, 2, 32)}


@pytest.mark.parametrize("case", sorted(EDGES))
def test_trunk_kernels_at_the_tiles_edges(dev, case):
    """K1 and K2 against their plain versions at the edges of their tiles
    and products; K2's weight gradients bit-equal over two launches."""
    K, n_pts, L1, L3, order, H = EDGES[case]
    opt = _opt(L1, L3, order, shading_feature_num=H)
    agg = init_aggregator_params(opt, torch.Generator().manual_seed(n_pts),
                                 device=dev)
    rng = np.random.RandomState(n_pts)
    S = n_pts * K
    rows = [rng.uniform(-0.5, 0.5, (S, 8)), 0.05 * rng.normal(size=(S, 6)),
            rng.uniform(-1, 1, (S, 7)), rng.uniform(0, 1, (S, 1)),
            rng.normal(size=(S // K, H)), rng.normal(size=(S // K, 1))]
    emb, d, ex3, w, dfeat, dalpha = [
        torch.as_tensor(r.astype(np.float32), device=dev) for r in rows]
    ops = [o.detach() for o in tt.pack_trunk_params(agg, 8, 6, 2, 3,
                                                    with_alpha=order == 2)]
    zs = tt.trunk_activations(L1, L3, 2, 3, emb, d, ex3, ops, order == 2)
    for z in zs[2] + zs[4]:
        w = w * (z.abs() >= KINK).all(dim=1, keepdim=True)
    fwd = (L1, L3, 2, 3, K, True, order == 1, emb, d, ex3, w, ops)
    with torch.inference_mode():
        got, want = tt.fused_trunk(*fwd), tt.fused_trunk_reference(*fwd)
    bwd = (*fwd, dfeat, None if order == 1 else dalpha)
    gb, again = tt.trunk_bwd(*bwd), tt.trunk_bwd(*bwd)
    wb = tt.fused_trunk_bwd_reference(*bwd)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        else:
            torch.testing.assert_close(a, b, **TOL)
    for a, b in zip(gb[:4], wb[:4]):
        torch.testing.assert_close(a, b, **TOL)
    for a, b, c in zip(gb[4], wb[4], again[4]):
        assert a.shape == b.shape and torch.equal(a, c)
        assert float((a - b).abs().max()) <= SUM_REL * float(b.abs().max())


def test_shade_bwd_weight_grads_are_reproducible_over_splits(dev):
    """K5 on 8,008 rows (its weight-gradient phase splits them 8 ways):
    two launches give bit-equal weight gradients."""
    cfg, args, ops = _shade_args(dev, 8, 2, 20, 2, 1001, seed=2)
    S = args[0].shape[0]
    g = torch.Generator().manual_seed(8)
    cts = [torch.randn(S // 8, 32, generator=g),
           torch.randn(S // 8, 1, generator=g),
           torch.randn(S, 1, generator=g), torch.randn(S, 1, generator=g)]
    cts = [c.to(dev) for c in cts]
    first = tt.shade_bwd(*cfg, *args, ops, *cts)
    second = tt.shade_bwd(*cfg, *args, ops, *cts)
    want = tt.fused_shade_bwd_reference(*cfg, *args, ops, *cts)
    torch.cuda.synchronize()
    for a, b, c in zip(first[6], second[6], want[6]):
        assert torch.equal(a, b)
        assert float((a - c).abs().max()) <= SUM_REL * float(c.abs().max())


SHADE_GRID = [(K, order, mode, L) for K in (1, 8) for order in (1, 2)
              for mode in (20, 0) for L in (1, 2)]


def _shade_args(dev, K, order, mode, L, n_pts, seed=0):
    """fused_shade's arguments at small widths, shaped like the path's:
    neighbors within a few voxels of their sample, validity a prefix of each
    K-group (some groups all masked), confs across [0, 1.2], unit point and
    view directions, a random rotation. Rows whose LeakyReLU input lies
    within KINK of 0 are masked (then no cotangent reaches their layers)."""
    rng = np.random.RandomState(seed)
    S = n_pts * K
    up = lambda x: np.repeat(x, K, axis=0)

    def unit(n):
        v = rng.normal(size=(n, 3))
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    slw = rng.uniform(-0.5, 0.5, (n_pts, 3))
    sl = np.concatenate([rng.uniform(-0.3, 0.3, (n_pts, 2)),
                         rng.uniform(2.0, 4.0, (n_pts, 1))], axis=1)
    valid = rng.randint(0, K + 1, n_pts) if K > 1 else rng.rand(n_pts) < 0.7
    mask = (np.arange(S) % K < up(np.asarray(valid, np.int64)))[:, None]
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    rows = [rng.uniform(-0.5, 0.5, (S, 8)),
            up(slw) + rng.normal(0, 0.02, (S, 3)),
            up(sl) + rng.normal(0, 0.01, (S, 3)), rng.uniform(0, 1, (S, 3)),
            unit(S), rng.uniform(0, 1.2, (S, 1)), mask, sl, slw, unit(n_pts),
            q]
    args = [torch.as_tensor(np.asarray(a, np.float32), device=dev)
            for a in rows]
    opt = _opt(L, L, order, agg_dist_pers=mode)
    agg = init_aggregator_params(opt, torch.Generator().manual_seed(K + L),
                                 device=dev)
    ops = [o.detach() for o in tt.pack_trunk_params(
        agg, 8, tt.DIST_COLS[mode], 2, 3, with_alpha=order == 2)]
    f = tt.shade_front(*args[1:], mode, K)
    zs = tt.trunk_activations(L, L, 2, 3, args[0], f.d_raw, f.ex3, ops,
                              order == 2)
    for z in zs[2] + zs[4]:
        args[6] = args[6] * (z.abs() >= KINK).all(dim=1, keepdim=True)
    return (L, L, 2, 3, K, True, order == 1, mode), args, ops


@pytest.mark.parametrize("K,order,mode,L", SHADE_GRID)
def test_shade_kernel_matches_plain(dev, K, order, mode, L):
    """K4 against fused_shade_reference: feat, alpha, w_n and conf_c."""
    cfg, args, ops = _shade_args(dev, K, order, mode, L, 2001 if K == 1
                                 else 375)
    before = [kernels.SHADE_FWD.launches, kernels.TRUNK_FWD.launches]
    with torch.inference_mode():
        got = tt.fused_shade(*cfg, *args, ops)
        want = tt.fused_shade_reference(*cfg, *args, ops)
    torch.cuda.synchronize()
    assert [kernels.SHADE_FWD.launches,
            kernels.TRUNK_FWD.launches] == [before[0] + 1, before[1]]
    assert (got[1] is None) == (order == 1) == (want[1] is None)
    for a, b in zip(got, want):
        if b is not None:
            torch.testing.assert_close(a, b, **TOL)


@pytest.mark.parametrize("K,order,mode,L", SHADE_GRID)
def test_shade_bwd_kernel_matches_plain(dev, K, order, mode, L):
    """K5 against fused_shade_bwd_reference, with nonzero cotangents on all
    four outputs: the six per-row cotangents at TOL, every weight gradient
    within SUM_REL of its largest entry, and bit-equal weight gradients
    over two launches."""
    cfg, args, ops = _shade_args(dev, K, order, mode, L, 2001 if K == 1
                                 else 375, seed=1)
    S = args[0].shape[0]
    g = torch.Generator().manual_seed(7)
    cts = [torch.randn(S // K, 32, generator=g),
           None if order == 1 else torch.randn(S // K, 1, generator=g),
           torch.randn(S, 1, generator=g), torch.randn(S, 1, generator=g)]
    cts = [None if c is None else c.to(dev) for c in cts]
    before = kernels.SHADE_BWD.launches
    got = tt.shade_bwd(*cfg, *args, ops, *cts)
    again = tt.shade_bwd(*cfg, *args, ops, *cts)
    want = tt.fused_shade_bwd_reference(*cfg, *args, ops, *cts)
    torch.cuda.synchronize()
    assert kernels.SHADE_BWD.launches == before + 2
    for a, b in zip(got[:6], want[:6]):
        torch.testing.assert_close(a, b, **TOL)
    assert len(got[6]) == len(want[6])
    for a, b, c in zip(got[6], want[6], again[6]):
        assert a.shape == b.shape and torch.equal(a, c)
        assert float((a - b).abs().max()) <= SUM_REL * float(b.abs().max())


def test_occupancy_kernel_matches_plain(dev):
    rng = np.random.RandomState(3)
    xyz = rng.uniform(-0.4, 0.4, (600, 3)).astype(np.float32)
    opt = _opt(vsize=(0.04, 0.04, 0.04), vscale=(1, 1, 1),
               kernel_size=(3, 3, 3), query_size=(3, 3, 3), max_o=2048, P=8,
               ranges=(-0.5, -0.5, -0.5, 0.5, 0.5, 0.5))
    spec = tgrid.make_grid_spec(opt, xyz.min(0), xyz.max(0), len(xyz))
    grid = tgrid.build_grid(torch.as_tensor(xyz, device=dev),
                            torch.ones(len(xyz), dtype=torch.bool,
                                       device=dev), spec)
    campos = torch.tensor([[0.1, -0.2, -1.5]], device=dev)
    rd = torch.as_tensor(rng.uniform(-0.3, 0.3, (1, 300, 3)) + [0, 0, 1.0],
                         dtype=torch.float32, device=dev)
    _, _, _, t = raygen.near_far_linear_ray_generation(campos, rd, 97,
                                                       near=0.5, far=2.5)
    got, over = tq.mask_raypos_segmented(campos, rd, t, grid, spec)
    want = tq.mask_raypos(tq.ray_points(campos, rd, t), grid, spec)
    assert int(over) == 0 and want.any()
    assert torch.equal(got, want)


def _select_workload(dev, broadcast: bool, D=97, R=256):
    """A box-shaped cloud and rays that miss, graze or cross its grid (0,
    fewer than 80 and more than 80 occupied samples of D = 97), with
    broadcast depths (strides 0, 0, 1) or depths jittered per ray."""
    rng = np.random.RandomState(11)
    xyz = (rng.uniform(-1, 1, (1200, 3)) * [0.4, 0.4, 0.55]
           ).astype(np.float32)
    opt = _opt(vsize=(0.04, 0.04, 0.04), vscale=(1, 1, 1),
               kernel_size=(3, 3, 3), query_size=(3, 3, 3), max_o=4096, P=8,
               ranges=(-0.6, -0.6, -0.6, 0.6, 0.6, 0.6))
    spec = tgrid.make_grid_spec(opt, xyz.min(0), xyz.max(0), len(xyz))
    grid = tgrid.build_grid(torch.as_tensor(xyz, device=dev),
                            torch.ones(len(xyz), dtype=torch.bool,
                                       device=dev), spec)
    campos = torch.tensor([[0.02, -0.03, -1.2]], device=dev)
    tgt = np.zeros((1, R, 3))
    tgt[..., :2] = rng.uniform(-0.2, 0.2, (1, R, 2))
    tgt[:, :R // 4, 0] += 3.0
    tgt[:, R // 4:R // 2, 0] = rng.uniform(0.47, 0.5, (1, R // 4))
    rd = torch.as_tensor(tgt, dtype=torch.float32, device=dev) - campos
    rd = rd / rd.norm(dim=-1, keepdim=True)
    u = None if broadcast else torch.rand(
        (1, R, D), generator=torch.Generator(device=dev).manual_seed(2),
        device=dev)
    _, _, _, t = raygen.near_far_linear_ray_generation(
        campos, rd, D, near=0.55, far=1.85, jitter=0.0 if broadcast else 0.3,
        u=u)
    assert (t.stride() == (0, 0, 1)) == broadcast
    return campos, rd, t, grid, spec


@pytest.mark.parametrize("broadcast", [True, False],
                         ids=["broadcast", "jittered"])
@pytest.mark.parametrize("SR", [1, 7, 80, 120])
def test_occupancy_select_kernel_matches_plain(dev, SR, broadcast):
    """K3's select mode equals its plain version exactly, over two
    launches; SR = 120 > D leaves the slots past D empty."""
    campos, rd, t, grid, spec = _select_workload(dev, broadcast)
    before = kernels.OCCUPANCY.launches
    got = tq.occupancy_select(campos, rd, t, grid, spec, SR)
    again = tq.occupancy_select(campos, rd, t, grid, spec, SR)
    want = tq.occupancy_select_reference(campos, rd, t, grid, spec, SR)
    torch.cuda.synchronize()
    assert kernels.OCCUPANCY.launches == before + 2
    total = tq.mask_raypos(tq.ray_points(campos, rd, t), grid,
                           spec).sum(-1)
    assert (total == 0).any() and ((0 < total) & (total < 80)).any() \
        and (total > 80).any()
    for a, b, c in zip(got[:3], want, again[:3]):
        assert a.dtype == b.dtype and torch.equal(a, b)
        assert torch.equal(a, c)
    assert int(got[3]) == 0
    if SR > t.shape[-1]:
        assert not got[1][..., t.shape[-1]:].any()
        assert not got[0][..., t.shape[-1]:, :].any()


def _edge_workload(dev, D=97):
    """Samples whose voxel x coordinate lands on the edges of K3's floor
    and bounds test: -0.0 and just below vdim (inside the grid, in occupied
    voxels), in (-1, 0), exactly vdim, at 2^22, past ±2^22 and ±inf
    (outside), then samples across the grid. The grid is
    `_select_workload`'s with its x origin moved to 0, so a sample at x has
    the coordinate x·(1/vsize); the first ray runs along +x from
    (-0.0, y, z), so its sample x is t exactly. The second ray's direction
    is NaN. Returns (campos, raydir, t, grid, spec, the plain mask the
    edge samples must have)."""
    *_, grid, spec = _select_workload(dev, True)
    spec = dataclasses.replace(spec, ranges_min=(0.0, *spec.ranges_min[1:]))
    vd, vs = spec.vdim, spec.scaled_vsize
    occ = grid["coor_occ_rows"].reshape(-1)[:spec.grid_size_vol].reshape(
        vd).cpu() > 0
    j, k = (int(i) for i in torch.nonzero(occ[0] & occ[-1])[0])
    inv = np.float32(1) / np.float32(vs[0])
    at_vdim = np.float32(vd[0]) / inv
    below = np.nextafter(at_vdim, np.float32(0))
    assert at_vdim * inv == vd[0] and below * inv < vd[0]
    edges = np.array([-0.0, below, -0.5 / inv, -1e-30, at_vdim,
                      2.0 ** 22 / inv, 5e6 / inv, -5e6 / inv, 1e30, -1e30,
                      3e38, -3e38], np.float32)
    row = np.concatenate([edges, np.linspace(-0.1, at_vdim + 0.1,
                                             D - len(edges),
                                             dtype=np.float32)])
    t = torch.as_tensor(np.tile(row, (1, 2, 1)), device=dev)
    campos = torch.tensor([[-0.0,
                            spec.ranges_min[1] + (j + 0.5) * vs[1],
                            spec.ranges_min[2] + (k + 0.5) * vs[2]]],
                          device=dev)
    rd = torch.tensor([[[1.0, 0.0, 0.0], [float("nan")] * 3]], device=dev)
    inside = torch.zeros(len(edges), dtype=torch.bool)
    inside[:2] = True
    return campos, rd, t, grid, spec, inside


@pytest.mark.parametrize("SR", [None, 7, 80], ids=["mask", "SR7", "SR80"])
def test_occupancy_kernel_edge_coordinates(dev, SR):
    """K3 floors on the float pipe (a round-down add of 1.5·2^23, one
    unsigned compare an axis); at the edges of that test it equals the
    plain version's floor and compares, in mask mode and in select mode.
    A NaN position lies outside the grid in the kernel; the plain
    version's float-to-int conversion, as JAX's, takes it to voxel 0, so
    that ray is held to the kernel's own contract (no path makes NaN
    positions)."""
    campos, rd, t, grid, spec, inside = _edge_workload(dev)
    valid = tq.mask_raypos(tq.ray_points(campos, rd, t), grid, spec)
    assert torch.equal(valid[0, 0, :len(inside)].cpu(), inside)
    assert valid[0, 0, len(inside):].any()
    if SR is None:
        got, _ = tq.mask_raypos_segmented(campos, rd, t, grid, spec)
        assert torch.equal(got[:, :1], valid[:, :1])
        assert not got[:, 1].any()
    else:
        got = tq.occupancy_select(campos, rd, t, grid, spec, SR)
        want = tq.occupancy_select_reference(campos, rd, t, grid, spec, SR)
        for a, b in zip(got[:3], want):
            assert torch.equal(a[:, :1], b[:, :1])
        assert int(got[2][0, 1]) == 0 and not got[1][0, 1].any()
        assert not got[0][0, 1].any()


@pytest.mark.parametrize("case", ["volume", "samples"])
def test_occupancy_refuses_32bit_overflow(dev, case):
    """K3 indexes with 32-bit integers: a grid volume or a B·R·D of 2^31
    raises ValueError before anything launches."""
    campos, rd, t, grid, spec = _select_workload(dev, True)
    if case == "volume":
        spec = dataclasses.replace(spec, vdim=(2048, 1024, 1024))
    else:
        R, D = 2 ** 16, 2 ** 15
        rd = torch.zeros((1, R, 3), device=dev)
        t = torch.zeros(D, device=dev).expand(1, R, D)
    before = kernels.OCCUPANCY.launches
    with pytest.raises(ValueError, match="2\\^31"):
        tq.occupancy_select(campos, rd, t, grid, spec, 7)
    with pytest.raises(ValueError, match="2\\^31"):
        tq.mask_raypos_segmented(campos, rd, t, grid, spec)
    assert kernels.OCCUPANCY.launches == before


@pytest.mark.parametrize("Nc", [0, 600])
def test_query_on_card_selects_in_the_kernel(dev, monkeypatch, Nc):
    """On CUDA tensors query_grid_points takes its shading points from one
    K3 launch: the dense mask, select_shading_t and the float64 ray_points
    never run; the outputs equal the CPU's."""
    campos, rd, t, grid, spec = _select_workload(dev, True)
    cpu = tq.query_grid_points(campos.cpu(), rd.cpu(), t.cpu(),
                               {k: v.cpu() for k, v in grid.items()}, spec,
                               SR=7, K=4, Nc=Nc)

    def banned(*_a, **_k):
        raise AssertionError("the plain select ran on the card")
    for name in ("select_shading_t", "ray_points", "mask_raypos"):
        monkeypatch.setattr(tq, name, banned)
    before = kernels.OCCUPANCY.launches
    got = tq.query_grid_points(campos, rd, t, grid, spec, SR=7, K=4, Nc=Nc)
    torch.cuda.synchronize()
    assert kernels.OCCUPANCY.launches == before + 1
    for g, w in zip(got[:4] + got[5:], cpu[:4] + cpu[5:]):
        assert (g is None) == (w is None)
        if w is not None:
            assert torch.equal(g.cpu(), w)
    if Nc:
        for g, w in zip(got[4], cpu[4]):
            assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("use_fused_trunk", [-1, 0])
def test_render_goes_through_both_kernels_and_matches_cpu(dev,
                                                          use_fused_trunk):
    """A small scene rendered on the card (kernels) and on the CPU (plain
    versions) gives the same image; on the card K1 runs whatever
    use_fused_trunk says."""
    _render_card_vs_cpu(dev, use_fused_trunk=use_fused_trunk)


@pytest.mark.parametrize("dist_mode", [20, 0])
def test_shade_render_goes_through_k4_and_matches_cpu(dev, dist_mode):
    """fused_shade=1: the card renders through K4 (not K1) and K3, the CPU
    through K4's plain version, and the images agree."""
    _render_card_vs_cpu(dev, fused_shade=1, agg_dist_pers=dist_mode)


@pytest.mark.parametrize("use_fused_trunk", [-1, 1])
def test_edited_render_goes_through_k1_and_matches_cpu(dev, use_fused_trunk):
    """Per-point Rw2c (scene editing), random rotations: the card renders
    through K1 on the per-neighbor rotated distances and dirs, the CPU
    through the composition (-1) or K1's plain version (1), and the
    images agree."""
    _render_card_vs_cpu(dev, per_point_rw2c=True,
                        use_fused_trunk=use_fused_trunk)


def _rotations(n, rng):
    q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    return q.astype(np.float32)


def _render_card_vs_cpu(dev, per_point_rw2c=False, **kw):
    """Render a small scene on the CPU and on the card with options `kw`
    (and random per-point Rw2c if asked); the card launches the forward
    kernels of the configuration (K4 with fused_shade, else K1) and K3,
    the CPU none, and the outputs agree."""
    shade = kw.get("fused_shade", 0) > 0
    rng = np.random.RandomState(0)
    xyz = rng.uniform(-0.4, 0.4, (800, 3)).astype(np.float32)
    xyz[:, 2] *= 0.1
    n = len(xyz)
    opt = _opt(vsize=(0.04, 0.04, 0.04), vscale=(1, 1, 1),
               kernel_size=(3, 3, 3), query_size=(3, 3, 3), max_o=2048, P=8,
               K=8, SR=8, z_depth_dim=64, superset_P=16, SR_budget=-1,
               ranges=(-0.5, -0.5, -0.5, 0.5, 0.5, 0.5),
               radius_limit_scale=4.0, **kw)
    cloud = dict(xyz=xyz, embedding=rng.uniform(-0.5, 0.5, (n, 8)),
                 color=rng.uniform(0, 1, (n, 3)),
                 direction=rng.normal(size=(n, 3)),
                 conf=np.full((n, 1), 0.8))
    if per_point_rw2c:
        cloud["Rw2c"] = _rotations(n, rng)
    agg = init_aggregator_params(opt, torch.Generator().manual_seed(0),
                                 device="cpu")
    px = np.linspace(-0.15, 0.15, 24, dtype=np.float32)
    dx, dy = np.meshgrid(px, px, indexing="ij")
    rd = np.stack([dx, dy, np.ones_like(dx)], -1).reshape(1, -1, 3)
    outs = {}
    for device in ("cpu", dev):
        state = npc.create_point_cloud(**cloud, device=device)
        spec = tgrid.make_grid_spec(opt, xyz.min(0), xyz.max(0), n)
        grid = tgrid.build_grid(state["xyz"], state["mask"], spec)
        batch = {"raydir": torch.as_tensor(rd, device=device),
                 "campos": torch.tensor([[0.0, 0.0, -3.0]], device=device),
                 "camrotc2w": torch.eye(3, device=device)[None],
                 "near": 2.0, "far": 4.0,
                 "bg_color": torch.ones(1, 3, device=device)}
        st = trainer.ServeState(agg.to(device), state)
        for k in kernels.KERNELS:
            k.launches = 0
        outs[str(device)] = trainer.eval_step(st, grid, batch, opt, spec)
        fwd = kernels.SHADE_FWD if shade else kernels.TRUNK_FWD
        on = {fwd.name, kernels.OCCUPANCY.name} if device == dev else set()
        assert {k.name for k in kernels.KERNELS if k.launches} == on
    cpu, gpu = outs["cpu"], outs[str(dev)]
    assert torch.equal(cpu["ray_mask"], gpu["ray_mask"].cpu())
    assert bool(cpu["ray_mask"].any())
    torch.testing.assert_close(gpu["coarse_raycolor"].cpu(),
                               cpu["coarse_raycolor"], **TOL)


def test_train_step_on_card_matches_cpu(dev):
    """compute_grads and then one train_step from the same state, batch and
    jitter draws on the card (K1, K2, K3) and on the CPU (plain versions):
    equal counters, close losses and gradients, and after the Adam step
    parameters that agree wherever the gradient is well above Adam's eps
    (nearer to 0, Adam's step turns last-digit gradient differences into
    step differences of up to lr)."""
    _train_step_card_vs_cpu(dev, fused_shade=0)


def test_shade_train_step_on_card_matches_cpu(dev):
    """As test_train_step_on_card_matches_cpu with fused_shade=1: the card
    runs K4, K5 and K3 (not K1, K2), the CPU their plain versions."""
    _train_step_card_vs_cpu(dev, fused_shade=1)


def _train_step_card_vs_cpu(dev, fused_shade):
    rng = np.random.RandomState(0)
    xyz = rng.uniform(-0.4, 0.4, (800, 3)).astype(np.float32)
    xyz[:, 2] *= 0.1
    n = len(xyz)
    opt = _opt(vsize=(0.04, 0.04, 0.04), vscale=(1, 1, 1),
               kernel_size=(3, 3, 3), query_size=(3, 3, 3), max_o=2048, P=8,
               K=8, SR=8, z_depth_dim=64, superset_P=16, SR_budget=-1,
               k_tier=-1, ranges=(-0.5, -0.5, -0.5, 0.5, 0.5, 0.5),
               radius_limit_scale=4.0, use_fused_trunk=1, lr=0.01, plr=0.02,
               color_loss_items=("ray_masked_coarse_raycolor",),
               color_loss_weights=(1.0,),
               zero_one_loss_items=("conf_coefficient",),
               zero_one_loss_weights=(0.0001,), fused_shade=fused_shade)
    cloud = dict(xyz=xyz, embedding=rng.uniform(-0.5, 0.5, (n, 8)),
                 color=rng.uniform(0, 1, (n, 3)),
                 direction=rng.normal(size=(n, 3)),
                 conf=rng.uniform(0.5, 1.2, (n, 1)))
    px = np.linspace(-0.15, 0.15, 24, dtype=np.float32)
    dx, dy = np.meshgrid(px, px, indexing="ij")
    rd = np.stack([dx, dy, np.ones_like(dx)], -1).reshape(1, -1, 3)
    gt = rng.uniform(0, 1, (1, rd.shape[1], 3)).astype(np.float32)
    u = torch.rand((1, rd.shape[1], 64), generator=torch.Generator())
    agg = init_aggregator_params(opt, torch.Generator().manual_seed(0),
                                 device="cpu")
    runs = {}
    for device in ("cpu", dev):
        state = npc.create_point_cloud(**cloud, device=device)
        spec = tgrid.make_grid_spec(opt, xyz.min(0), xyz.max(0), n)
        grid = tgrid.build_grid(state["xyz"], state["mask"], spec)
        batch = {"raydir": torch.as_tensor(rd, device=device),
                 "campos": torch.tensor([[0.0, 0.0, -3.0]], device=device),
                 "camrotc2w": torch.eye(3, device=device)[None],
                 "near": 2.0, "far": 4.0,
                 "bg_color": torch.ones(1, 3, device=device),
                 "gt_image": torch.as_tensor(gt, device=device)}
        st = trainer.make_train_state(copy.deepcopy(agg).to(device), state,
                                      opt, torch.Generator(device=device))
        for k in kernels.KERNELS:
            k.launches = 0
        grads = trainer.compute_grads(st, grid, batch, opt, spec,
                                      u.to(device))
        _, items = trainer.train_step(st, grid, batch, opt, spec,
                                      u=u.to(device))
        used = ((kernels.SHADE_FWD, kernels.SHADE_BWD) if fused_shade
                else (kernels.TRUNK_FWD, kernels.TRUNK_BWD))
        on = ({k.name for k in used} | {kernels.OCCUPANCY.name,
                                         kernels.SCATTER_ROWS.name}
              if device == dev else set())
        assert {k.name for k in kernels.KERNELS if k.launches} == on
        runs[str(device)] = (grads, items, st)
    (g_cpu, i_cpu, s_cpu), (g_gpu, i_gpu, s_gpu) = runs["cpu"], runs[str(dev)]
    assert float(i_cpu["sr_overflow"]) == float(i_gpu["sr_overflow"])
    for k, v in i_cpu.items():
        np.testing.assert_allclose(float(i_gpu[k]), float(v), rtol=1e-4,
                                   err_msg=k)
    for part in (1, 2):
        for k, g in g_cpu[part].items():
            d = g_gpu[part][k].cpu() - g
            assert float(d.norm()) <= GRAD_REL * float(g.norm()), k
    params = lambda st: {**dict(st.aggregator.named_parameters()),
                         **st.pt_train}
    p_cpu, p_gpu = params(s_cpu), params(s_gpu)
    g_all = {**g_cpu[1], **g_cpu[2]}
    for k, p in p_cpu.items():
        q = p_gpu[k].detach().cpu()
        big = g_all[k].abs() > 1e-6
        torch.testing.assert_close(q[big], p.detach()[big], rtol=1e-5,
                                   atol=1e-6, msg=k)
        assert float((q - p.detach()).abs().max()) <= 2 * 0.02 + 1e-6, k


def _scatter_case(case, C):
    """(idx [S] numpy, upd [S, C] numpy, cap) of one K6 case."""
    rng = np.random.RandomState(C)
    S, cap = 20_011, 3_001
    idx = rng.randint(0, cap // 6, S).astype(np.int64) * 6
    idx[rng.rand(S) < 0.3] = -1
    if case == "none kept":
        idx[:] = -1
    elif case == "one row":
        idx[:] = 17
    elif case == "train-like":            # a train step's wide tier
        S, cap = 96_000, 102_400
        idx = rng.randint(0, cap, S).astype(np.int64)
        idx[rng.rand(S) < 0.684] = -1
    upd = rng.uniform(-1, 1, (S, C)).astype(np.float32)
    if case == "train-like":
        upd *= 1e-4                       # a train step's gradient scale
    return idx, upd, cap


@pytest.mark.parametrize("case,C,idx_dtype", [
    ("dup", 42, torch.int32), ("dup", 7, torch.int32),
    ("dup", 42, torch.int64), ("dup", 7, torch.int64),
    ("dup", 130, torch.int64), ("none kept", 42, torch.int64),
    ("one row", 42, torch.int32), ("one row", 7, torch.int64),
    ("misaligned upd", 42, torch.int64), ("train-like", 42, torch.int64)])
def test_scatter_rows_kernel_matches_plain(dev, case, C, idx_dtype):
    """K6 with duplicate indices (each row drawn ~6 times) and skipped
    negative ones, int32 or int64 indices (taken unconverted), against the
    plain version and np.add.at; an odd C takes the one-float path, C 130
    several column passes a warp. Also: every entry skipped (the table
    stays zero), every entry on one row, an upd 4 bytes off an 8-byte
    boundary (the wrapper copies it for the float2 loads), and a train
    step's wide tier (68% skipped, gradients ~1e-4). Each entry within
    TOL, and within 1e-4 of the sum of |updates| reaching it (the scale of
    the atomics' rounding in any order; the one-row sum of 20,011 updates
    is held to that alone)."""
    idx, upd, cap = _scatter_case(case, C)
    S = idx.shape[0]
    idx_t = torch.as_tensor(idx, device=dev).to(idx_dtype)
    upd_t = torch.as_tensor(upd, device=dev)
    if case == "misaligned upd":
        buf = torch.zeros(S * C + 1, device=dev)
        buf[1:] = upd_t.reshape(-1)
        upd_t = buf[1:].view(S, C)
        assert upd_t.data_ptr() % 8 == 4
    before = kernels.SCATTER_ROWS.launches
    got = scatter_add_rows(idx_t, upd_t, cap)
    torch.cuda.synchronize()
    assert kernels.SCATTER_ROWS.launches == before + 1
    want = scatter_add_rows_reference(idx_t, upd_t, cap)
    abs_sum = scatter_add_rows_reference(idx_t, upd_t.abs(), cap)
    assert bool(((got - want).abs() <= SUM_REL * abs_sum + 1e-30).all())
    if case == "none kept":
        assert not bool(got.any())
    if case != "one row":
        torch.testing.assert_close(got, want, **TOL)
    ref = np.zeros((cap, C), np.float32)
    keep = idx >= 0
    np.add.at(ref, idx[keep], upd[keep])
    np.testing.assert_allclose(got.cpu().numpy(), ref,
                               **(TOL if case != "one row"
                                  else dict(rtol=1e-4, atol=1e-2)))


def test_scatter_rows_kernel_traps_on_an_index_past_the_table(dev):
    """An index at or past n_rows stops K6 with an error, as index_put_
    does, instead of dropping the update. Run in a child process: the trap
    loses the CUDA context."""
    scatter_add_rows(torch.zeros(1, dtype=torch.int32, device=dev),
                     torch.ones(1, 42, device=dev), 50)   # built before
    code = ("import torch\n"
            "from pointnerf_tpu_torch.ops.scatter import scatter_add_rows\n"
            "idx = torch.tensor([0, 3, 50], dtype=torch.int32, device='cuda')\n"
            "upd = torch.ones(3, 42, device='cuda')\n"
            "print('launching', flush=True)\n"
            "scatter_add_rows(idx, upd, 50)\n"
            "torch.cuda.synchronize()\n")
    res = subprocess.run([sys.executable, "-c", code],
                         cwd=Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=600)
    assert "launching" in res.stdout, res.stderr[-2000:]
    assert res.returncode != 0


@pytest.mark.parametrize("case", ["base", "D397", "clamps", "offset",
                                  "misaligned rows"])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("Rt", [8, 16, 32, 120])
def test_row_select_kernel_matches_plain(dev, dtype, Rt, case):
    """K7 equals its plain version for both row types, per-ray row sets and
    one row set shared by every ray (ray stride 0), N = 37 ragged against
    Rt. Cases: D 397 (rays off 16-byte boundaries: scalar heads and
    tails), rank and lane at and past both ends of their clamps, rank and
    lane starting one element off a 16-byte boundary (the scalar path),
    and rows_g off a 16-byte boundary, which the bulk copy cannot take:
    ValueError."""
    g = torch.Generator().manual_seed(Rt)
    N, D, U, LW = 37, 397 if case == "D397" else 50, 9, 128
    rows = (torch.rand(N, U, LW, generator=g) < 0.3).to(dtype).to(dev)
    lo, hi = (-3, U + 3) if case == "clamps" else (0, U)
    rank = torch.randint(lo, hi, (N, D), generator=g, dtype=torch.int32)
    lo, hi = (-3, LW + 3) if case == "clamps" else (0, LW)
    lane = torch.randint(lo, hi, (N, D), generator=g, dtype=torch.int32)
    if case == "clamps":
        rank[:, :4] = torch.tensor([-1, 0, U - 1, U])
        lane[:, :4] = torch.tensor([LW, LW - 1, 0, -1])
    rank, lane = rank.to(dev), lane.to(dev)
    if case == "offset":
        rank = torch.cat([rank.new_zeros(1), rank.reshape(-1)])[1:].view(N, D)
        lane = torch.cat([lane.new_zeros(1), lane.reshape(-1)])[1:].view(N, D)
        assert rank.data_ptr() % 16 and lane.data_ptr() % 16
    if case == "misaligned rows":
        flat = torch.zeros(N * U * LW + 1, dtype=dtype, device=dev)
        bad = flat[1:].view(N, U, LW)
        with pytest.raises(ValueError, match="16-byte"):
            tq.row_select(bad, rank, lane, Rt)
        return
    for rows_g in (rows, rows[:1].expand(N, U, LW)):
        got = tq.row_select(rows_g, rank, lane, Rt)
        torch.cuda.synchronize()
        assert torch.equal(got, tq.row_select_reference(rows_g, rank, lane))


def _plate_driver_opt(root, **kw):
    from pointnerf_tpu_torch.run.workload import make_plate_scene
    make_plate_scene(root, wh=(64, 64), side=120)
    from pointnerf_tpu_torch.config import nerf_synth_preset
    return nerf_synth_preset("lego").replace(
        data_root=root, scan="plate", img_wh=(64, 64),
        checkpoints_dir=str(root) + "/ckpt", experiment="plate",
        load_points=1, random_sample_size=24, vox_res=120, maximum_step=6,
        prune_iter=2,
        prune_max_iter=2, prob_freq=4, prob_mode=2, prob_thresh=-1.0,
        print_freq=3, save_iter_freq=100, save_point_freq=0, test_freq=0,
        test_num=1, **kw)


def test_driver_steps_prune_grow_and_checkpoint_on_card(dev, tmp_path):
    """A few finetune steps at lego widths on the card: one prune, one
    probe-and-grow (every probed hit ray a candidate), K6 on every step, a
    checkpoint written and loaded back on the card, and a resume that
    stops at once."""
    from pointnerf_tpu_torch.run import train_ft
    from pointnerf_tpu_torch.utils.checkpoint import load_checkpoint
    opt = _plate_driver_opt(str(tmp_path))
    for k in kernels.KERNELS:
        k.launches = 0
    res = train_ft.main(opt)
    assert res["total_steps"] == 6 and res["timing"]["steps"] == 6
    assert res["timing"]["prune"] and res["timing"]["grow"]
    assert kernels.SCATTER_ROWS.launches >= 6
    assert np.isfinite(res["final_psnr"])
    st, counters = load_checkpoint(str(tmp_path) + "/ckpt/plate", opt,
                                   device=dev)
    assert counters["total_steps"] == 6 and st.step == 6
    for k, v in res["state"].points.items():
        if v is not None:
            torch.testing.assert_close(st.points[k], v, rtol=0, atol=0)
    for p, q in zip(st.opt_pts.param_groups[0]["params"],
                    res["state"].opt_pts.param_groups[0]["params"]):
        a, b = st.opt_pts.state[p], res["state"].opt_pts.state[q]
        assert float(a["step"]) == float(b["step"])
        torch.testing.assert_close(a["exp_avg"], b["exp_avg"], rtol=0, atol=0)
    again = train_ft.main(opt)
    assert again["total_steps"] == 6 and again["timing"]["steps"] == 0


def test_mvs_gen_points_on_card_matches_cpu(dev, tmp_path):
    """One triplet of the MVS init (lego preset, 64×64 plate scene, MVSNet
    over 32 depth planes) on the card against the CPU with the same
    weights, cuDNN's TF32 off: depth, prob and the rows' outputs within
    TOL, conf away from regressed-index ties, keep masks equal, rows
    compared away from those ties and where both devices saw the same
    views."""
    from pointnerf_tpu_torch.data import create_dataset
    from pointnerf_tpu_torch.models.mvs import points_model as pm
    opt = _plate_driver_opt(str(tmp_path)).replace(
        load_points=0, shading_feature_mlp_layer0=1, depth_grid=32,
        depth_conf_thresh=0.0, near_plane=2.5, far_plane=3.5)
    sample = create_dataset(opt, "train").get_init_item(0)
    mvs = pm.MvsPoints(opt, torch.Generator().manual_seed(0), device="cpu")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        maps_c, maps_h = {}, {}
        card = pm.gen_points(copy.deepcopy(mvs).to(dev), opt, sample,
                             maps=maps_c)
        host = pm.gen_points(mvs, opt, sample, maps=maps_h)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    for k in ("depth", "prob"):
        torch.testing.assert_close(maps_c[k][0].cpu(), maps_h[k][0], **TOL)
    idx = maps_h["index"][0]
    away = (idx - idx.round()).abs() > 1e-4
    torch.testing.assert_close(maps_c["conf"][0].cpu()[away],
                               maps_h["conf"][0][away], **TOL)
    assert torch.equal(card["keep"].cpu(), host["keep"])
    hw = torch.arange(len(host["keep"])) % (64 * 64)
    rows = host["keep"] & away[hw // 64 // 4, hw % 64 // 4] & torch.all(
        maps_c["vis"][0].cpu() == maps_h["vis"][0], dim=-1)
    assert rows.float().mean() > 0.9
    for k in ("xyz_w", "embedding", "color", "dir", "conf"):
        torch.testing.assert_close(card[k].cpu()[rows], host[k][rows], **TOL)


def _dtu_opts(root, preset, **kw):
    """A dtu preset at 64x64 on the DTU-layout plate scene
    (run/workload.make_dtu_scene), MVSNet over 32 planes, random weights:
    conf threshold 0 and no geometric consistency."""
    from pointnerf_tpu_torch import config
    from pointnerf_tpu_torch.run.workload import make_dtu_scene
    make_dtu_scene(root, n_views=6, wh=(64, 64))
    return getattr(config, preset)().replace(
        data_root=root, img_wh=(64, 64), depth_grid=32,
        depth_conf_thresh=0.0, geo_cnsst_num=0,
        checkpoints_dir=str(root) + "/ckpt", **kw)


def test_frustum_render_on_card_matches_cpu(dev, tmp_path):
    """The dtu_inf preset's frustum render (order 1) of a 64x64 item from
    the same feed-forward points on the card (K1, and no other kernel: the
    frustum occupancy is plain PyTorch) and on the CPU (K1's plain
    version): ray masks equal, colors within TOL, counters equal."""
    from pointnerf_tpu_torch.data import create_dataset
    from pointnerf_tpu_torch.run import common
    from pointnerf_tpu_torch.run import train as gen
    opt = _dtu_opts(str(tmp_path), "dtu_inf_preset", random_sample_size=16,
                    SR_budget=-1)
    ds = create_dataset(opt, "test")
    spec = gen.make_render_spec(opt, ds, gen.point_slots(opt))
    item = ds.get_item(0, full_img=True)
    st = gen.create_gen_state(opt, device="cpu")
    with torch.inference_mode():
        ps = gen.feedforward_point_state(st.mvs, opt, item["mvs_sample"])
    outs = {}
    for device in ("cpu", dev):
        ts = trainer.ServeState(copy.deepcopy(st.aggregator).to(device),
                                {k: v.to(device) for k, v in ps.items()})
        for k in kernels.KERNELS:
            k.launches = 0
        stats = {}
        outs[str(device)] = (common.render_image(
            ts, None, opt, spec, item, stats=stats), stats)
        on = {kernels.TRUNK_FWD.name} if device == dev else set()
        assert {k.name for k in kernels.KERNELS if k.launches} == on
    (cpu, s_cpu), (gpu, s_gpu) = outs["cpu"], outs[str(dev)]
    assert s_cpu["num_occ"] == s_gpu["num_occ"] > 0
    assert s_cpu["sr_overflow"] == s_gpu["sr_overflow"]
    np.testing.assert_array_equal(gpu["ray_mask"], cpu["ray_mask"])
    assert cpu["ray_mask"].any()
    np.testing.assert_allclose(gpu["coarse_raycolor"], cpu["coarse_raycolor"],
                               **TOL)


def test_gen_step_on_card_matches_cpu(dev, tmp_path):
    """One dtu_gen gen_compute_grads (64x64, 16² rays, scene-bound ranges)
    from the same state, draws and frozen MVS half on the card (K1, K2, K3,
    K6) and on the CPU (plain versions): loss items within 1e-4, each
    gradient of the aggregator, the FPN and the premlp within GRAD_REL in
    norm."""
    from pointnerf_tpu_torch.data import create_dataset
    from pointnerf_tpu_torch.models.mvs import points_model as pm
    from pointnerf_tpu_torch.run import train as gen
    opt = _dtu_opts(str(tmp_path), "dtu_gen_preset", random_sample_size=16,
                    ranges=(-0.6, -0.6, -0.25, 0.6, 0.6, 0.25),
                    use_fused_trunk=1)
    ds = create_dataset(opt, "train")
    spec = gen.make_render_spec(opt, ds, gen.point_slots(opt))
    item = ds.get_item(0, rng=np.random.RandomState(0))
    sample = item.pop("mvs_sample")
    st = gen.create_gen_state(opt, device="cpu")
    depths = pm.mvs_depths(st.mvs, opt, sample)
    u = torch.rand((1, 256, opt.z_depth_dim), generator=torch.Generator())
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    runs = {}
    try:
        for device in ("cpu", dev):
            s = gen.make_gen_state(copy.deepcopy(st.aggregator).to(device),
                                   copy.deepcopy(st.mvs).to(device), opt,
                                   torch.Generator(device=device))
            for k in kernels.KERNELS:
                k.launches = 0
            runs[str(device)] = gen.gen_compute_grads(
                s, sample, gen.batch_of(item, device), opt, spec,
                u.to(device), depths={k: v.to(device)
                                      for k, v in depths.items()})
            on = ({kernels.TRUNK_FWD.name, kernels.TRUNK_BWD.name,
                   kernels.OCCUPANCY.name, kernels.SCATTER_ROWS.name}
                  if device == dev else set())
            assert {k.name for k in kernels.KERNELS if k.launches} == on
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    cpu, gpu = runs["cpu"], runs[str(dev)]
    for k, v in cpu[0].items():
        np.testing.assert_allclose(float(gpu[0][k]), float(v), rtol=1e-4,
                                   err_msg=k)
    assert float(cpu[0]["loss_ray_masked_coarse_raycolor"]) > 0
    for part in (1, 2):
        for k, g in cpu[part].items():
            d = gpu[part][k].cpu() - g
            assert float(d.norm()) <= GRAD_REL * float(g.norm()), k


def test_tt_finetune_test_ft_and_lpips_on_card(dev, tmp_path):
    """The evaluation path on the card: a few tt_preset("Truck") finetune
    steps on a 64x48 T&T-layout plate (K1, K2, K3, K6) ending in the render
    path's GIF, then test_ft with random LPIPS weights on the card and on
    the CPU from the same checkpoint: the mean PSNR within 1e-3 dB, the
    scores of the 8-bit PNGs (LPIPS too) within 1e-3 (a 1e-6 difference
    can cross a rounding edge of the 8-bit write)."""
    from pointnerf_tpu_torch.config import tt_preset
    from pointnerf_tpu_torch.run import test_ft, train_ft
    from pointnerf_tpu_torch.run.workload import (lpips_state_dict,
                                                  make_tt_scene)
    from pointnerf_tpu_torch.utils.gif import read_gif
    root = str(tmp_path)
    make_tt_scene(root, wh=(64, 48), radius=0.6, half=0.19, side=120)
    paths = {}
    for net in ("alex", "vgg"):
        paths[net] = f"{root}/lpips_{net}.pth"
        torch.save(lpips_state_dict(net, seed=len(net)), paths[net])
    opt = tt_preset("Truck").replace(
        data_root=root, img_wh=(64, 48), load_points=1,
        checkpoints_dir=root + "/ckpt", experiment="tt", maximum_step=4,
        random_sample_size=16, print_freq=2, save_iter_freq=100,
        test_freq=0, test_num=2, gen_vid=1)
    for k in kernels.KERNELS:
        k.launches = 0
    res = train_ft.main(opt)
    for k in (kernels.TRUNK_FWD, kernels.TRUNK_BWD, kernels.OCCUPANCY,
              kernels.SCATTER_ROWS):
        assert k.launches > 0, k.name
    assert len(read_gif(res["video"])) == 100
    scores = {}
    for device in ("cuda", "cpu"):
        scores[device] = test_ft.main(opt.replace(
            resume_dir=root + "/ckpt/tt", checkpoints_dir=root + "/" + device,
            lpips_alex_path=paths["alex"], lpips_vgg_path=paths["vgg"]),
            device=device)
    card, cpu = scores["cuda"], scores["cpu"]
    assert card["step"] == cpu["step"] == 4
    assert abs(card["psnr"] - cpu["psnr"]) < 1e-3
    assert sorted(card["scores"]) == ["lpips", "psnr", "rmse", "ssim",
                                      "vgglpips"]
    for k, v in cpu["scores"].items():
        np.testing.assert_allclose(card["scores"][k], v, rtol=1e-3,
                                   err_msg=k)


def test_dtu_ft_plane_background_and_step_on_card_match_cpu(dev, tmp_path,
                                                            monkeypatch):
    """dtu_ft_preset on the 64x64 DTU-layout plate, its back plane the
    fixture's white plane under the plate, the PFM points as the cloud: the
    test split's create_all_bg maps with the views' images on the card and
    on the CPU (masks equal, colours within 1e-5), then one train step's
    compute_grads with bg_ray from the same state and draws on the card
    (K1, K2, K3, K6) and on the CPU (plain versions): loss items within
    1e-4, gradients within GRAD_REL in norm."""
    import pointnerf_tpu_torch.data.dtu_ft as dtu_ft
    from pointnerf_tpu_torch.config import dtu_ft_preset
    from pointnerf_tpu_torch.data import create_dataset
    from pointnerf_tpu_torch.models.mvs import bg
    from pointnerf_tpu_torch.run import common, train_ft
    from pointnerf_tpu_torch.run.workload import make_dtu_scene
    root = str(tmp_path)
    make_dtu_scene(root, n_views=6, wh=(64, 64))
    monkeypatch.setattr(dtu_ft, "PLANE_PARAMS",
                        [((0.0, 0.0, -0.2), (0.0, 0.0, -1.0),
                          (1.0, 1.0, 1.0))] + dtu_ft.PLANE_PARAMS[1:])
    opt = dtu_ft_preset("scan1").replace(
        data_root=root, img_wh=(64, 64), test_num_step=3, load_points=1,
        vox_res=64, random_sample_size=16, use_fused_trunk=1,
        ranges=(-0.6, -0.6, -0.25, 0.6, 0.6, 0.25))
    train_ds, test_ds = create_dataset(opt, "train"), \
        create_dataset(opt, "test")
    fg_xyz = train_ds.load_init_points()
    params = train_ds.get_plane_param()
    maps = {}
    for device in ("cpu", dev):
        views = bg.collect_bg_views(train_ds, opt.init_view_num,
                                    device=device)
        assert views[0]["img"].device.type == torch.device(device).type
        maps[str(device)] = bg.create_all_bg(test_ds, views, fg_xyz, params)
    for a, b in zip(maps[str(dev)], maps["cpu"]):
        np.testing.assert_array_equal(a.max(-1) > 0, b.max(-1) > 0)
        assert 0 < (b.max(-1) > 0).mean() < 1
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)

    train_maps = bg.create_all_bg(
        train_ds, bg.collect_bg_views(train_ds, 3, device="cpu"), fg_xyz,
        params)
    item = train_ft.with_bg_ray(
        train_ds.get_item(1, rng=np.random.RandomState(1)), train_maps[1])
    assert (item["bg_ray"] > 0).any()
    agg = init_aggregator_params(opt, torch.Generator().manual_seed(0),
                                 device="cpu")
    u = torch.rand((1, 256, opt.z_depth_dim), generator=torch.Generator())
    runs = {}
    for device in ("cpu", dev):
        state = common.init_point_state_from_dataset(opt, train_ds,
                                                     device=device)
        spec, grid = common.make_spec_and_grid(opt, state)
        batch = {k: torch.as_tensor(item[k], device=device)
                 for k in train_ft.BATCH_KEYS + ("bg_ray",)}
        batch["near"], batch["far"] = float(item["near"]), float(item["far"])
        st = trainer.make_train_state(copy.deepcopy(agg).to(device), state,
                                      opt, torch.Generator(device=device))
        for k in kernels.KERNELS:
            k.launches = 0
        runs[str(device)] = trainer.compute_grads(st, grid, batch, opt, spec,
                                                  u.to(device))
        on = ({kernels.TRUNK_FWD.name, kernels.TRUNK_BWD.name,
               kernels.OCCUPANCY.name, kernels.SCATTER_ROWS.name}
              if device == dev else set())
        assert {k.name for k in kernels.KERNELS if k.launches} == on
    cpu, gpu = runs["cpu"], runs[str(dev)]
    for k, v in cpu[0].items():
        np.testing.assert_allclose(float(gpu[0][k]), float(v), rtol=1e-4,
                                   err_msg=k)
    for part in (1, 2):
        for k, g in cpu[part].items():
            d = gpu[part][k].cpu() - g
            assert float(d.norm()) <= GRAD_REL * float(g.norm()), k


def test_scannet_sensor_depth_step_and_render_on_card_match_cpu(dev,
                                                                tmp_path):
    """scannet_preset on a small ScanNet-layout plate (64x48 JPEG frames,
    32x24 16-bit depths) with its load_points 2 cloud: one train step's
    compute_grads from the same state and draws on the card (K1, K2, K3,
    K6) and on the CPU (plain versions), loss items within 1e-4 and
    gradients within GRAD_REL in norm; then a test view of 12 chunks
    rendered by render_image on both, masks equal and colours within
    1e-4."""
    from pointnerf_tpu_torch.config import scannet_preset
    from pointnerf_tpu_torch.data import create_dataset
    from pointnerf_tpu_torch.run import common, train_ft
    from pointnerf_tpu_torch.run.workload import make_scannet_scene
    root = str(tmp_path)
    make_scannet_scene(root, "scene0241_01", n=10, wh=(64, 48),
                       depth_wh=(32, 24))
    opt = scannet_preset("scene0241_01").replace(
        data_root=root, img_wh=(64, 48), random_sample_size=16,
        use_fused_trunk=1)
    train_ds, test_ds = create_dataset(opt, "train"), \
        create_dataset(opt, "test")
    item = train_ds.get_item(1, rng=np.random.RandomState(1))
    agg = init_aggregator_params(opt, torch.Generator().manual_seed(0),
                                 device="cpu")
    u = torch.rand((1, 256, opt.z_depth_dim), generator=torch.Generator())
    view = test_ds.get_item(0, full_img=True)
    runs, images = {}, {}
    for device in ("cpu", dev):
        state = common.init_point_state_from_dataset(opt, train_ds,
                                                     device=device)
        assert int(state["mask"].sum()) > 200
        spec, grid = common.make_spec_and_grid(opt, state)
        batch = {k: torch.as_tensor(item[k], device=device)
                 for k in train_ft.BATCH_KEYS}
        batch["near"], batch["far"] = float(item["near"]), float(item["far"])
        st = trainer.make_train_state(copy.deepcopy(agg).to(device), state,
                                      opt, torch.Generator(device=device))
        for k in kernels.KERNELS:
            k.launches = 0
        runs[str(device)] = trainer.compute_grads(st, grid, batch, opt, spec,
                                                  u.to(device))
        images[str(device)] = common.render_image(st, grid, opt, spec, view)
        on = ({kernels.TRUNK_FWD.name, kernels.TRUNK_BWD.name,
               kernels.OCCUPANCY.name, kernels.SCATTER_ROWS.name}
              if device == dev else set())
        assert {k.name for k in kernels.KERNELS if k.launches} == on
    cpu, gpu = runs["cpu"], runs[str(dev)]
    for k, v in cpu[0].items():
        np.testing.assert_allclose(float(gpu[0][k]), float(v), rtol=1e-4,
                                   err_msg=k)
    for part in (1, 2):
        for k, g in cpu[part].items():
            d = gpu[part][k].cpu() - g
            assert float(d.norm()) <= GRAD_REL * float(g.norm()), k
    a, b = images[str(dev)], images["cpu"]
    np.testing.assert_array_equal(a["ray_mask"], b["ray_mask"])
    assert 0 < (b["ray_mask"] > 0.5).mean() < 1
    np.testing.assert_allclose(a["coarse_raycolor"], b["coarse_raycolor"],
                               **TOL)


def test_vox_grid_step_and_render_on_card_match_cpu(dev, tmp_path):
    """NN -1 from a pickled plate cloud on a small plate scene (lego's
    trunk, trilinear weights, the shade-side compaction): the point state
    and the corner table equal on both; one compute_grads from the same
    state and draws on the card (K1, K2, K3, K6) and on the CPU (plain
    versions), losses within 1e-4 and gradients within GRAD_REL in norm;
    then a test view of 12 chunks rendered on both, masks equal and
    colours within 1e-4."""
    from pointnerf_tpu_torch.config import nerf_synth_preset
    from pointnerf_tpu_torch.data import create_dataset
    from pointnerf_tpu_torch.run import common, train_ft
    from pointnerf_tpu_torch.run.workload import (make_plate_scene,
                                                  write_cloud_pickle)
    root = str(tmp_path)
    make_plate_scene(root, wh=(48, 48), n_train=4, n_test=1)
    cpath = str(tmp_path / "cloud.pkl")
    write_cloud_pickle(cpath, side=60)
    opt = nerf_synth_preset("lego").replace(
        data_root=root, scan="plate", img_wh=(48, 48), random_sample_size=16,
        load_points=1, cloud_path=cpath, num_point=2000,
        point_noise="pointuniform_0.002", NN=-1, construct_res=8,
        grid_res=32, agg_distance_kernel="trilinear", agg_weight_norm=0,
        k_tier=0, SR_budget=512, use_fused_trunk=1)
    train_ds, test_ds = create_dataset(opt, "train"), \
        create_dataset(opt, "test")
    item = train_ds.get_item(1, rng=np.random.RandomState(1))
    agg = init_aggregator_params(opt, torch.Generator().manual_seed(0),
                                 device="cpu")
    u = torch.rand((1, 256, opt.z_depth_dim), generator=torch.Generator())
    view = test_ds.get_item(0, full_img=True)
    runs, images, tables = {}, {}, {}
    for device in ("cpu", dev):
        state = common.init_point_state_from_dataset(opt, train_ds,
                                                     device=device)
        spec, grid = common.make_spec_and_grid(opt, state)
        tables[str(device)] = (spec, grid["vox_table"].cpu())
        batch = {k: torch.as_tensor(item[k], device=device)
                 for k in train_ft.BATCH_KEYS}
        batch["near"], batch["far"] = float(item["near"]), float(item["far"])
        st = trainer.make_train_state(copy.deepcopy(agg).to(device), state,
                                      opt, torch.Generator(device=device))
        for k in kernels.KERNELS:
            k.launches = 0
        runs[str(device)] = trainer.compute_grads(st, grid, batch, opt, spec,
                                                  u.to(device))
        images[str(device)] = common.render_image(st, grid, opt, spec, view)
        on = ({kernels.TRUNK_FWD.name, kernels.TRUNK_BWD.name,
               kernels.OCCUPANCY.name, kernels.SCATTER_ROWS.name}
              if device == dev else set())
        assert {k.name for k in kernels.KERNELS if k.launches} == on
    assert tables["cpu"][0] == tables[str(dev)][0]
    assert torch.equal(tables["cpu"][1], tables[str(dev)][1])
    cpu, gpu = runs["cpu"], runs[str(dev)]
    for k, v in cpu[0].items():
        np.testing.assert_allclose(float(gpu[0][k]), float(v), rtol=1e-4,
                                   err_msg=k)
    for part in (1, 2):
        for k, g in cpu[part].items():
            d = gpu[part][k].cpu() - g
            assert float(d.norm()) <= GRAD_REL * float(g.norm()), k
    a, b = images[str(dev)], images["cpu"]
    np.testing.assert_array_equal(a["ray_mask"], b["ray_mask"])
    assert 0 < (b["ray_mask"] > 0.5).mean() < 1
    np.testing.assert_allclose(a["coarse_raycolor"], b["coarse_raycolor"],
                               **TOL)


def test_vox_table_with_duplicate_corners_on_card_matches_cpu(dev):
    """build_vox_table and query_vox_grid on the card against the CPU,
    exactly: a lattice with jittered duplicates of its points in shuffled
    order (the highest index holds a shared corner on both), points off
    the box, a mask, and samples on cell faces and outside."""
    from pointnerf_tpu_torch.ops import voxgrid
    rng = np.random.RandomState(0)
    cloud = rng.uniform(-0.4, 0.4, (4000, 3)).astype(np.float32)
    cloud[:, 2] *= 0.05
    lat, _ = voxgrid.construct_grid_points(cloud, 8, 32)
    mn, pitch, dims = voxgrid.derive_lattice(lat)
    spec = tgrid.GridSpec(
        ranges_min=(0.0,) * 3, scaled_vsize=(1.0,) * 3, vdim=(1, 1, 1),
        max_o=1, P=1, kernel_size=(1, 1, 1), query_size=(1, 1, 1),
        radius_limit=1.0, vsize=(1.0,) * 3,
        vox_dim=tuple(int(d) for d in dims),
        vox_space_min=tuple(float(v) for v in mn), vox_gvs=float(pitch))
    pick = rng.randint(0, len(lat), 3 * len(lat))
    dup = lat[pick] + rng.uniform(-0.45, 0.45, (len(pick), 3)) * pitch
    far = rng.uniform(-3, 3, (100, 3))
    xyz = np.concatenate([lat, dup, far]).astype(np.float32)
    xyz = xyz[rng.permutation(len(xyz))]
    mask = rng.rand(len(xyz)) < 0.9
    k = rng.randint(-1, dims + 1, (3000, 3))
    face = (mn + k * np.float32(pitch)).astype(np.float32)
    loc = np.concatenate([face, np.nextafter(face, np.float32(np.inf)),
                          rng.uniform(-1, 1, (3000, 3)).astype(np.float32)])
    loc = loc.reshape(1, -1, 3, 3)
    out = {}
    for device in ("cpu", dev):
        table = voxgrid.build_vox_table(torch.as_tensor(xyz, device=device),
                                        torch.as_tensor(mask, device=device),
                                        spec)
        out[str(device)] = (table.cpu(), voxgrid.query_vox_grid(
            torch.as_tensor(loc, device=device), table, spec).cpu())
    for a, b in zip(out["cpu"], out[str(dev)]):
        assert torch.equal(a, b)
    assert (out["cpu"][1] >= 0).all(-1).any()


def test_splat_on_card_equals_cpu(dev):
    """The viewer's splat (run/visualize.py) on the card equals the CPU's
    pixel for pixel: duplicate pixels resolved by the painter's rank, not
    by the scatter's write order."""
    from pointnerf_tpu_torch.run import visualize as vz
    rng = np.random.RandomState(1)
    xyz = rng.normal(size=(20000, 3)).astype(np.float32) * 0.5
    xyz[10000:] = xyz[:10000]            # copies: the same pixels and depths
    rgb = rng.uniform(size=(20000, 3)).astype(np.float32)
    center, radius = vz.frame_cloud(xyz)
    for az in (0.0, 2.0):
        c2w = vz.orbit_pose(center, radius, az)
        card = vz.splat_render(xyz, rgb, c2w, 128, 96, 110.0, 3, device=dev)
        host = vz.splat_render(xyz, rgb, c2w, 128, 96, 110.0, 3,
                               device="cpu")
        assert card.is_cuda
        assert torch.equal(card.cpu(), host)


def test_probnet_gen_points_on_card_matches_cpu(dev, tmp_path):
    """One ProbNet triplet (manual_depth_view -1, 64x64 plate scene, 16
    depth planes, pad 8) on the card against the CPU, cuDNN's TF32 off:
    the mass and the rows within TOL, keep masks equal away from
    dprob_thresh; under batch statistics ProbNet's parameter gradients of
    sum(conf) + 1e-3·sum(xyz) within GRAD_REL in norm (slice-tie pixels'
    conf weighted 0)."""
    from pointnerf_tpu_torch.data import create_dataset
    from pointnerf_tpu_torch.models.mvs import points_model as pm
    from pointnerf_tpu_torch.models.mvs.probnet import prob_moments
    opt = _plate_driver_opt(str(tmp_path)).replace(
        load_points=0, shading_feature_mlp_layer0=1, manual_depth_view=-1,
        depth_grid=16, pad=8, num_neighbor=3, dprob_thresh=0.188,
        near_plane=2.5, far_plane=3.5)
    sample = create_dataset(opt, "train").get_init_item(0)
    mvs = pm.MvsPoints(opt, torch.Generator().manual_seed(0), device="cpu")
    noise = [torch.randn(1, 32, 32, generator=torch.Generator()
                         .manual_seed(1))]
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        maps_c, maps_h = {}, {}
        card = pm.gen_points(copy.deepcopy(mvs).to(dev), opt, sample,
                             noise=noise, maps=maps_c)
        host = pm.gen_points(mvs, opt, sample, noise=noise, maps=maps_h)
        grads = []
        # the conf of pixels whose e·D lies within 1e-4 of an integer
        # weighted 0: the mass's slice jumps there
        stat = {}
        with torch.no_grad():
            pm.gen_points(mvs, opt, sample, noise=noise, maps=stat,
                          training=True)
        eD = prob_moments(stat["prob"][0])[0].reshape(-1) * 16
        w = ((eD - eD.round()).abs() >= 1e-4).float()[:, None]
        for net, d in ((copy.deepcopy(mvs).to(dev), dev), (mvs, "cpu")):
            net.probnet.requires_grad_(True)
            o = pm.gen_points(net, opt, sample, noise=noise, training=True)
            loss = (o["conf"] * w.to(d)).sum() + (o["xyz_w"] * 1e-3).sum()
            params = list(net.probnet.parameters())
            grads.append(torch.cat([g.reshape(-1).cpu() for g in
                                    torch.autograd.grad(loss, params)]))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    mass = maps_h["mass"][0].reshape(-1)
    torch.testing.assert_close(maps_c["mass"][0].cpu().reshape(-1), mass,
                               **TOL)
    away = (mass - opt.dprob_thresh).abs() > 1e-4
    assert torch.equal(card["keep"].cpu()[away], host["keep"][away])
    rows = host["keep"] & away & torch.all(maps_c["vis"][0].cpu()
                                           == maps_h["vis"][0], dim=-1)
    assert rows.any()
    for k in ("xyz_w", "embedding", "color", "dir", "conf"):
        torch.testing.assert_close(card[k].cpu()[rows], host[k][rows], **TOL)
    g_card, g_host = grads
    assert torch.isfinite(g_card).all() and g_card.abs().max() > 0
    assert float((g_card - g_host).norm() / g_host.norm()) <= GRAD_REL
