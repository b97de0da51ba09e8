"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: without a CUDA device every test skips (the kernels have no
CPU mode). Run on a GPU machine, where JAX may be absent, with

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

K6 (the row scatter-add) is held at rtol = atol = 1e-4: its float atomics
sum duplicates in no fixed order. K7 (the row select) must equal its plain
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


def test_trunk_bwd_weight_grads_are_reproducible(dev):
    """No float atomics: two launches give bit-equal weight gradients."""
    args = _bwd_args(dev, 8, 2, 2, 2, True)
    first, second = tt.trunk_bwd(*args), tt.trunk_bwd(*args)
    for a, b in zip(first[4], second[4]):
        assert torch.equal(a, b)


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


def _render_card_vs_cpu(dev, **kw):
    """Render a small scene on the CPU and on the card with options `kw`;
    the card launches the forward kernels of the configuration (K4 with
    fused_shade, else K1) and K3, the CPU none, and the outputs agree."""
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


@pytest.mark.parametrize("C", [42, 7])
def test_scatter_rows_kernel_matches_plain(dev, C):
    """K6 with duplicate indices (each row drawn ~6 times) and skipped
    negative ones, against the plain version; an odd C takes the
    one-float path."""
    rng = np.random.RandomState(C)
    S, cap = 20_011, 3_001
    idx = rng.randint(0, cap // 6, S).astype(np.int32) * 6
    idx[rng.rand(S) < 0.3] = -1
    upd = rng.uniform(-1, 1, (S, C)).astype(np.float32)
    idx_t, upd_t = torch.as_tensor(idx, device=dev), \
        torch.as_tensor(upd, device=dev)
    before = kernels.SCATTER_ROWS.launches
    got = scatter_add_rows(idx_t, upd_t, cap)
    torch.cuda.synchronize()
    assert kernels.SCATTER_ROWS.launches == before + 1
    want = scatter_add_rows_reference(idx_t, upd_t, cap)
    torch.testing.assert_close(got, want, **TOL)
    ref = np.zeros((cap, C), np.float32)
    keep = idx >= 0
    np.add.at(ref, idx[keep], upd[keep])
    np.testing.assert_allclose(got.cpu().numpy(), ref, **TOL)


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


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("Rt", [8, 16, 32, 120])
def test_row_select_kernel_matches_plain(dev, dtype, Rt):
    """K7 equals its plain version for both row types, per-ray row sets and
    one row set shared by every ray (ray stride 0), ragged N against Rt."""
    g = torch.Generator().manual_seed(Rt)
    N, D, U, LW = 37, 50, 9, 128
    rows = (torch.rand(N, U, LW, generator=g) < 0.3).to(dtype).to(dev)
    rank = torch.randint(0, U, (N, D), generator=g, dtype=torch.int32)
    lane = torch.randint(0, LW, (N, D), generator=g, dtype=torch.int32)
    rank, lane = rank.to(dev), lane.to(dev)
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
