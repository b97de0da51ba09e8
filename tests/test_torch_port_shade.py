"""Fused shade parity: the port's fused_shade (plain versions on CPU
tensors), forward and gradients, against the JAX Pallas kernel run in
interpret mode, and its plain backward against torch autograd through its
plain forward.

Inputs are seeded with numpy and shaped like the path's: neighbors within
a few voxels of their sample, validity a prefix of each K-group (some
groups all masked), confs across [-0.1, 1.3] so both clamp edges occur,
unit point and view directions, a random rotation.

Tolerances: outputs rtol = atol = 1e-5; gradients rtol 3e-4, atol 3e-5,
the bar tests/test_pallas_trunk.py holds the Pallas shade kernel to
(float32, summation order differs); plain backward against autograd
rtol = atol = 1e-5 (the same arithmetic, regrouped: dxyz sums the
distance and the weight paths, entries up to ~6, which cancel).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointnerf_tpu.config import Options
from pointnerf_tpu.models.aggregator import init_aggregator_params
from pointnerf_tpu.ops import pallas_trunk as jt
from pointnerf_tpu_torch.ops import kernels
from pointnerf_tpu_torch.ops import trunk as tt
from pointnerf_tpu_torch.utils.checkpoint import from_jax_params

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=3e-4, atol=3e-5)
FE, H, NF, ND = 8, 16, 2, 3
ROWS = ("emb", "xyz", "xyzp", "color", "pdir", "conf", "mask")
GROUPS = ("sl", "slw", "ovd")
DIFF = ("emb", "xyz", "xyzp", "color", "pdir", "conf")
CASES = [(order, mode, K, L) for order in (1, 2) for mode in (0, 20)
         for K in (1, 8) for L in (1, 2)]


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def shade_inputs(K, n_pts, seed=0):
    """Seeded numpy inputs of one fused_shade call: neighbor rows [S,*],
    group rows [S/K,3], RT [3,3]."""
    rng = np.random.RandomState(seed)
    S = n_pts * K
    up = lambda x: np.repeat(x, K, axis=0)
    slw = rng.uniform(-0.5, 0.5, (n_pts, 3))
    sl = np.concatenate([rng.uniform(-0.3, 0.3, (n_pts, 2)),
                         rng.uniform(2.0, 4.0, (n_pts, 1))], axis=1)
    valid = rng.randint(0, K + 1, n_pts) if K > 1 else rng.rand(n_pts) < 0.7
    valid[0] = 0                                  # one group all masked
    mask = (np.arange(S) % K < up(np.asarray(valid, np.int64))).astype(float)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    ins = dict(emb=rng.uniform(-0.5, 0.5, (S, FE)),
               xyz=up(slw) + rng.normal(0, 0.02, (S, 3)),
               xyzp=up(sl) + rng.normal(0, 0.01, (S, 3)),
               color=rng.uniform(0, 1, (S, 3)), pdir=_unit(rng, S),
               conf=rng.uniform(-0.1, 1.3, (S, 1)), mask=mask[:, None],
               sl=sl, slw=slw, ovd=_unit(rng, n_pts), RT=q)
    ins["conf"][1:3] = [[1.25], [-0.05]]        # past both clamp edges
    return {k: v.astype(np.float32) for k, v in ins.items()}


def _setup(order, mode, L, seed=0):
    opt = Options(point_features_dim=FE, num_feat_freqs=NF, dist_xyz_freq=ND,
                  num_viewdir_freqs=2, shading_feature_num=H,
                  shading_feature_mlp_layer1=L, shading_feature_mlp_layer3=L,
                  shading_alpha_mlp_layer=1, shading_color_mlp_layer=2,
                  agg_intrp_order=order, agg_dist_pers=mode)
    params = init_aggregator_params(jax.random.PRNGKey(seed), opt)
    agg, _ = from_jax_params(jax.tree.map(np.asarray, params),
                             {"xyz": np.zeros((1, 3), np.float32),
                              "embedding": np.zeros((1, FE), np.float32)},
                             device="cpu")
    return params, agg


def _cotangents(K, S, seed=1):
    rng = np.random.RandomState(seed)
    c = lambda *shape: rng.normal(size=shape).astype(np.float32)
    return c(S // K, H), c(S // K, 1), c(S, 1), c(S, 1)


@pytest.mark.parametrize("order,mode,K,L", CASES)
def test_fused_shade_matches_pallas_interpret(order, mode, K, L):
    """fused_shade_reference's four outputs against the Pallas kernel's,
    then FusedShade's gradients (fused_shade_bwd_reference on CPU tensors)
    against jax.grad through its custom VJP, with nonzero cotangents on all
    four outputs, for every differentiable input and every op."""
    order1 = order == 1
    params, agg = _setup(order, mode, L)
    ins = shade_inputs(K, 13)
    S = ins["emb"].shape[0]
    cf, ca, cw, cc = _cotangents(K, S)
    dd = tt.DIST_COLS[mode]
    ops_j = jt.pack_trunk_params(params, FE, dd, NF, ND,
                                 with_alpha=not order1)
    fixed = [jnp.asarray(ins[k]) for k in ("mask",) + GROUPS + ("RT",)]

    def jloss(emb, xyz, xyzp, color, pdir, conf, ops):
        out = jt.fused_shade(L, L, NF, ND, K, True, 16 * K, True, order1,
                             mode, emb, xyz, xyzp, color, pdir, conf, *fixed,
                             ops)
        loss = jnp.sum(out[0] * cf) + jnp.sum(out[2] * cw) \
            + jnp.sum(out[3] * cc)
        if not order1:
            loss = loss + jnp.sum(out[1] * ca)
        return loss, out

    (_, want), jgrads = jax.value_and_grad(
        jloss, argnums=tuple(range(7)), has_aux=True)(
            *(jnp.asarray(ins[k]) for k in DIFF), ops_j)

    ops_t = tt.pack_trunk_params(agg, FE, dd, NF, ND, with_alpha=not order1)
    args = [torch.tensor(ins[k], requires_grad=k in DIFF)
            for k in ROWS + GROUPS + ("RT",)]
    got = tt.fused_shade(L, L, NF, ND, K, True, order1, mode, *args, ops_t)
    assert (got[1] is None) == order1 == (want[1] is None)
    for i, (a, b) in enumerate(zip(got, want)):
        if b is not None:
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       err_msg=f"output {i}", **TOL)
    loss = torch.sum(got[0] * torch.tensor(cf)) \
        + torch.sum(got[2] * torch.tensor(cw)) \
        + torch.sum(got[3] * torch.tensor(cc))
    if not order1:
        loss = loss + torch.sum(got[1] * torch.tensor(ca))
    tgrads = torch.autograd.grad(loss, args[:len(DIFF)] + ops_t)
    jflat = list(jgrads[:6]) + list(jgrads[6])
    assert len(tgrads) == len(jflat)
    names = list(DIFF) + [f"op{i}" for i in range(len(ops_t))]
    for name, a, b in zip(names, tgrads, jflat):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **GRAD_TOL)
    assert kernels.SHADE_FWD.launches == kernels.SHADE_BWD.launches == 0


@pytest.mark.parametrize("order,mode,K,L", CASES)
def test_shade_bwd_reference_matches_autograd(order, mode, K, L):
    """The plain backward equals torch.autograd through the plain forward;
    `shade_bwd` on CPU tensors is that plain version (no launch)."""
    order1 = order == 1
    _, agg = _setup(order, mode, L, seed=5)
    ins = shade_inputs(K, 13, seed=3)
    S = ins["emb"].shape[0]
    cf, ca, cw, cc = (torch.tensor(c) for c in _cotangents(K, S, seed=2))
    xs = {k: torch.tensor(ins[k], requires_grad=k in DIFF)
          for k in ROWS + GROUPS + ("RT",)}
    ops = [o.detach().requires_grad_(True)
           for o in tt.pack_trunk_params(agg, FE, tt.DIST_COLS[mode], NF, ND,
                                         with_alpha=not order1)]
    cfg = (L, L, NF, ND, K, True, order1, mode)
    args = [xs[k] for k in ROWS + GROUPS + ("RT",)]
    feat, alpha, w_n, conf_c = tt.fused_shade_reference(*cfg, *args, ops)
    loss = torch.sum(feat * cf) + torch.sum(w_n * cw) + torch.sum(conf_c * cc)
    if not order1:
        loss = loss + torch.sum(alpha * ca)
    inputs = [xs[k] for k in DIFF] + ops
    want = [torch.zeros_like(x) if g is None else g for x, g in zip(
        inputs, torch.autograd.grad(loss, inputs, allow_unused=True))]
    got = tt.shade_bwd(*cfg, *(a.detach() for a in args),
                       [o.detach() for o in ops], cf,
                       None if order1 else ca, cw, cc)
    for i, (a, b) in enumerate(zip(list(got[:6]) + list(got[6]), want)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5,
                                   msg=lambda m, i=i: f"output {i}: {m}")
    assert kernels.SHADE_BWD.launches == 0


def test_fused_shade_ok_envelope():
    """The envelope follows the JAX fused_shade_ok on the presets and on
    each condition it adds to fused_trunk_ok."""
    from pointnerf_tpu_torch import config as tconfig
    for name, preset in tconfig.PRESETS.items():
        opt = preset()
        assert tt.fused_shade_ok(opt) == jt.fused_shade_ok(opt), name
    lego = tconfig.nerf_synth_preset("lego")
    assert tt.fused_shade_ok(lego)
    for kw in (dict(agg_distance_kernel="quadric"),
               dict(agg_axis_weight=(1.0, 0.5, 1.0)), dict(agg_weight_norm=0),
               dict(agg_dist_pers=10), dict(dist_xyz_deno=1.0),
               dict(point_conf_mode="0"), dict(act_type="ReLU")):
        bad = lego.replace(**kw)
        assert not tt.fused_shade_ok(bad) and not jt.fused_shade_ok(bad), kw
    assert tt.fused_shade_ok(lego.replace(agg_dist_pers=0))
