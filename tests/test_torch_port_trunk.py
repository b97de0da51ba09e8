"""Fused trunk parity: the port's fused_trunk (plain versions on CPU
tensors), forward and gradients, against the JAX Pallas kernel run in
interpret mode.

Tolerances: outputs rtol = atol = 1e-5, gradients rtol 2e-4, atol 2e-5: the
bars tests/test_pallas_trunk.py holds the Pallas kernel to against the XLA
composition (float32, summation order differs).
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
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
INPUTS = ("emb", "d", "ex3", "w")


def _cotangents(K, S, order1, seed=1):
    rng = np.random.RandomState(seed)
    cf = rng.normal(size=(S // K, 32)).astype(np.float32)
    ca = None if order1 else rng.normal(size=(S // K, 1)).astype(np.float32)
    return cf, ca


def _port_grads(L1, L3, K, act_super, order1, agg, ins, cf, ca):
    """Gradients of <feat, cf> + <alpha, ca> through the port's fused_trunk
    with respect to the four row inputs and every trunk operand."""
    xs = [torch.tensor(ins[k], requires_grad=True) for k in INPUTS]
    ops = tt.pack_trunk_params(agg, 8, 6, 2, 3, with_alpha=not order1)
    feat, alpha = tt.fused_trunk(L1, L3, 2, 3, K, act_super, order1, *xs, ops)
    loss = torch.sum(feat * torch.tensor(cf))
    if not order1:
        loss = loss + torch.sum(alpha * torch.tensor(ca))
    return torch.autograd.grad(loss, xs + ops)


def _setup(L1, L3, order, K, n_pts=37, seed=0):
    opt = Options(point_features_dim=8, num_feat_freqs=2, dist_xyz_freq=3,
                  num_viewdir_freqs=2, shading_feature_num=32,
                  shading_feature_mlp_layer1=L1, shading_feature_mlp_layer3=L3,
                  shading_alpha_mlp_layer=1, shading_color_mlp_layer=2,
                  agg_intrp_order=order, agg_dist_pers=20)
    params = init_aggregator_params(jax.random.PRNGKey(seed), opt)
    np_params = jax.tree.map(np.asarray, params)
    agg, _ = from_jax_params(np_params, {"xyz": np.zeros((1, 3), np.float32),
                                         "embedding": np.zeros((1, 8),
                                                               np.float32)},
                              device="cpu")
    rng = np.random.RandomState(seed)
    S = n_pts * K
    ins = dict(emb=rng.uniform(-0.5, 0.5, (S, 8)),
               d=rng.normal(0, 0.02, (S, 6)),
               ex3=rng.uniform(-1, 1, (S, 7)),
               w=rng.uniform(0, 1, (S, 1)) * (rng.rand(S, 1) < 0.7))
    ins = {k: v.astype(np.float32) for k, v in ins.items()}
    return opt, params, agg, ins


@pytest.mark.parametrize("K", [1, 8])
@pytest.mark.parametrize("L1,L3", [(1, 1), (2, 2), (1, 2)])
@pytest.mark.parametrize("order", [1, 2])
def test_fused_trunk_matches_pallas_interpret(K, L1, L3, order):
    opt, params, agg, ins = _setup(L1, L3, order, K)
    order1 = order == 1
    ops_j = jt.pack_trunk_params(params, 8, 6, 2, 3, with_alpha=not order1)
    want = jt.fused_trunk(L1, L3, 2, 3, K, True, 32, True, False, order1,
                          *(jnp.asarray(ins[k]) for k in ("emb", "d", "ex3",
                                                          "w")), ops_j)
    ops_t = tt.pack_trunk_params(agg, 8, 6, 2, 3, with_alpha=not order1)
    for a, b in zip(ops_t, ops_j):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    with torch.inference_mode():
        got = tt.fused_trunk(L1, L3, 2, 3, K, True, order1,
                             *(torch.as_tensor(ins[k]) for k in ("emb", "d",
                                                                 "ex3", "w")),
                             ops_t)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    if order1:
        assert got[1] is None and want[1] is None
    else:
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)


def test_packed_first_layers_join_without_copy():
    """The kernel reads block1's and block3's first weights whole: the split
    pieces pack_trunk_params returns join back into the transposed weight
    in place; pieces cut from separate buffers are refused."""
    _, _, agg, _ = _setup(2, 2, 2, 8)
    ops = tt.pack_trunk_params(agg, 8, 6, 2, 3)
    for pieces, lin in ((ops[0:3], agg.block1[0]), (ops[6:8], agg.block3[0])):
        whole = tt._joined(*pieces)
        assert whole.data_ptr() == pieces[0].data_ptr()
        assert torch.equal(whole, lin.weight.detach().t())
    with pytest.raises(ValueError, match="consecutive row blocks"):
        tt._joined(*(p.clone() for p in ops[0:3]))


def test_fused_trunk_relu_head_and_no_grad():
    """act_super off (relu alpha head): the forward without autograd, then
    the gradient of emb, both against JAX; on CPU tensors neither kernel
    launches."""
    opt, params, agg, ins = _setup(2, 2, 2, 8, seed=3)
    ops_j = jt.pack_trunk_params(params, 8, 6, 2, 3)
    jargs = [jnp.asarray(ins[k]) for k in INPUTS]
    want = jt.fused_trunk(2, 2, 2, 3, 8, False, 32, True, False, False,
                          *jargs, ops_j)
    ops_t = [o.detach() for o in tt.pack_trunk_params(agg, 8, 6, 2, 3)]
    args = [torch.as_tensor(ins[k]) for k in INPUTS]
    with torch.no_grad():
        got = tt.fused_trunk(2, 2, 2, 3, 8, False, False, *args, ops_t)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)
    gj = jax.grad(lambda e: jnp.sum(jt.fused_trunk(
        2, 2, 2, 3, 8, False, 32, True, False, False, e, *jargs[1:],
        ops_j)[1]))(jargs[0])
    args[0].requires_grad_(True)
    alpha = tt.fused_trunk(2, 2, 2, 3, 8, False, False, *args, ops_t)[1]
    (ge,) = torch.autograd.grad(alpha.sum(), args[0])
    np.testing.assert_allclose(ge.numpy(), np.asarray(gj), **GRAD_TOL)
    assert kernels.TRUNK_FWD.launches == kernels.TRUNK_BWD.launches == 0


@pytest.mark.parametrize("act_super", [True, False])
@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("L1,L3", [(1, 1), (2, 2), (1, 2)])
@pytest.mark.parametrize("K", [1, 8])
def test_fused_trunk_grads_match_pallas_interpret(K, L1, L3, order,
                                                  act_super):
    """FusedTrunk's backward (fused_trunk_bwd_reference on CPU tensors)
    against jax.grad through the Pallas kernel's custom VJP, for the row
    inputs and every operand; PE constants get no gradient on either
    side."""
    _, params, agg, ins = _setup(L1, L3, order, K)
    order1 = order == 1
    cf, ca = _cotangents(K, ins["emb"].shape[0], order1)

    def f(emb, d, ex3, w, ops):
        feat, alpha = jt.fused_trunk(L1, L3, 2, 3, K, act_super, 16 * K, True,
                                     False, order1, emb, d, ex3, w, ops)
        loss = jnp.sum(feat * cf)
        return loss if order1 else loss + jnp.sum(alpha * ca)

    ops_j = jt.pack_trunk_params(params, 8, 6, 2, 3, with_alpha=not order1)
    want = jax.grad(f, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(ins[k]) for k in INPUTS), ops_j)
    got = _port_grads(L1, L3, K, act_super, order1, agg, ins, cf, ca)
    want = list(want[:4]) + list(want[4])
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=str(i),
                                   **GRAD_TOL)


@pytest.mark.parametrize("K,order", [(1, 2), (8, 1), (8, 2)])
def test_trunk_bwd_reference_matches_autograd(K, order):
    """The plain backward equals torch.autograd through the plain forward;
    `trunk_bwd` on CPU tensors is that plain version (no launch)."""
    _, _, agg, ins = _setup(2, 2, order, K, seed=5)
    order1 = order == 1
    cf, ca = _cotangents(K, ins["emb"].shape[0], order1, seed=2)
    xs = [torch.tensor(ins[k], requires_grad=True) for k in INPUTS]
    ops = [o.detach().requires_grad_(True)
           for o in tt.pack_trunk_params(agg, 8, 6, 2, 3,
                                         with_alpha=not order1)]
    feat, alpha = tt.fused_trunk_reference(2, 2, 2, 3, K, True, order1, *xs,
                                           ops)
    loss = torch.sum(feat * torch.tensor(cf))
    if not order1:
        loss = loss + torch.sum(alpha * torch.tensor(ca))
    want = torch.autograd.grad(loss, xs + ops)
    args = (2, 2, 2, 3, K, True, order1, *(x.detach() for x in xs),
            [o.detach() for o in ops], torch.tensor(cf),
            None if order1 else torch.tensor(ca))
    got = tt.trunk_bwd(*args)
    for i, (a, b) in enumerate(zip(list(got[:4]) + list(got[4]), want)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6,
                                   msg=lambda m, i=i: f"output {i}: {m}")
    assert kernels.TRUNK_BWD.launches == 0
