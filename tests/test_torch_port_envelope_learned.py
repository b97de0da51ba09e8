"""The aggregator's learned distance kernels (`sh_intrp`, `gau_intrp`),
order 0, `block2`, trunks without block1 or block3, and the bfloat16
aggregator against the JAX package, forward and gradients, at the bars
and with the helpers of test_torch_port_envelopes.py (forward 1e-5,
gradients rtol 2e-4 / atol 2e-5; bfloat16 at BF16_REL of the largest
entry)."""

import numpy as np
import jax.numpy as jnp
import pytest

from pointnerf_tpu_torch.ops import kernels
from pointnerf_tpu_torch.utils.checkpoint import _net_tensors

from test_torch_port_envelopes import (BF16_REL, BF16_SHARE, DIFF, FWD_TOL,
                                       _check, _inputs, _jax_run, _opt, _pair,
                                       _port_run, _rel_err)
from test_torch_port_train import _np_tree


@pytest.mark.parametrize("dist_func", ["sh_quadric", "sh_linear", "passfunc"])
@pytest.mark.parametrize("act", ["sigmoid", "tanh", "passfunc"])
def test_sh_intrp_matches_jax(act, dist_func):
    """Each lobe activation × distance falloff. The tanh and passfunc lobes
    are signed, so a shading point's weights can sum to near zero; there
    the normalised weights' gradient grows as 1/Σw² and magnifies the
    summation order (with agg_weight_norm 1, tanh × sh_quadric: one
    block1 weight gradient of 2,432 at 4.6e-4 relative, its size 1e8, in
    both packages alike). Those two run unnormalised, sigmoid normalised."""
    _check(_opt(agg_distance_kernel="sh_intrp", sh_degree=4, sh_act=act,
                sh_dist_func=dist_func,
                agg_weight_norm=int(act == "sigmoid")))


@pytest.mark.parametrize("norm", [0, 1])
def test_gau_intrp_matches_jax(norm):
    _check(_opt(agg_distance_kernel="gau_intrp", agg_weight_norm=norm))


@pytest.mark.parametrize("case", ["order0", "order0-block2", "block2",
                                  "block2x2-order1", "no-block1",
                                  "no-block3"])
def test_order0_and_block2_match_jax(case):
    """Order 0, block2, and a trunk without block1 (the concatenated pieces
    go on) or without block3 (no color or dir inputs)."""
    kw = {"order0": dict(agg_intrp_order=0, point_color_mode="0",
                         point_dir_mode="0"),
          "no-block1": dict(shading_feature_mlp_layer1=0),
          "no-block3": dict(shading_feature_mlp_layer3=0),
          "order0-block2": dict(agg_intrp_order=0, point_color_mode="0",
                                point_dir_mode="0",
                                shading_feature_mlp_layer2=1),
          "block2": dict(shading_feature_mlp_layer2=1, num_feat_freqs=0),
          "block2x2-order1": dict(shading_feature_mlp_layer2=2,
                                  num_feat_freqs=0, agg_intrp_order=1,
                                  agg_distance_kernel="sh_intrp")}[case]
    _check(_opt(**kw))


@pytest.mark.parametrize("case", ["lego", "sh_intrp-pers30"])
def test_bf16_aggregator_matches_jax(case):
    """The bfloat16 aggregator, forward and gradients, at BF16_REL of the
    largest entry; the share of outputs outside 1e-5 stays small. Under
    bfloat16 neither package runs the fused trunk."""
    kw = {"lego": {}, "sh_intrp-pers30": dict(agg_distance_kernel="sh_intrp",
                                              agg_dist_pers=30)}[case]
    opt = _opt(compute_dtype="bfloat16", use_fused_trunk=1, **kw)
    params, agg = _pair(opt)
    ins = _inputs(opt)
    ct = np.random.RandomState(7).normal(size=(1, 6, 4, 4)).astype(np.float32)
    want, jg, jx = _jax_run(params, opt, ins, ct, jnp.bfloat16)
    got, tg, tx = _port_run(agg, opt, ins, ct)
    dec = got[0].detach().numpy()
    assert _rel_err(dec, want[0]) < BF16_REL
    assert np.mean(np.abs(dec - np.asarray(want[0])) > 1e-5) < BF16_SHARE
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   **FWD_TOL)
    for k, v in _net_tensors(_np_tree(jg)).items():
        assert _rel_err(tg[k].numpy(), v) < BF16_REL, k
    for name, a, b in zip(DIFF, tx, jx):
        if a is not None:
            assert _rel_err(a.numpy(), b) < BF16_REL, name
    assert not any(k.launches for k in kernels.KERNELS)


