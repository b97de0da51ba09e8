"""The aggregator's shading envelopes against the JAX package: the distance
modes -1/1/2/10/30 and `dist_xyz_deno`, the learned kernels `sh_intrp` and
`gau_intrp` (with `ops/sh.py` and `ops/geometry.py`), order 0, `block2`
and bfloat16 products; the option sets both packages refuse.

Tolerances: forward rtol = atol = 1e-5, gradients rtol 2e-4, atol 2e-5
(ROADMAP §1's bars); sh and geometry 1e-6. The bfloat16 products are held
in two levels: `apply_mlp` / `apply_mlp_pieces` on the very same float32
operands at 1e-5 (both packages round the same values), and the whole
aggregator at BF16_REL × max |out|, because an operand that comes out of
the port's own float32 chain (a PE sine, a distance) may sit an ulp from
JAX's and round to the other bfloat16 neighbour. The learned kernels,
order 0, block2 and the bfloat16 aggregator are in
test_torch_port_envelope_learned.py; the train steps, the checkpoints and
the driver in test_torch_port_envelope_train.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointnerf_tpu.config import Options as JOptions
from pointnerf_tpu.models import aggregator as jagg
from pointnerf_tpu.models import networks as jnets
from pointnerf_tpu.ops import geometry as jgeo
from pointnerf_tpu.ops import sh as jsh
from pointnerf_tpu_torch.config import Options, nerf_synth_preset
from pointnerf_tpu_torch.models import aggregator as tagg
from pointnerf_tpu_torch.models import networks as tnets
from pointnerf_tpu_torch.ops import geometry as tgeo
from pointnerf_tpu_torch.ops import sh as tsh
from pointnerf_tpu_torch.run.workload import ENVELOPES, envelope_options
from pointnerf_tpu_torch.utils.checkpoint import _net_tensors, from_jax_params

from test_torch_port_train import GRAD_TOL, _np_tree

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
SH_TOL = dict(rtol=1e-6, atol=1e-6)
# bfloat16 aggregator and train step, port against JAX, relative to the
# largest entry. Measured on a CPU on this file's cases: decoded 1.4e-7,
# no output outside 1e-5; parameter gradients 5.6e-7, input gradients
# 1.5e-5; on test_torch_port_envelope_train.py's train step: loss items
# 1.4e-7, net gradients 2.8e-5, point gradients 1.2e-5. The bar is 7x the
# largest of them.
BF16_REL = 2e-4
BF16_SHARE = 1e-3      # share of decoded outputs allowed outside 1e-5
VSIZE = (0.004, 0.004, 0.004)
WIDE = 24                       # point channels: sh degree 4 reads 16


def _opt(**kw):
    base = dict(point_features_dim=WIDE, num_feat_freqs=2, dist_xyz_freq=3,
                num_viewdir_freqs=2, shading_feature_num=32,
                shading_feature_mlp_layer1=2, shading_feature_mlp_layer3=2,
                shading_alpha_mlp_layer=1, shading_color_mlp_layer=2,
                agg_intrp_order=2, agg_dist_pers=20, use_fused_trunk=0,
                vsize=VSIZE)
    return JOptions(**dict(base, **kw))


def _inputs(opt, seed=12, B=1, R=6, SR=4, K=8):
    """Aggregator inputs at the lego scale (neighbors within ~0.05 of
    their sample, an eighth of the vsize-scaled gaussians' reach), some
    confs outside the clamp, random unit ray directions."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.uniform(-1, 1, s).astype(np.float32)
    loc_w = f(B, R, SR, 3) * 0.1
    xyz = loc_w[..., None, :] + f(B, R, SR, K, 3) * 0.05
    campos = np.array([0.1, -0.2, -3.0], np.float32)
    rd = f(B, R, SR, 3)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    conf = f(B, R, SR, K, 1) * .6 + .5
    conf[..., ::3, :] = 1.4
    return dict(color=f(B, R, SR, K, 3) * .5 + .5,
                rw2c=np.eye(3, dtype=np.float32), dir=f(B, R, SR, K, 3),
                conf=conf,
                emb=f(B, R, SR, K, opt.point_features_dim),
                xyz_pers=(xyz - campos) * np.float32(1.3), xyz=xyz,
                mask=rng.rand(B, R, SR, K) < 0.8,
                loc=(loc_w - campos) * np.float32(1.3), loc_w=loc_w, rd=rd)


ORDER = ("color", "rw2c", "dir", "conf", "emb", "xyz_pers", "xyz", "mask",
         "loc", "loc_w", "rd")
DIFF = ("color", "dir", "conf", "emb", "xyz_pers", "xyz", "loc", "loc_w",
        "rd")


def _pair(opt, seed=3):
    params = jagg.init_aggregator_params(jax.random.PRNGKey(seed), opt)
    agg, _ = from_jax_params(jax.tree.map(np.asarray, params),
                             {"xyz": np.zeros((1, 3), np.float32),
                              "embedding": np.zeros(
                                  (1, opt.point_features_dim), np.float32)},
                             device="cpu")
    return params, agg


def _jax_run(params, opt, ins, ct, dtype=jnp.float32):
    """decoded etc. and the gradients of <decoded, ct> with respect to the
    parameters and every float input."""
    def f(p, *xs):
        a = dict(zip(DIFF, xs), rw2c=jnp.asarray(ins["rw2c"]),
                 mask=jnp.asarray(ins["mask"]))
        out = jagg.aggregator_forward(p, opt, *(a[k] for k in ORDER), VSIZE,
                                      compute_dtype=dtype)
        return jnp.sum(out[0] * ct), out
    (_, out), g = jax.value_and_grad(f, argnums=tuple(range(10)),
                                     has_aux=True)(
        params, *(jnp.asarray(ins[k]) for k in DIFF))
    return out, g[0], g[1:]


def _port_run(agg, opt, ins, ct):
    xs = {k: torch.tensor(v, requires_grad=k in DIFF) for k, v in ins.items()}
    out = tagg.aggregator_forward(agg, Options.from_json(opt.to_json()),
                                  *(xs[k] for k in ORDER), vsize=VSIZE)
    loss = torch.sum(out[0] * torch.tensor(ct))
    params = dict(agg.named_parameters())
    g = torch.autograd.grad(loss, list(params.values())
                            + [xs[k] for k in DIFF], allow_unused=True)
    gp = dict(zip(params, g[:len(params)]))
    return out, gp, g[len(params):]


def _check(opt, seed=3, fwd=FWD_TOL, grad=GRAD_TOL):
    params, agg = _pair(opt, seed)
    ins = _inputs(opt)
    ct = np.random.RandomState(7).normal(size=(1, 6, 4, 4)).astype(np.float32)
    want, jg, jx = _jax_run(params, opt, ins, ct)
    got, tg, tx = _port_run(agg, opt, ins, ct)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **fwd)
    for k, v in _net_tensors(_np_tree(jg)).items():
        np.testing.assert_allclose(tg[k].numpy(), v, err_msg=k, **grad)
    for name, a, b in zip(DIFF, tx, jx):
        a = np.zeros_like(np.asarray(b)) if a is None else a.numpy()
        np.testing.assert_allclose(a, np.asarray(b), err_msg=name, **grad)
    return want


# --------------------------------------------------------------- sh, geometry
def _unit_dirs(n=600, seed=0):
    d = np.random.RandomState(seed).normal(size=(n, 3))
    e = 1e-4
    poles = [[0, 0, 1], [0, 0, -1], [e, 0, 1], [0, -e, -1], [e, e, 1],
             [1e-7, -1e-7, -1], [1, 0, 0], [0, 1, 0]]
    d = np.concatenate([d, poles]).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("flip", [True, False])
@pytest.mark.parametrize("deg", range(1, 8))
def test_sh_basis_matches_jax(deg, flip):
    """The table (degrees ≤ 5; the recurrence past it) and the recurrence,
    on random unit directions, the poles and the near-poles, with the
    reference's classes."""
    d = _unit_dirs()
    for jf, tf in ((jsh.sh_basis, tsh.sh_basis),
                   (jsh.sh_basis_runtime, tsh.sh_basis_runtime)):
        want = np.asarray(jf(jnp.asarray(d), deg, flip_dir=flip))
        got = tf(torch.tensor(d), deg, flip_dir=flip).numpy()
        assert got.shape == (len(d), deg * deg)
        np.testing.assert_allclose(got, want, **SH_TOL)
    for jc, tc in ((jsh.SphericalHarm, tsh.SphericalHarm),
                   (jsh.SphericalHarmTable, tsh.SphericalHarmTable)):
        want = np.asarray(jc(deg).sh_all(jnp.asarray(d[None]), flip))
        np.testing.assert_allclose(tc(deg).sh_all(torch.tensor(d[None]),
                                                  flip).numpy(), want,
                                   **SH_TOL)


def test_geometry_matches_jax():
    rng = np.random.RandomState(1)
    rpy = rng.uniform(-np.pi, np.pi, (400, 3)).astype(np.float32)
    radii = rng.uniform(0.005, 0.08, (400, 3)).astype(np.float32)
    d = rng.normal(0, 0.05, (400, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tgeo.roll_pitch_yaw_to_rotation_matrices(torch.tensor(rpy)).numpy(),
        np.asarray(jgeo.roll_pitch_yaw_to_rotation_matrices(
            jnp.asarray(rpy))), **SH_TOL)
    want = np.asarray(jgeo.compute_world2local_dist(*map(jnp.asarray,
                                                         (d, radii, rpy))))
    got = tgeo.compute_world2local_dist(*map(torch.tensor, (d, radii, rpy)))
    assert got.shape == want.shape == (400, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, **SH_TOL)
    dirs = _unit_dirs()
    np.testing.assert_allclose(tgeo.vect2euler(torch.tensor(dirs)).numpy(),
                               np.asarray(jgeo.vect2euler(jnp.asarray(dirs))),
                               **SH_TOL)


# --------------------------------------------------------------- aggregator
FUSED_CASES = {
    "pers-1": dict(agg_dist_pers=-1), "pers1": dict(agg_dist_pers=1),
    "pers2": dict(agg_dist_pers=2), "pers10": dict(agg_dist_pers=10),
    "pers30": dict(agg_dist_pers=30), "deno": dict(dist_xyz_deno=1.0)}


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_distance_modes_match_jax(case):
    """The modes and dist_xyz_deno reach the fused trunk in both packages:
    JAX's Pallas kernel in interpret mode against K1/K2's plain versions;
    order 1 for mode 2 and deno, order 2 for the rest."""
    order = 1 if case in ("pers2", "deno") else 2
    _check(_opt(use_fused_trunk=1, agg_intrp_order=order,
                **FUSED_CASES[case]))


def test_distance_modes_unfused_match_jax():
    """Mode 30 and deno with block1 + block3 outside the kernel's envelope
    (one block layer, relu heads off): the plain composition."""
    _check(_opt(agg_dist_pers=30, dist_xyz_deno=0.5,
                shading_feature_mlp_layer1=1, num_feat_freqs=0))


# --------------------------------------------------------------- bfloat16
def test_bf16_products_match_jax_on_the_same_operands():
    """Both packages round the same float32 operands to bfloat16 and sum
    the exact products in float32: a 284-wide layer, whole and in three
    pieces, at 1e-5; torch's own bfloat16 product (rounded to bfloat16) is
    not. One layer: a second one would take the first's float32 outputs,
    which the two libraries sum in different orders, and an ulp there can
    flip a bfloat16 rounding (1.2e-3 on a [512, 256] output; the
    aggregator tests below hold that level)."""
    rng = np.random.RandomState(0)
    x = rng.normal(size=(512, 284)).astype(np.float32)
    jp = jnets.init_mlp(jax.random.PRNGKey(0), [284, 256], "LeakyReLU")
    agg = tagg.aggregator_from_layers(
        {"block1": [(np.asarray(l["w"]).T, np.asarray(l["b"])) for l in jp]})
    act = jnets.activation("LeakyReLU")
    want = np.asarray(jnets.apply_mlp(jp, jnp.asarray(x), act,
                                      compute_dtype=jnp.bfloat16))
    got = tnets.apply_mlp(agg.block1, torch.tensor(x), "bfloat16")
    np.testing.assert_allclose(got.detach().numpy(), want, **FWD_TOL)
    cuts = (0, 32, 224, 284)
    pieces = [x[:, a:b] for a, b in zip(cuts, cuts[1:])]
    want = np.asarray(jnets.apply_mlp_pieces(
        jp, [jnp.asarray(p) for p in pieces], act,
        compute_dtype=jnp.bfloat16))
    got = tnets.apply_mlp_pieces(agg.block1, [torch.tensor(p) for p in pieces],
                                 "bfloat16")
    np.testing.assert_allclose(got.detach().numpy(), want, **FWD_TOL)
    w = agg.block1[0].weight.detach()
    naive = (torch.tensor(x).bfloat16() @ w.t().bfloat16()).float() \
        + agg.block1[0].bias.detach()
    first = np.asarray(jnp.dot(jnp.asarray(x).astype(jnp.bfloat16),
                               jnp.asarray(jp[0]["w"]).astype(jnp.bfloat16),
                               preferred_element_type=jnp.float32))
    assert np.abs(naive.numpy() - first).max() > 1e-3
    with pytest.raises(ValueError, match="compute_dtype float16"):
        tnets.apply_mlp(agg.block1, torch.tensor(x), "float16")


def _rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


# --------------------------------------------------------------- refusals
JAX_FAULTS = {
    "order0-color1": dict(agg_intrp_order=0),
    "block2-featfreqs": dict(shading_feature_mlp_layer2=1),
    "feat-xyz-mode": dict(agg_feat_xyz_mode="1"),
    "alpha-xyz-mode": dict(agg_alpha_xyz_mode="1"),
    "color-xyz-mode": dict(agg_color_xyz_mode="1"),
    "sh-degree6": dict(agg_distance_kernel="sh_intrp", sh_degree=6,
                       point_features_dim=32),
    "feat_intrp": dict(agg_distance_kernel="feat_intrp"),
    "meta_intrp": dict(agg_distance_kernel="meta_intrp"),
}
NAMES = {"order0-color1": "agg_intrp_order", "block2-featfreqs":
         "shading_feature_mlp_layer2", "feat-xyz-mode": "agg_feat_xyz_mode",
         "alpha-xyz-mode": "agg_alpha_xyz_mode", "color-xyz-mode":
         "agg_color_xyz_mode", "sh-degree6": "sh_degree",
         "feat_intrp": "agg_distance_kernel",
         "meta_intrp": "agg_distance_kernel"}


@pytest.mark.parametrize("case", sorted(JAX_FAULTS))
def test_configurations_that_fail_in_both(case):
    """The JAX package fails on each (a shape or dtype error, an assertion,
    or its ValueError); the port raises ValueError naming the option, at
    init and at the forward."""
    opt = _opt(**JAX_FAULTS[case])
    ins = _inputs(opt)
    ct = np.zeros((1, 6, 4, 4), np.float32)
    with pytest.raises((TypeError, ValueError, AssertionError)):
        params = jagg.init_aggregator_params(jax.random.PRNGKey(0), opt)
        _jax_run(params, opt, ins, ct)
    topt = Options.from_json(opt.to_json())
    with pytest.raises(ValueError, match=NAMES[case]):
        tagg.init_aggregator_params(topt, device="cpu")
    _, agg = _pair(_opt())
    with pytest.raises(ValueError, match=NAMES[case]):
        tagg.aggregator_forward(agg, topt, *(torch.tensor(ins[k])
                                             for k in ORDER), vsize=VSIZE)


def test_feat_weight_mlp_is_refused():
    """A JAX pytree with the feat_intrp weight MLP does not load: that
    kernel raises in both packages."""
    params = jagg.init_aggregator_params(
        jax.random.PRNGKey(0), _opt(agg_distance_kernel="feat_intrp"))
    assert "feat_weight_mlp" in params
    with pytest.raises(ValueError, match="agg_distance_kernel feat_intrp"):
        from_jax_params(jax.tree.map(np.asarray, params),
                        {"xyz": np.zeros((1, 3), np.float32),
                         "embedding": np.zeros((1, WIDE), np.float32)},
                        device="cpu")


def test_envelope_options_switch_one_envelope_on():
    """run/workload.envelope_options: lego's options with one envelope on,
    each accepted by both packages' aggregator init."""
    lego = nerf_synth_preset("lego")
    for name in ENVELOPES:
        opt = envelope_options(name)
        diff = {k for k, v in vars(opt).items() if getattr(lego, k) != v}
        assert diff, name
        tagg.check_envelope(opt)
        jagg.init_aggregator_params(jax.random.PRNGKey(0),
                                    JOptions.from_json(opt.to_json()))
    with pytest.raises(KeyError):
        envelope_options("feat_intrp")
