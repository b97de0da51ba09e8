"""The ProbNet point init (manual_depth_view -1) against the JAX package:
`models/mvs/probnet.py` piece by piece, gen_points' ProbNet branch with
JAX's draws injected, its gradients into every ProbNet parameter, the
finetune driver from it, dtu_gen steps with it and `{steps}_gen.npz`
carrying it, at JAX's own test shape (tests/test_mvs_pipeline.py::
test_gen_points_probnet_mode: 64x64 views, depth_grid 16, pad 8, 3 views).

Tolerances (ROADMAP's parity rules): forward 1e-5, relative to the largest
entry where a conv stack or the cost volume's E[x²] − E[x]² sums in
another order; gradients rtol 2e-4 / atol 2e-5; masks and indices
exactly, but for rows whose mass lies within the forward tolerance of
dprob_thresh (named tie). The weights are JAX's (BatchNorm statistics
randomised), carried across by `from_jax_mvs_params`.
"""

import copy
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointnerf_tpu.config import Options as JOptions
from pointnerf_tpu.data import create_dataset as jcreate
from pointnerf_tpu.models.mvs import nets as jnets
from pointnerf_tpu.models.mvs import points_model as jpm
from pointnerf_tpu.models.mvs import probnet as jpn
from pointnerf_tpu_torch.config import Options
from pointnerf_tpu_torch.models.mvs import points_model as tpm
from pointnerf_tpu_torch.models.mvs import probnet as tpn
from pointnerf_tpu_torch.utils.checkpoint import (_conv_keys, _up_keys,
                                                  from_jax_mvs_params)

from fixtures import make_nerf_synth_scene
from test_torch_port_generalizable import _jax_features
from test_torch_port_mvs import _rel_proj, mvs_params, n, t

REL = 1e-5                      # forward, relative to the largest entry
TOL = dict(rtol=1e-5, atol=1e-5)
GTOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(scope="module")
def scene64(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("probnet64"))
    make_nerf_synth_scene(root, wh=(64, 64), n_train=8, n_test=2)
    return root


def probnet_options(root, **kw):
    """JAX's test_gen_points_probnet_mode options (both packages)."""
    base = dict(
        data_root=root, scan="plate", dataset_name="nerf_synth360_ft",
        img_wh=(64, 64), near_plane=2.0, far_plane=4.5, bg_color="white",
        manual_depth_view=-1, init_view_num=3, depth_vid="0",
        depth_grid=16, pad=8, num_neighbor=3, dprob_thresh=0.05,
        num_each_depth=1,
        appr_feature_str0=("imgfeat_0_0123", "dir_0", "point_conf"),
        point_features_dim=32, shading_feature_mlp_layer0=1, full_comb=1)
    base.update(kw)
    return JOptions(**base), Options(**base)


def probnet_params(jopt):
    """mvs_params (BatchNorm statistics randomised) but for ProbNet, whose
    BatchNorm keeps JAX's init (mean 0, var 1): randomised, its eval-mode
    prob head is dead (ReLU 0 everywhere, a uniform softmax)."""
    p, _ = mvs_params(jopt)
    fresh = jpm.init_mvs_points_params(jax.random.PRNGKey(0), jopt)
    p["probnet"] = jax.tree.map(np.asarray, fresh["probnet"])
    topt = Options.from_json(jopt.to_json())
    return p, from_jax_mvs_params(p, topt, device="cpu")


def close_rel(got, want, rel=REL, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                1e-30)
    assert err <= rel, (what, err)


def _sample(root, jopt):
    return jcreate(jopt, split="train").get_init_item(0)


def _jax_inputs(p, sample):
    """The JAX FPN's coarsest features and the imgs of a bundle."""
    imgs = jnp.asarray(sample["mvs_images"])
    feats = jnets.fpn_featurenet(p["featurenet"], imgs, False)[-1]
    return imgs, feats


def _dvals(sample, D):
    nf = jnp.asarray(sample["near_fars"][0])
    return nf[0] + (nf[1] - nf[0]) * jnp.linspace(0.0, 1.0, D)


def test_resize_linear_matches_jax():
    """jax.image.resize(method="linear") (antialiased): the 4x downsample
    of the cost volume and other factors, up and down."""
    x = np.random.RandomState(0).rand(3, 3, 64, 64).astype(np.float32)
    for hw in ((16, 16), (20, 12), (64, 24), (96, 80)):
        want = jax.image.resize(jnp.asarray(x), (3, 3) + hw, method="linear")
        close_rel(n(tpn.resize_linear(t(x), hw)), want, what=hw)


def test_homo_warp_pad_matches_jax():
    """The padded warp (align_corners=True) and its strict in-bounds mask,
    at random relative projections and at the identity."""
    rng = np.random.RandomState(3)
    src = rng.randn(5, 16, 20).astype(np.float32)
    dv = np.linspace(2.0, 4.5, 16).astype(np.float32)
    K = np.array([[20.0, 0, 10], [0, 20.0, 8], [0, 0, 1]], np.float32)
    projs = [np.eye(4, dtype=np.float32)[:3]] + \
        [p[:3] for p in _rel_proj(3, K, rng)[1:]]
    for proj in projs:
        wv, wm = jpn.homo_warp_pad(jnp.asarray(src), jnp.asarray(proj),
                                   jnp.asarray(dv), 8)
        gv, gm = tpn.homo_warp_pad(t(src), t(proj), t(dv), 8)
        np.testing.assert_array_equal(n(gm), np.asarray(wm))
        np.testing.assert_allclose(n(gv), np.asarray(wv), **TOL)
    # the identity reproduces the source on the unpadded interior
    gv, _ = tpn.homo_warp_pad(t(src), t(projs[0]), t(dv), 8)
    np.testing.assert_allclose(n(gv)[:, 3, 8:-8, 8:-8], src, **TOL)


def test_cost_volume_matches_jax(scene64):
    """build_volume_costvar_img on a bundle's images, JAX's FPN features
    and projections: the RGB blocks at 1e-5, the variance E[x²] − E[x]²
    relative to its largest entry."""
    jopt, _ = probnet_options(scene64)
    p, _ = probnet_params(jopt)
    sample = _sample(scene64, jopt)
    imgs, feats = _jax_inputs(p, sample)
    dv = _dvals(sample, 16)
    proj = np.asarray(sample["proj_mats"][0])
    want = np.asarray(jpn.build_volume_costvar_img(
        imgs, feats, jnp.asarray(proj), dv, 8, 0))
    got = n(tpn.build_volume_costvar_img(t(imgs), t(feats), t(proj), t(dv),
                                         8, 0))
    assert got.shape == (41, 16, 32, 32)
    np.testing.assert_allclose(got[:9], want[:9], **TOL)
    close_rel(got[9:], want[9:], what="variance")


@pytest.mark.parametrize("training", [False, True])
def test_unet_and_probnet_forward_match_jax(scene64, training):
    """mvsnerf_costreg under eval BatchNorm and on batch statistics, then
    probnet_forward (cost volume, U-Net, prob head, softmax)."""
    jopt, topt = probnet_options(scene64)
    p, mvs = probnet_params(jopt)
    x = np.random.RandomState(4).randn(1, 41, 16, 32, 32).astype(np.float32)
    want = jpn.mvsnerf_costreg(p["probnet"]["costreg"], jnp.asarray(x),
                               training)
    got = mvs.probnet.costreg(t(x), batch_stats=training)
    close_rel(n(got), want, what="costreg")
    sample = _sample(scene64, jopt)
    imgs, feats = _jax_inputs(p, sample)
    dv = _dvals(sample, 16)
    proj = np.asarray(sample["proj_mats"][0])
    want = jpn.probnet_forward(p["probnet"], imgs, feats, jnp.asarray(proj),
                               dv, 8, 0, training)
    got = tpn.probnet_forward(mvs.probnet, t(imgs), t(feats), t(proj), t(dv),
                              8, 0, training)
    np.testing.assert_allclose(n(got), np.asarray(want), **TOL)


def test_prob_moments_and_mass_match_jax():
    """prob_moments at 1e-5; prob_filter_mass's slice index floor(e·D)
    exactly, and its mass, over random volumes and pixels whose e·D is an
    integer (two equal halves on neighbouring slices)."""
    rng = np.random.RandomState(5)
    D, h, w = 16, 9, 11
    logits = rng.randn(D, h, w).astype(np.float32) * 3
    prob = np.exp(logits) / np.exp(logits).sum(0, keepdims=True)
    prob = prob.astype(np.float32)
    for i in range(8):                      # e·D = i + 1 exactly
        prob[:, 0, i] = 0.0
        prob[i, 0, i] = prob[i + 1, 0, i] = 0.5
    prob[:, 1, 0] = 0.0
    prob[D - 1, 1, 0] = 1.0                 # the last slice: clipped window
    je, js = jpn.prob_moments(jnp.asarray(prob))
    te, ts = tpn.prob_moments(t(prob))
    np.testing.assert_allclose(n(te), np.asarray(je), **TOL)
    np.testing.assert_allclose(n(ts), np.asarray(js), **TOL)
    np.testing.assert_array_equal(n(te)[0, :8] * D, np.arange(1, 9))
    np.testing.assert_array_equal(np.floor(n(te) * D),
                                  np.floor(np.asarray(je) * D))
    for nn_ in (1, 3, 4):
        want = jpn.prob_filter_mass(jnp.asarray(prob), je, nn_)
        got = tpn.prob_filter_mass(t(prob), te, nn_)
        np.testing.assert_allclose(n(got), np.asarray(want), **TOL)


def _jax_noise(jopt, key, hp, wp):
    """JAX's draws in _gen_points_probnet: per depth view
    normal(split(key)[1], (num_each_depth, hp, wp))."""
    out = []
    for _ in str(jopt.depth_vid):
        key, sub = jax.random.split(key)
        out.append(t(jax.random.normal(sub, (jopt.num_each_depth, hp, wp))))
    return out


def _edge_rows(xyz_w, sample, H=64, W=64, eps=1e-3):
    """Rows whose projection into a view lies within eps pixels of its
    edge (0 or W−1, 0 or H−1): in or out of bounds by rounding, so their
    sampled features are all or nothing (named tie, as the MVS tests'
    image-border rows)."""
    hom = np.concatenate([xyz_w, np.ones_like(xyz_w[:, :1])], -1)
    edge = np.zeros(len(xyz_w), bool)
    for K, w2c in zip(sample["intrinsics"], sample["w2cs"]):
        cam = hom @ np.asarray(w2c, np.float64).T
        pix = cam[:, :3] / cam[:, 2:3] @ np.asarray(K, np.float64).T
        for c, hi in ((pix[:, 0], W - 1), (pix[:, 1], H - 1)):
            edge |= (np.abs(c) < eps) | (np.abs(c - hi) < eps)
    return edge


GEN_CASES = {   # num_each_depth, BatchNorm, a dprob_thresh that keeps a part
    "eval": dict(num=1, training=False, thresh=0.188),
    "batch-stats": dict(num=2, training=True, thresh=0.2),
}


@pytest.mark.parametrize("case", list(GEN_CASES))
def test_gen_points_matches_jax(scene64, case):
    """gen_points' ProbNet branch with JAX's draws and JAX's FPN feature
    values (`_jax_features`: on batch statistics JAX's float32 FPN is
    further off float64 than 1e-5, test_torch_port_gen_train.py): keep
    exactly (but for rows whose mass lies within 1e-5 of dprob_thresh),
    xyz, embedding, color, dir and conf at 1e-5 on the kept rows but
    those on a view's edge (`_edge_rows`);
    (16 + 2·8)² points a sample on the padded feature grid."""
    num, training, thresh = (GEN_CASES[case][k]
                             for k in ("num", "training", "thresh"))
    jopt, topt = probnet_options(scene64, num_each_depth=num,
                                 dprob_thresh=thresh)
    p, mvs = probnet_params(jopt)
    sample = _sample(scene64, jopt)
    key = jax.random.PRNGKey(1)
    want = {k: np.asarray(v) for k, v in jpm.gen_points(
        p, jopt, sample, key, training=training).items()}
    maps, stats = {}, {}
    feats = [np.asarray(f) for f in jnets.fpn_featurenet(
        p["featurenet"], jnp.asarray(sample["mvs_images"]), training)]
    with torch.no_grad(), _jax_features(SimpleNamespace(mvs=mvs), feats):
        got = {k: n(v) for k, v in tpm.gen_points(
            mvs, topt, sample, noise=_jax_noise(jopt, key, 32, 32),
            maps=maps, stats=stats, training=training).items()}
    assert got["xyz_w"].shape == (num * 32 * 32, 3)
    mass = np.tile(n(maps["mass"][0]).reshape(-1), num)
    tie = np.abs(mass - thresh) <= REL
    assert tie.mean() < 0.01
    np.testing.assert_array_equal(got["keep"][~tie], want["keep"][~tie])
    keep = want["keep"].astype(bool) & ~tie
    assert 0.05 < keep.mean() < 0.95
    keep &= ~_edge_rows(want["xyz_w"], sample)
    for k in ("xyz_w", "embedding", "color", "dir", "conf"):
        np.testing.assert_allclose(got[k][keep], want[k][keep], err_msg=k,
                                   **TOL)
    assert set(stats) >= {"cost_s", "unet_s", "filter_s", "embed_s"}


def test_gen_points_gradients_match_jax(scene64):
    """d(sum(conf) + 1e-3·sum(xyz_w))/d(every ProbNet parameter) through
    gen_points under eval BatchNorm (JAX's own test's loss) at rtol 2e-4 /
    atol 2e-5 against jax.grad; finite, one nonzero. Named tie: the conf
    of pixels whose e·D lies within 1e-4 of an integer is weighted 0 (the
    mass's slice floor(e·D) jumps there; near-uniform prob volumes put
    e·D at D/2 on a quarter of the pixels)."""
    num = 1
    jopt, topt = probnet_options(scene64)
    p, mvs = probnet_params(jopt)
    sample = _sample(scene64, jopt)
    key = jax.random.PRNGKey(1)
    imgs = jnp.asarray(sample["mvs_images"])
    feats = jnets.fpn_featurenet(p["featurenet"], imgs, False)[-1]
    e, _ = jpn.prob_moments(jpn.probnet_forward(
        p["probnet"], imgs, feats, jnp.asarray(sample["proj_mats"][0]),
        _dvals(sample, 16), 8, 0))
    eD = np.asarray(e).reshape(-1) * 16
    w = np.tile(np.abs(eD - np.round(eD)) >= 1e-4, num)
    w = w.astype(np.float32)[:, None]
    assert w.mean() > 0.5

    def f(pp):
        o = jpm.gen_points(dict(p, probnet=pp), jopt, sample, key)
        return jnp.sum(o["conf"] * w) + jnp.sum(o["xyz_w"] * 1e-3)

    jflat = {}
    grads = jax.jit(jax.grad(f))(p["probnet"])   # one compile, not per op
    _conv_keys(jax.tree.map(np.asarray, grads), "probnet.", jflat)
    want = _up_keys(jflat)
    mvs.probnet.requires_grad_(True)
    o = tpm.gen_points(mvs, topt, sample, noise=_jax_noise(jopt, key, 32, 32))
    loss = (o["conf"] * t(w)).sum() + (o["xyz_w"] * 1e-3).sum()
    names, params = zip(*mvs.probnet.named_parameters())
    grads = torch.autograd.grad(loss, params)
    assert len(names) == 3 * 11     # 11 convs, each BatchNorm's scale, bias
    for k, g in zip(names, grads):
        assert np.isfinite(n(g)).all(), k
        np.testing.assert_allclose(n(g), want["probnet." + k], err_msg=k,
                                   **GTOL)
    assert max(float(g.abs().max()) for g in grads) > 0


def _prob_grads(net, x, cot, dtype):
    m = copy.deepcopy(net).to(dtype).requires_grad_(True)
    pr = tpn.prob_volume(m, torch.as_tensor(x, dtype=dtype), True)
    names, params = zip(*m.named_parameters())
    grads = torch.autograd.grad((pr * torch.as_tensor(cot, dtype=dtype))
                                .sum(), params)
    return {k: g.double().numpy() for k, g in zip(names, grads)}


def _jax_prob_grads(p, x, cot):
    def f(pp):
        vol = jpn.mvsnerf_costreg(pp["costreg"], jnp.asarray(x)[None], True)
        logits = jnets.cbr(pp["prob"], vol, 1, 1, True, dims=3)[0, 0]
        return jnp.sum(jax.nn.softmax(logits, axis=0) * cot)
    flat = {}
    _conv_keys(jax.tree.map(np.asarray, jax.grad(f)(p)), "probnet.", flat)
    return {k[len("probnet."):]: v for k, v in _up_keys(flat).items()}


def test_probnet_batch_statistics_gradients(scene64):
    """ProbNet on batch statistics (dtu_gen trains it so): the prob
    volume's parameter gradients for a random cotangent, on a random input
    and on a bundle's cost volume (its padded and background voxels
    constant), against jax.grad within 2e-4 of its largest entry (the
    gradients are ~10: an atol of 2e-5 is a relative 2e-6), and on the
    cost volume against the port's float64 within 2e-5."""
    jopt, topt = probnet_options(scene64)
    p, mvs = probnet_params(jopt)
    rng = np.random.RandomState(6)
    sample = _sample(scene64, jopt)
    imgs, feats = _jax_inputs(p, sample)
    cost = n(tpn.build_volume_costvar_img(
        t(imgs), t(feats), t(sample["proj_mats"][0]),
        t(_dvals(sample, 16)), 8, 0))
    cot = rng.randn(16, 32, 32).astype(np.float32)
    for x in (rng.randn(41, 16, 32, 32).astype(np.float32), cost):
        want = _jax_prob_grads(p["probnet"], x, cot)
        got = _prob_grads(mvs.probnet, x, cot, torch.float32)
        for k, g in got.items():
            close_rel(g, want[k], GTOL["rtol"], k)
    f64 = _prob_grads(mvs.probnet, cost, cot, torch.float64)
    for k, g in got.items():
        close_rel(g, f64[k], 2e-5, k)


def test_unet_shape_refusals(scene64):
    """A depth_grid or padded grid the U-Net cannot halve three times:
    the port's gen_points raises ValueError naming the option; JAX's
    probnet_forward (what its gen_points runs) fails inside the U-Net's
    skip sum."""
    for kw, name in ((dict(depth_grid=12), "depth_grid"), (dict(pad=6),
                                                           "pad")):
        jopt, topt = probnet_options(scene64, **kw)
        p, mvs = probnet_params(jopt)
        sample = _sample(scene64, jopt)
        imgs, feats = _jax_inputs(p, sample)
        with pytest.raises(TypeError, match="add got incompatible shapes"):
            jpn.probnet_forward(p["probnet"], imgs, feats,
                                jnp.asarray(sample["proj_mats"][0]),
                                _dvals(sample, jopt.depth_grid), jopt.pad, 0)
        with pytest.raises(ValueError, match=name):
            tpm.gen_points(mvs, topt, sample)


def test_mvs_points_carry_jax_probnet(scene64):
    """from_jax_mvs_params carries every ProbNet leaf (transposed-conv
    blocks renamed), and the port's own init has JAX's widths."""
    jopt, topt = probnet_options(scene64)
    p, mvs = probnet_params(jopt)
    flat = {}
    _conv_keys(p["probnet"], "probnet.", flat)
    flat = _up_keys(flat)
    sd = {k: v for k, v in mvs.state_dict().items()
          if k.startswith("probnet.") and not k.endswith("tracked")}
    assert set(sd) == set(flat)
    for k, v in sd.items():
        np.testing.assert_array_equal(n(v), flat[k], err_msg=k)
    own = tpm.MvsPoints(topt, torch.Generator().manual_seed(0), device="cpu")
    for k, v in own.state_dict().items():
        if k in flat:
            assert tuple(v.shape) == flat[k].shape, k
