"""The MVS point init's pieces against the JAX package: resampling, the
nets, MVSNet, fusion, the visual hull, the z-buffered projection and the
embeddings (gen_points and the init bundles: test_torch_port_mvs_points.py).

Inputs are made with numpy from seeds; the JAX MVS parameters (BatchNorm
running statistics randomised) are carried across by
`utils.checkpoint.from_jax_mvs_params`. Tolerances: integers, masks,
point resampling and the init bundles exactly, except for the ties a test
names; the dense warp, fusion, projections and embeddings rtol = atol =
1e-5 (float32, another rounding of small products); conv stacks and MVSNet
(lax.conv against oneDNN, other summation orders through a 3D U-Net)
rtol = atol = 1e-4, the JAX package's own bound against torch
(tests/test_mvs_pipeline.py holds its mvsnet_forward to the reference at
1e-3 / 1e-4 / 1e-5).
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointnerf_tpu.config import Options as JOptions
from pointnerf_tpu.models.mvs import fusion as jfusion
from pointnerf_tpu.models.mvs import mvsnet as jmvsnet
from pointnerf_tpu.models.mvs import nets as jnets
from pointnerf_tpu.models.mvs import points_model as jpm
from pointnerf_tpu.ops import interp as jinterp
from pointnerf_tpu.run import common as jcommon
from pointnerf_tpu_torch.config import Options
from pointnerf_tpu_torch.models.mvs import fusion as tfusion
from pointnerf_tpu_torch.models.mvs import mvsnet as tmvsnet
from pointnerf_tpu_torch.models.mvs import nets as tnets
from pointnerf_tpu_torch.models.mvs import points_model as tpm
from pointnerf_tpu_torch.ops import interp as tinterp
from pointnerf_tpu_torch.run import common as tcommon
from pointnerf_tpu_torch.utils.checkpoint import from_jax_mvs_params

TOL = dict(rtol=1e-5, atol=1e-5)
NET_TOL = dict(rtol=1e-4, atol=1e-4)


def t(a):
    return torch.as_tensor(np.array(a))


def n(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def randomize_bn(tree, rng):
    """Random running statistics, scale and bias in every BatchNorm of a
    JAX MVS tree (numpy leaves)."""
    if isinstance(tree, list):
        return [randomize_bn(x, rng) for x in tree]
    if not isinstance(tree, dict):
        return np.asarray(tree)
    if set(tree) == {"scale", "bias", "mean", "var"}:
        c = np.asarray(tree["scale"]).shape[0]
        return {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                "bias": rng.normal(0, 0.1, c).astype(np.float32),
                "mean": rng.normal(0, 0.1, c).astype(np.float32),
                "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    return {k: randomize_bn(v, rng) for k, v in tree.items()}


def mvs_options(**kw):
    base = dict(point_features_dim=32, shading_feature_mlp_layer0=1,
                manual_depth_view=1, init_view_num=3, depth_vid="0",
                depth_grid=16, manual_std_depth=0.0, num_each_depth=1,
                appr_feature_str0=("imgfeat_0_0123", "dir_0", "point_conf"),
                depth_conf_thresh=0.1, geo_cnsst_num=0, depth_occ=1)
    base.update(kw)
    return JOptions(**base), Options(**base)


def mvs_params(jopt, seed=0):
    """JAX MVS params with randomised BatchNorm, and the port's nets."""
    p = jpm.init_mvs_points_params(jax.random.PRNGKey(seed), jopt)
    p = randomize_bn(jax.tree.map(np.asarray, p), np.random.RandomState(seed))
    topt = Options.from_json(jopt.to_json())
    return p, from_jax_mvs_params(p, topt, device="cpu")


# ------------------------------------------------------------------ interp
@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("padding", ["zeros", "border"])
def test_grid_sample_2d_matches_jax(align, padding):
    """Bit for bit (JAX's taps and weight products, op by op), out-of-range
    taps included: grid points up to 1.4 past the edges and exactly on
    them; `sample_channels_first` (F.grid_sample) at TOL."""
    rng = np.random.RandomState(1)
    feat = rng.randn(4, 7, 9).astype(np.float32)
    grid = rng.uniform(-1.4, 1.4, (5, 11, 2)).astype(np.float32)
    grid[0, :4] = [[-1, -1], [1, 1], [-1, 1], [1.0, 0.3]]
    want = jinterp.grid_sample_2d(jnp.asarray(feat), jnp.asarray(grid),
                                  align_corners=align, padding_mode=padding)
    got = tinterp.grid_sample_2d(t(feat), t(grid), align_corners=align,
                                 padding_mode=padding)
    assert got.shape == (5, 11, 4)
    np.testing.assert_array_equal(n(got), n(want))
    dense = tinterp.sample_channels_first(t(feat), t(grid), align, padding)
    np.testing.assert_allclose(n(dense.movedim(0, -1)), n(want), **TOL)


def test_resize_and_upsample_match_jax():
    rng = np.random.RandomState(2)
    x = rng.randn(3, 6, 10).astype(np.float32)
    np.testing.assert_array_equal(
        n(tinterp.resize_nearest(t(x), (24, 40))),
        n(jinterp.resize_nearest(jnp.asarray(x), (24, 40))))
    np.testing.assert_allclose(n(tinterp.upsample2x_bilinear_ac(t(x))),
                               n(jinterp.upsample2x_bilinear_ac(
                                   jnp.asarray(x))), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------ nets
@pytest.mark.parametrize("net", ["ofcl", "costreg", "fpn"])
def test_nets_match_jax(net):
    """Each net in eval mode, BatchNorm from randomised running stats."""
    jopt, _ = mvs_options()
    p, mvs = mvs_params(jopt)
    rng = np.random.RandomState(3)
    if net == "costreg":
        x = rng.rand(1, 32, 8, 8, 16).astype(np.float32)
        want = [jnets.costregnet(p["mvsnet"]["cost_regularization"],
                                 jnp.asarray(x))]
        got = [mvs.mvsnet.cost_regularization(t(x))]
    else:
        x = rng.rand(2, 3, 32, 48).astype(np.float32)
        if net == "ofcl":
            want = [jnets.ofcl_featurenet(p["mvsnet"]["feature"],
                                          jnp.asarray(x))]
            got = [mvs.mvsnet.feature(t(x))]
        else:
            want = jnets.fpn_featurenet(p["featurenet"], jnp.asarray(x))
            got = mvs.featurenet(t(x))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(n(g), n(w), **NET_TOL)


# ------------------------------------------------------------------ MVSNet
def _rel_proj(V, K, rng):
    """Relative projections src_proj @ inv(ref_proj) of V-1 small camera
    motions; view 0 the identity."""
    projs = [np.eye(4, dtype=np.float32)]
    for _ in range(V - 1):
        ang = rng.uniform(-0.15, 0.15)
        R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                      [-np.sin(ang), 0, np.cos(ang)]])
        E = np.eye(4)
        E[:3, :3] = R
        E[:3, 3] = rng.uniform(-0.2, 0.2, 3)
        A = np.eye(4)
        A[:3, :3] = K
        projs.append((A @ E @ np.linalg.inv(A)).astype(np.float32))
    return np.stack(projs)


def test_homo_warping_matches_jax():
    """A real relative projection, and the identity: JAX's identity warp is
    not the identity (it normalises by (W-1)/2 and samples with
    align_corners=False), and the port's must not be either."""
    rng = np.random.RandomState(4)
    feat = rng.randn(4, 8, 10).astype(np.float32)
    K = np.array([[20, 0, 5], [0, 20, 4], [0, 0, 1]], np.float64)
    depths = np.linspace(2, 6, 8).astype(np.float32)
    for proj in _rel_proj(2, K, rng):
        want = jmvsnet.homo_warping(jnp.asarray(feat), jnp.asarray(proj),
                                    jnp.asarray(depths))
        got = tmvsnet.homo_warping(t(feat), t(proj), t(depths))
        np.testing.assert_allclose(n(got), n(want), **TOL)
    ident = n(got) if np.allclose(proj, np.eye(4)) else n(
        tmvsnet.homo_warping(t(feat), t(np.eye(4, dtype=np.float32)),
                             t(depths)))
    assert np.abs(ident - feat[:, None]).max() > 0.3


def test_cost_variance_matches_jax():
    """The variance volume, built view by view (sums in JAX's view order),
    against JAX's mean over the stacked [V, C, D, h, w] warps: 7.2e-7 at
    most here (values up to 3.4; F.grid_sample rounds the tap weights in
    another order, and mean(x²) − mean(x)² cancels on small variances)."""
    rng = np.random.RandomState(5)
    feats = rng.randn(3, 32, 8, 16).astype(np.float32)
    proj = _rel_proj(3, np.array([[10.0, 0, 8], [0, 10.0, 4], [0, 0, 1]]),
                     rng)[:, :3]
    dvals = np.linspace(2.0, 6.0, 16).astype(np.float32)
    vols = jax.vmap(lambda f, p: jmvsnet.homo_warping(f, p, jnp.asarray(
        dvals)))(jnp.asarray(feats), jnp.asarray(proj))
    mean = jnp.mean(vols, axis=0)
    want = jnp.mean(jnp.square(vols), axis=0) - jnp.square(mean)
    got = tmvsnet.cost_variance(t(feats), t(proj), t(dvals))
    np.testing.assert_allclose(n(got), n(want), rtol=0, atol=1e-6)


def test_mvsnet_forward_matches_jax():
    """depth, conf and prob of MVSNet over 3 views, the reference view
    warped too; conf only away from the pixels whose regressed index lies
    within 1e-4 of an integer (it jumps there)."""
    jopt, _ = mvs_options()
    p, mvs = mvs_params(jopt)
    rng = np.random.RandomState(5)
    imgs = rng.rand(3, 3, 32, 64).astype(np.float32)
    proj = _rel_proj(3, np.array([[10.0, 0, 8], [0, 10.0, 4], [0, 0, 1]]),
                     rng)[:, :3]
    dvals = np.linspace(2.0, 6.0, 16).astype(np.float32)
    jd, jc, jp = jmvsnet.mvsnet_forward(p["mvsnet"], jnp.asarray(imgs),
                                        jnp.asarray(proj), jnp.asarray(dvals))
    td, tc, tp = tmvsnet.mvsnet_forward(mvs.mvsnet, t(imgs), t(proj),
                                        t(dvals))
    np.testing.assert_allclose(n(tp), n(jp), **NET_TOL)
    np.testing.assert_allclose(n(td), n(jd), **NET_TOL)
    idx = n(tmvsnet.depth_index(tp))
    away = np.abs(idx - np.round(idx)) > 1e-4
    assert away.mean() > 0.9
    np.testing.assert_allclose(n(tc)[away], n(jc)[away], **NET_TOL)


# ------------------------------------------------------------------ fusion
def _plane_views(V=3, H=32, W=32, seed=6):
    """V cameras looking at the z = 0 plane, exact z-depth per pixel."""
    rng = np.random.RandomState(seed)
    K = np.array([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]], np.float32)
    Es, ds = [], []
    for v in range(V):
        campos = np.array([0.3 - 0.25 * v, 0.2 + 0.1 * v, 3.0 - 0.1 * v])
        fwd = -campos / np.linalg.norm(campos)
        right = np.cross(fwd, [0, 0, 1.0])
        right /= np.linalg.norm(right)
        R_c2w = np.stack([right, np.cross(fwd, right), fwd], axis=1)
        E = np.eye(4, dtype=np.float32)
        E[:3, :3] = R_c2w.T
        E[:3, 3] = -R_c2w.T @ campos
        px, py = np.meshgrid(np.arange(W, dtype=np.float32),
                             np.arange(H, dtype=np.float32))
        d_w = np.stack([(px - K[0, 2]) / K[0, 0], (py - K[1, 2]) / K[1, 1],
                        np.ones_like(px)], -1) @ R_c2w.T
        depth = (-campos[2] / d_w[..., 2]).astype(np.float32)
        depth *= 1 + rng.normal(0, 0.004, depth.shape).astype(np.float32)
        Es.append(E)
        ds.append(depth)
    return (np.stack(ds), np.tile(K[None], (V, 1, 1)), np.stack(Es),
            rng.rand(V, H, W).astype(np.float32),
            (rng.rand(V, H, W) > 0.1).astype(np.float32))


@pytest.mark.parametrize("geo_cnsst_num", [0, 2])
def test_filter_by_masks_matches_jax(geo_cnsst_num):
    args = _plane_views()
    want = jfusion.filter_by_masks(*map(jnp.asarray, args), 0.3,
                                   geo_cnsst_num)
    got = tfusion.filter_by_masks(*map(t, args), 0.3, geo_cnsst_num)
    np.testing.assert_allclose(n(got[0]), n(want[0]), **TOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(n(g), n(w))
    keep, geo = n(got[1]), n(got[3])
    assert 0.2 < keep.mean() < 0.9 and (geo == 2).mean() > 0.2


def test_reassign_conf_matches_jax():
    rng = np.random.RandomState(7)
    conf = rng.rand(4, 5).astype(np.float32)
    geo = rng.randint(0, 12, (4, 5)).astype(np.int32)
    np.testing.assert_allclose(
        n(tfusion.reassign_conf(t(conf), t(geo), 2)),
        n(jfusion.reassign_conf(jnp.asarray(conf), jnp.asarray(geo), 2)),
        **TOL)


def test_alpha_masking_matches_jax():
    """The hull's keep mask, exactly: points in and out of each view's
    frustum and silhouette, with and without ranges."""
    depths, K, E, _, _ = _plane_views(H=24, W=24)
    rng = np.random.RandomState(8)
    alphas = np.zeros((3, 24, 24), np.float32)
    alphas[:, 5:19, 4:20] = 1.0
    pts = rng.uniform(-1.2, 1.2, (3000, 3)).astype(np.float32)
    pts[:, 2] *= 0.3
    for ranges in (None, np.array([-0.8, -0.8, -0.2, 0.8, 0.8, 0.2])):
        want = n(jfusion.alpha_masking(jnp.asarray(pts), jnp.asarray(alphas),
                                       jnp.asarray(K), jnp.asarray(E),
                                       ranges))
        got = n(tfusion.alpha_masking(t(pts), t(alphas), t(K), t(E), ranges))
        np.testing.assert_array_equal(got, want)
        assert 0.02 < want.mean() < 0.9


# ------------------------------------------------------------------ embedding
def _occ_points(seed=9):
    """The JAX z-buffer test's scene: random points plus points behind them
    on shared lines of sight, so that the z-buffer rejects some."""
    rng = np.random.RandomState(seed)
    K = np.array([[25.0, 0, 14], [0, 25.0, 11], [0, 0, 1]], np.float32)
    ang = 0.15
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                   [-np.sin(ang), 0, np.cos(ang)]]
    w2c[:3, 3] = [0.1, -0.05, 0.2]
    pts = rng.uniform([-1.2, -1.0, 2.0], [1.2, 1.0, 6.0],
                      (400, 3)).astype(np.float32)
    near = pts[:150]
    far = near / near[:, 2:3] * (near[:, 2:3]
                                 + rng.uniform(0.3, 2.0, (150, 1)))
    pts = np.concatenate([pts, far.astype(np.float32)], 0)
    return K, w2c, pts


@pytest.mark.parametrize("occ", [0, 1])
@pytest.mark.parametrize("src", [True, False])
def test_homo_warp_nongrid_matches_jax(occ, src):
    """Grid at 1e-5, masks exactly, into another view and into the points'
    own camera (w2c None), with and without the z-buffer."""
    K, w2c, pts = _occ_points()
    c2w = np.eye(4, dtype=np.float32)
    jw = jpm.homo_warp_nongrid_occ if occ else jpm.homo_warp_nongrid
    tw = tpm.homo_warp_nongrid_occ if occ else tpm.homo_warp_nongrid
    E = w2c if src else None
    jg, jm = jw(jnp.asarray(c2w), None if E is None else jnp.asarray(E),
                jnp.asarray(K), jnp.asarray(pts), 24, 30)
    tg, tm = tw(t(c2w), None if E is None else t(E), t(K), t(pts), 24, 30)
    np.testing.assert_allclose(n(tg), n(jg), **TOL)
    np.testing.assert_array_equal(n(tm), n(jm))
    assert n(tm).sum() > 50
    if occ and src:
        assert n(tm).sum() < n(tw(t(c2w), t(w2c), t(K), t(pts), 24, 30,
                                  tolerate=1e9)[1]).sum()


def _feats_and_points(jparams, seed=10, N=500, H=32, W=40):
    rng = np.random.RandomState(seed)
    imgs = rng.rand(3, 3, H, W).astype(np.float32)
    img_feats = jnets.fpn_featurenet(jparams["featurenet"], jnp.asarray(imgs))
    K = np.array([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]], np.float32)
    c2ws, w2cs = [], []
    for v in range(3):
        ang = 0.12 * v
        E = np.eye(4, dtype=np.float32)
        E[:3, :3] = [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                     [-np.sin(ang), 0, np.cos(ang)]]
        E[:3, 3] = [0.1 * v, -0.05 * v, 0.1 * v]
        w2cs.append(E)
        c2ws.append(np.linalg.inv(E).astype(np.float32))
    pts = rng.uniform([-0.6, -0.5, 2.0], [0.6, 0.5, 4.0],
                      (N, 3)).astype(np.float32)
    pts[N // 2:] = pts[:N // 2] * 1.3
    conf = rng.rand(N, 1).astype(np.float32)
    return (imgs, img_feats, np.tile(K[None], (3, 1, 1)), np.stack(c2ws),
            np.stack(w2cs), pts, conf, H, W)


@pytest.mark.parametrize("premlp", [0, 1])
@pytest.mark.parametrize("occ", [0, 1])
def test_query_embedding_matches_jax(premlp, occ):
    """Features from views 0, 1 and 2 of all four layers, dirs, conf, with
    and without the premlp and the z-buffer."""
    jopt, topt = mvs_options(
        shading_feature_mlp_layer0=premlp, depth_occ=occ,
        appr_feature_str0=("imgfeat_012_0123", "dir_0", "point_conf"))
    if premlp:
        jopt = jopt.replace(appr_feature_str0=("imgfeat_0_0123", "dir_0",
                                               "point_conf"))
        topt = topt.replace(appr_feature_str0=jopt.appr_feature_str0)
    p, mvs = mvs_params(jopt)
    imgs, jfeats, K, c2ws, w2cs, pts, conf, H, W = _feats_and_points(p)
    tfeats = mvs.featurenet(t(imgs))
    want = jpm.query_embedding(p, jopt, jfeats, jnp.asarray(pts),
                               jnp.asarray(conf), jnp.asarray(K),
                               jnp.asarray(c2ws), jnp.asarray(w2cs), H, W, 1)
    got = tpm.query_embedding(mvs, topt, tfeats, t(pts), t(conf), t(K),
                              t(c2ws), t(w2cs), H, W, 1)
    assert got[0].shape[1] == (32 if premlp else 56 * 3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(n(g), n(w), **NET_TOL)


# ------------------------------------------------------------------ bundles


# ------------------------------------------------------------------ gen_points


def _border_rows(n_rows, H, W):
    """Rows of pixels on the image border: their projection into their own
    view lands within rounding of its edge (the in-bounds test's tie)."""
    pix = np.arange(n_rows) % (H * W)
    y, x = pix // W, pix % W
    return (x == 0) | (x == W - 1) | (y == 0) | (y == H - 1)


def test_official_mvsnet_checkpoint_loads_in_both(tmp_path):
    """An official-layout checkpoint ({'model': {'module.' + key: tensor}},
    random weights and running stats) loads through the port's
    load_pretrained_mvsnet and JAX's import_official_mvsnet; both give the
    same forward."""
    gen = torch.Generator().manual_seed(11)
    net = tnets.MVSNet(gen)
    sd = {}
    for k, v in net.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            v = torch.rand(v.shape, generator=gen) + \
                (0.5 if k.endswith("var") else -0.5)
        sd["module." + k] = v
    path = os.path.join(tmp_path, "model_000014.ckpt")
    torch.save({"epoch": 14, "model": sd}, path)
    ours = tcommon.load_pretrained_mvsnet(path, device="cpu")
    for k, v in ours.state_dict().items():
        assert torch.equal(v, sd["module." + k]), k
    theirs = jcommon.load_pretrained_mvsnet(path)
    rng = np.random.RandomState(12)
    imgs = rng.rand(3, 3, 32, 32).astype(np.float32)
    proj = _rel_proj(3, np.array([[8.0, 0, 4], [0, 8.0, 4], [0, 0, 1]]),
                     rng)[:, :3]
    dvals = np.linspace(2.0, 4.0, 8).astype(np.float32)
    want = jmvsnet.mvsnet_forward(theirs, jnp.asarray(imgs),
                                  jnp.asarray(proj), jnp.asarray(dvals))
    got = tmvsnet.mvsnet_forward(ours, t(imgs), t(proj), t(dvals))
    for g, w in zip(got[::2], want[::2]):
        np.testing.assert_allclose(n(g), n(w), **NET_TOL)


def test_mvsnerf_featurenet_state_dict_loads_in_both():
    """An MVSNeRF FPN FeatureNet state dict under the net_mvs file's
    'FeatureNet.' prefix (random weights and running stats) loads through
    the port's and JAX's import_mvsnerf_featurenet; both give the same
    four feature maps."""
    gen = torch.Generator().manual_seed(13)
    net = tnets.FPNFeatureNet(gen)
    sd = {}
    for k, v in net.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            v = torch.rand(v.shape, generator=gen) + \
                (0.5 if k.endswith("var") else -0.5)
        sd["FeatureNet." + k] = v
    sd["other.weight"] = torch.zeros(3)
    ours = tnets.import_mvsnerf_featurenet(sd, prefix="FeatureNet.")
    theirs = jnets.import_mvsnerf_featurenet(
        {k: v.numpy() for k, v in sd.items()}, prefix="FeatureNet.")
    imgs = np.random.RandomState(14).rand(2, 3, 16, 24).astype(np.float32)
    for g, w in zip(ours.eval()(t(imgs)),
                    jnets.fpn_featurenet(theirs, jnp.asarray(imgs))):
        np.testing.assert_allclose(n(g), n(w), **NET_TOL)


def test_mvs_entry_points_default_to_the_card():
    """The MVS init's constructors and entry points place state on the
    card unless told otherwise."""
    import inspect
    from pointnerf_tpu_torch.run import train_ft
    for fn in (tpm.MvsPoints.__init__, from_jax_mvs_params,
               tcommon.gen_points_filter_embeddings,
               tcommon.load_pretrained_mvsnet, train_ft.main):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_mvs_points_refuses_probnet():
    _, topt = mvs_options(manual_depth_view=-1)
    with pytest.raises(NotImplementedError, match="ProbNet"):
        tpm.MvsPoints(topt, device="cpu")
