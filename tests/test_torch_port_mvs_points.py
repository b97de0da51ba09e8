"""The MVS init's point generation against the JAX package (split from
test_torch_port_mvs.py, whose helpers it shares): the init bundles and
view triplets, gen_points in each depth mode, and
gen_points_filter_embeddings end to end, on a 64x64 NeRF-Synthetic plate
scene. Tolerances as test_torch_port_mvs.py states them: the bundles and
`keep` exactly; the rows at rtol = atol = 1e-4 (conv stacks and MVSNet in
another summation order), but for the named tie of the image-border
pixels.
"""

import numpy as np
import jax
import pytest

from pointnerf_tpu.data import create_dataset as jcreate
from pointnerf_tpu.models.mvs import points_model as jpm
from pointnerf_tpu.run import common as jcommon
from pointnerf_tpu_torch.data import create_dataset
from pointnerf_tpu_torch.models.mvs import points_model as tpm
from pointnerf_tpu_torch.run import common as tcommon

from fixtures import make_nerf_synth_scene
from test_torch_port_mvs import (NET_TOL, _border_rows, mvs_options,
                                 mvs_params, n, t)


@pytest.fixture(scope="module")
def scene64(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mvs64"))
    make_nerf_synth_scene(root, wh=(64, 64), n_train=8, n_test=2)
    return root


def test_init_bundles_and_triplets_match_jax(scene64):
    """hull_view_triplets (with and without full_comb) and every array of
    get_init_item, exactly; bg_filtering alphas."""
    for full_comb in (0, 1):
        jopt, topt = mvs_options(
            data_root=scene64, scan="plate", dataset_name="nerf_synth360_ft",
            img_wh=(64, 64), near_plane=2.0, far_plane=4.5,
            bg_color="white", full_comb=full_comb, bg_filtering=full_comb)
        jds, tds = jcreate(jopt, split="train"), create_dataset(topt, "train")
        assert tds.view_id_list == jds.view_id_list
        assert len(tds.view_id_list) >= 8
        for i in (0, len(tds.view_id_list) - 1):
            want, got = jds.get_init_item(i), tds.get_init_item(i)
            assert set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert create_dataset(topt, "test").view_id_list == []


def _first_item(root, jopt, topt, depth_plate=False):
    jds = jcreate(jopt, split="train")
    sample = jds.get_init_item(0)
    if depth_plate:
        # mode 0: a z-depth map of the plate (0 where rays miss it)
        tds = create_dataset(topt, "train")
        depths = []
        for v in sample["view_ids"]:
            K, c2w = tds.intrinsics[v], tds.cam2worlds[v]
            px, py = np.meshgrid(np.arange(64.0), np.arange(64.0))
            d_w = np.stack([(px - K[0, 2]) / K[0, 0], (py - K[1, 2]) / K[1, 1],
                            np.ones_like(px)], -1) @ c2w[:3, :3].T
            tt_ = -c2w[2, 3] / d_w[..., 2]
            hit = c2w[:3, 3] + tt_[..., None] * d_w
            inside = (np.abs(hit[..., 0]) <= 0.4) & (np.abs(hit[..., 1]) <= 0.4)
            depths.append(np.where(inside, tt_, 0.0))
        sample = dict(sample, depths_h=np.stack(depths).astype(np.float32))
    return sample


GEN_CASES = {
    "mode0": dict(manual_depth_view=0, depth_occ=0),
    "mode1": dict(manual_depth_view=1, depth_occ=0, default_conf=2.0),
    "mode1-far-shift": dict(manual_depth_view=1, depth_occ=0,
                            far_plane_shift=0.5),
    "mode1-jitter": dict(manual_depth_view=1, depth_occ=0,
                         manual_std_depth=0.05, num_each_depth=2),
    "mode2": dict(manual_depth_view=2, depth_occ=0, depth_conf_thresh=0.02),
    "mode1-occ": dict(manual_depth_view=1, depth_occ=1),
}


@pytest.mark.parametrize("case", list(GEN_CASES))
def test_gen_points_matches_jax(scene64, case):
    """gen_points' rows against JAX's, mode 0 (given depths), 1 (MVSNet and
    fusion; with default_conf > 1, far_plane_shift, injected jitter and the
    z-buffer), 2 (top-k hypotheses). keep exactly; the rest at NET_TOL on
    every kept row but one named tie: pixels on the image border, whose
    projection into their own view lands on its edge, in or out of bounds
    by rounding (JAX's small dots and the port's products round the edge
    columns differently)."""
    kw = GEN_CASES[case]
    jopt, topt = mvs_options(
        data_root=scene64, scan="plate", dataset_name="nerf_synth360_ft",
        img_wh=(64, 64), near_plane=2.0, far_plane=4.5, bg_color="white",
        full_comb=1, depth_grid=24, **kw)
    p, mvs = mvs_params(jopt)
    sample = _first_item(scene64, jopt, topt, depth_plate=(case == "mode0"))
    key = jax.random.PRNGKey(1)
    noise = None
    if jopt.manual_std_depth > 0:
        # JAX's draw: normal(split(key)[1], (num, H, W)) per depth view
        _, sub = jax.random.split(key)
        noise = [t(jax.random.normal(sub, (jopt.num_each_depth, 64, 64)))]
    want = {k: n(v) for k, v in jpm.gen_points(p, jopt, sample, key).items()}
    maps = {}
    got = {k: n(v) for k, v in tpm.gen_points(mvs, topt, sample, noise=noise,
                                              maps=maps).items()}
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["keep"], want["keep"])
    keep = want["keep"].astype(bool)
    rows = keep & ~_border_rows(len(keep), 64, 64)
    assert rows.sum() > 100
    assert n(maps["vis"][0]).shape == (len(keep), 1)
    for k in ("xyz_w", "embedding", "color", "dir", "conf"):
        np.testing.assert_allclose(got[k][rows], want[k][rows],
                                   err_msg=k, **NET_TOL)


def lego_like(root, **kw):
    """The lego preset's MVS options at a test's size: depth_occ,
    bg_filtering, full_comb, the chip phase's depth range and conf
    threshold, a voxel downsample, and ranges around the plate. The ranges
    also crop the rays of the hull views' border pixels: their projection
    into their own view is in or out of bounds by rounding (the tie of
    test_gen_points_matches_jax), and the hull keeps out-of-bounds points."""
    return mvs_options(
        data_root=root, scan="plate", dataset_name="nerf_synth360_ft",
        img_wh=(64, 64), near_plane=2.5, far_plane=3.5, bg_color="white",
        full_comb=1, depth_grid=24, depth_conf_thresh=0.0, bg_filtering=1,
        vox_res=64, default_conf=0.15,
        ranges=(-0.55, -0.55, -0.2, 0.55, 0.55, 0.2), **kw)


def test_gen_points_filter_embeddings_matches_jax(scene64):
    """BRANCH B end to end over 2 triplets: the same point count, the
    state at NET_TOL (mask exactly), and the port's phase counters."""
    jopt, topt = lego_like(scene64)
    p, mvs = mvs_params(jopt)
    jds, tds = jcreate(jopt, split="train"), create_dataset(topt, "train")
    jds.view_id_list = jds.view_id_list[:2]
    tds.view_id_list = tds.view_id_list[:2]
    want = jcommon.gen_points_filter_embeddings(
        jopt, jds, jax.random.PRNGKey(0), mvs_params=p)
    stats = {}
    got = tcommon.gen_points_filter_embeddings(topt, tds, mvs=mvs,
                                               device="cpu", stats=stats)
    assert stats["triplets"] == 2
    assert stats["n_keep"] > stats["n_hull"] >= stats["n_vox"] > 100
    np.testing.assert_array_equal(n(got["mask"]), n(want["mask"]))
    m = n(want["mask"])
    assert m.sum() == stats["n_vox"]
    for k in ("xyz", "embedding", "color", "dir", "conf"):
        np.testing.assert_allclose(n(got[k])[m], n(want[k])[m], err_msg=k,
                                   **NET_TOL)
