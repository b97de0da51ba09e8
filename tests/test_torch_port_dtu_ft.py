"""The DTU per-scene finetune slice against the JAX package: the `dtu_ft`
dataset (`data/dtu_ft.py`), the plane helpers (`data/fitplane.py`), the
plane background (`models/mvs/bg.py`) and the driver's wiring of
`bgmodel plane` and `planepoints` (`run/train_ft.py`), on
tests/fixtures.py::make_dtu_scene at 64x64 with 6 views. The background
plane is the fixture's white plane under the plate, patched into
PLANE_PARAMS[0] of both packages as tests/test_dtu_ft.py does.

Tolerances: the datasets, the plane points, the foreground masks, the
planepoints cloud and the grow filter exactly (the same numpy code);
background colours rtol = atol = 1e-5 (the port samples them with its
grid_sample_2d, JAX's four-tap form); one train step's loss items rtol
1e-5 and gradients rtol 2e-4 / atol 2e-5 with JAX's jitter draws; the
whole driver (8 steps, torch's own draws) within 1.5 dB of the JAX
driver's final PSNR. The JAX driver's run and datasets are shared through
module fixtures.
"""

import os
import shutil

import numpy as np
import jax
import pytest
import torch

import pointnerf_tpu.data.dtu_ft as jdtu_ft
from pointnerf_tpu.config import Options as JOptions
from pointnerf_tpu.data import create_dataset as jcreate
from pointnerf_tpu.data import fitplane as jfit
from pointnerf_tpu.models.mvs import bg as jbg
from pointnerf_tpu.run import common as jcommon
from pointnerf_tpu.run import train_ft as jdriver
from pointnerf_tpu.train import trainer as jtr
import pointnerf_tpu_torch.data.dtu_ft as tdtu_ft
from pointnerf_tpu_torch.config import Options
from pointnerf_tpu_torch.data import create_dataset
from pointnerf_tpu_torch.data import fitplane as tfit
from pointnerf_tpu_torch.models.mvs import bg as tbg
from pointnerf_tpu_torch.run import common as tcommon
from pointnerf_tpu_torch.run import train_ft as tdriver
from pointnerf_tpu_torch.run.workload import make_dtu_scene as port_scene
from pointnerf_tpu_torch.train import trainer as ttr
from pointnerf_tpu_torch.utils.visualizer import Visualizer

from fixtures import make_dtu_scene
from test_torch_port_dtu import _same
from test_torch_port_train import (_close_grads, _close_items, _np_tree,
                                   _port, _uniform)

FIXTURE_PLANE = ((0.0, 0.0, -0.2), (0.0, 0.0, -1.0), (1.0, 1.0, 1.0))
BG_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
LOSS_TOL = dict(rtol=1e-5, atol=1e-7)
STEPS = 8


@pytest.fixture(scope="module")
def dtu_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dtu_ft"))
    make_dtu_scene(root, n_views=6, wh=(64, 64))
    return root


@pytest.fixture(scope="module")
def plate_plane():
    """The fixture's plane as PLANE_PARAMS[0] of both packages."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdtu_ft, "PLANE_PARAMS",
                   [FIXTURE_PLANE] + jdtu_ft.PLANE_PARAMS[1:])
        mp.setattr(tdtu_ft, "PLANE_PARAMS",
                   [FIXTURE_PLANE] + tdtu_ft.PLANE_PARAMS[1:])
        yield


def ft_opt(root, **kw):
    """tests/test_dtu_ft.py's options."""
    jopt = JOptions(data_root=root, scan="scan1", dataset_name="dtu_ft",
                    img_wh=(64, 64), random_sample="random",
                    random_sample_size=8, bg_color="black", test_num_step=3,
                    point_features_dim=16, init_view_num=3).replace(**kw)
    return jopt, Options.from_json(jopt.to_json())


def plane_opt(root, out, **kw):
    """tests/test_dtu_ft.py::test_train_ft_plane_bg_e2e's options (8 steps
    from the PFM points, bgmodel plane)."""
    kw = dict(dict(bgmodel="plane"), **kw)
    return ft_opt(
        root, experiment="dtu_plane_e2e", checkpoints_dir=out,
        load_points=1, vox_res=64,
        ranges=(-0.6, -0.6, -0.1, 0.6, 0.6, 0.1),
        vsize=(0.05, 0.05, 0.05), vscale=(1, 1, 1),
        kernel_size=(3, 3, 3), query_size=(3, 3, 3),
        max_o=16384, P=8, K=4, SR=12, z_depth_dim=48,
        radius_limit_scale=4.0, feature_init_method="rand",
        num_feat_freqs=2, dist_xyz_freq=3, num_viewdir_freqs=2,
        num_pos_freqs=4, shading_feature_num=32,
        shading_feature_mlp_layer1=1, shading_feature_mlp_layer3=1,
        shading_alpha_mlp_layer=1, shading_color_mlp_layer=2,
        agg_intrp_order=2, agg_distance_kernel="linear", agg_dist_pers=20,
        point_conf_mode="1", point_color_mode="1", point_dir_mode="1",
        which_tonemap_func="off", default_conf=0.4, lr=0.002, plr=0.005,
        color_loss_items=("ray_masked_coarse_raycolor", "coarse_raycolor"),
        color_loss_weights=(1.0, 0.0),
        zero_one_loss_items=("conf_coefficient",),
        zero_one_loss_weights=(0.0001,),
        maximum_step=STEPS, steps_per_dispatch=2, prune_iter=-1,
        prob_freq=0, print_freq=4, save_iter_freq=STEPS, save_point_freq=0,
        test_freq=0, test_num=1, **kw)


@pytest.fixture(scope="module")
def datasets(dtu_root):
    """Each split of both packages, built once."""
    jopt, opt = ft_opt(dtu_root)
    return {s: (create_dataset(opt, s), jcreate(jopt, split=s))
            for s in ("train", "test", "render")}


@pytest.mark.parametrize("split", ["train", "test", "render"])
def test_dtu_ft_splits_match_jax(datasets, split):
    """Split sizes, camera tables, the init bundles and plane_ind (from the
    scene's pair file and ground list), items, the PFM points and the
    render path."""
    ds, jds = datasets[split]
    assert len(ds) == len(jds) == {"train": 4, "test": 2, "render": 60}[split]
    assert ds.ids == jds.ids
    assert ds.view_id_list == jds.view_id_list == [[0, 1, 2, 3], [2, 3, 4, 5],
                                                   [4, 5, 0, 1]]
    assert ds.plane_ind == jds.plane_ind == 0
    for k in ("intrinsics", "cam2worlds", "world2cams", "near_far"):
        _same(getattr(ds, k), getattr(jds, k), k)
    for ti in range(len(jds.view_id_list)):
        _same(ds.get_init_item(ti), jds.get_init_item(ti), f"init{ti}")
    _same(ds.get_campos_ray(), jds.get_campos_ray(), "campos_ray")
    if split == "render":
        _same(ds.render_poses, jds.render_poses, "render_poses")
        for i in (0, 31):
            _same(ds.get_dummyrot_item(i, rng=np.random.RandomState(i)),
                  jds.get_dummyrot_item(i, rng=np.random.RandomState(i)))
        return
    pts = ds.load_init_points()
    assert len(pts) > 300
    _same(pts, jds.load_init_points(), "points")
    for idx in range(len(jds)):
        _same(ds.get_item(idx, rng=np.random.RandomState(idx)),
              jds.get_item(idx, rng=np.random.RandomState(idx)), f"{idx}")
    _same(ds.get_item(1, full_img=True), jds.get_item(1, full_img=True))


def test_dtu_ft_fallbacks_match_jax(dtu_root, tmp_path):
    """Without the pair file, the nearest-camera bundles; without the ground
    list, opt.plane_ind; a plane_ind past PLANE_PARAMS raises IndexError in
    both."""
    root = str(tmp_path / "bare")
    shutil.copytree(dtu_root, root)
    os.remove(os.path.join(root, "dtu_configs",
                           "dtu_finetune_init_pairs.txt"))
    os.remove(os.path.join(root, "dtu_configs", "lists",
                           "dtu_test_ground.txt"))
    jopt, opt = ft_opt(root, plane_ind=2)
    ds, jds = create_dataset(opt, "train"), jcreate(jopt, split="train")
    assert ds.view_id_list == jds.view_id_list and len(ds.view_id_list) == 6
    assert ds.plane_ind == jds.plane_ind == 2
    _same(ds.get_init_item(3), jds.get_init_item(3))
    _same(ds.get_plane_param(), jds.get_plane_param())
    jopt, opt = ft_opt(root, plane_ind=3)
    ds, jds = create_dataset(opt, "train"), jcreate(jopt, split="train")
    with pytest.raises(IndexError):
        jds.get_plane_param()
    with pytest.raises(IndexError):
        ds.get_plane_param()


def test_dtu_ft_resized_images_match_jax(tmp_path):
    """Rectified PNGs written at 80x80 and read at img_wh 64x64: both
    packages resize with Pillow's BILINEAR, so the images and the init
    bundles are equal."""
    root = str(tmp_path / "big")
    port_scene(root, n_views=6, wh=(64, 64), image_wh=(80, 80))
    jopt, opt = ft_opt(root)
    for split in ("train", "test"):
        ds, jds = create_dataset(opt, split), jcreate(jopt, split=split)
        for a, b in zip(ds.render_gtimgs, jds.render_gtimgs):
            assert a.shape == (64, 64, 3)
            np.testing.assert_array_equal(a, b)
    _same(ds.get_init_item(1), jds.get_init_item(1))


def test_plane_helpers_match_jax(datasets):
    """PLANE_PARAMS, the plane points for one seed (xyz, embeddings,
    directions, colours, confs), the grow filter, and fitplane's four
    functions on the same inputs."""
    ds, jds = datasets["train"]
    for i in range(3):
        _same(ds.get_plane_param(i), jds.get_plane_param(i), f"plane{i}")
    for seed in (0, 7):
        got = ds.get_plane_param_points(np.random.RandomState(seed))
        want = jds.get_plane_param_points(np.random.RandomState(seed))
        assert got[0].shape == (8000, 3) and got[1].shape == (8000, 16)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    _same(ds.get_plane_param_points(), jds.get_plane_param_points())
    rng = np.random.RandomState(3)
    xyz = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
    xyz[:100, 2] = ds.get_plane_param()[0][2] + rng.uniform(-0.3, 0.3, 100)
    keep = ds.filter_plane(xyz)
    assert 0 < keep.sum() < len(xyz)
    np.testing.assert_array_equal(keep, jds.filter_plane(xyz))
    pts = np.stack([xyz[:, 0], xyz[:, 1],
                    0.5 * xyz[:, 0] - 0.25 * xyz[:, 1] + 2], -1)
    for a, b in zip(tfit.best_fit_plane(pts), jfit.best_fit_plane(pts)):
        np.testing.assert_array_equal(a, b)
    p0, n0 = jfit.best_fit_plane(pts)
    _same(tfit.generate_plane_points(p0, n0, 2.0, 100,
                                     np.random.RandomState(1)),
          jfit.generate_plane_points(p0, n0, 2.0, 100,
                                     np.random.RandomState(1)))
    _same(tfit.plane_distance(xyz, p0, n0), jfit.plane_distance(xyz, p0, n0))
    rays = (xyz / np.linalg.norm(xyz, axis=-1, keepdims=True)).astype(
        np.float32)
    _same(tfit.get_rayplane_cross(np.zeros(3, np.float32), rays, p0, n0),
          jfit.get_rayplane_cross(np.zeros(3, np.float32), rays, p0, n0))


@pytest.fixture(scope="module")
def bg_views(datasets, plate_plane):
    ds, jds = datasets["train"]
    views = tbg.collect_bg_views(ds, 3, device="cpu")
    jviews = jbg.collect_bg_views(jds, 3)
    return views, jviews, jds.load_init_points()


def test_set_bg_matches_jax(datasets, bg_views):
    """The ray/plane crossings, the foreground masks and each ray's
    background colour of one test frame."""
    views, jviews, fg_xyz = bg_views
    assert len(views) == len(jviews) == 3
    for v, jv in zip(views, jviews):
        np.testing.assert_array_equal(v["img"].numpy(), jv["img"])
        for k in ("w2c", "intrinsic"):
            np.testing.assert_array_equal(v[k], jv[k])
    ds, jds = datasets["test"]
    item = jds.get_item(0, full_img=True)
    pnt, normal, color = jds.get_plane_param()
    cross = tbg.get_rayplane_cross(item["campos"], item["raydir"], pnt,
                                   normal)[0]
    want_cross = jbg.get_rayplane_cross(item["campos"], item["raydir"], pnt,
                                        normal)[0]
    np.testing.assert_array_equal(cross, want_cross)
    bg, masks = tbg.set_bg(cross, views, color, fg_xyz=fg_xyz)
    want, want_masks = jbg.set_bg(cross, jviews, color, fg_xyz=fg_xyz)
    for m, w in zip(masks, want_masks):
        assert 0 < m.sum() < m.size
        np.testing.assert_array_equal(m, w)
    hit = want.max(-1) > 0
    assert 0 < hit.sum() < len(hit)
    np.testing.assert_array_equal(bg.max(-1) > 0, hit)
    np.testing.assert_allclose(bg, want, **BG_TOL)
    with pytest.raises(ValueError, match="fg_xyz"):
        tbg.set_bg(cross, views, color)


@pytest.mark.parametrize("split", ["train", "test", "render"])
def test_create_all_bg_matches_jax(datasets, bg_views, split):
    """The per-frame background maps of each split (the render path's
    through get_dummyrot_item): where they are set exactly, their colours
    at 1e-5."""
    views, jviews, fg_xyz = bg_views
    ds, jds = datasets[split]
    if split == "render":             # a few of the 60 poses
        ds.total = jds.total = 6
    params = jds.get_plane_param()
    try:
        got = tbg.create_all_bg(ds, views, fg_xyz, params,
                                dummy=split == "render")
        want = jbg.create_all_bg(jds, jviews, fg_xyz, params,
                                 dummy=split == "render")
    finally:
        ds.total = jds.total = len(ds.render_poses) if split == "render" \
            else len(ds.ids)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.shape == (64, 64, 3)
        np.testing.assert_array_equal(a.max(-1) > 0, b.max(-1) > 0)
        np.testing.assert_allclose(a, b, **BG_TOL)
    if split != "render":
        assert any((b.max(-1) > 0.9).any() for b in want)


class _NoLog:
    """A visualizer that records nothing (probe_hole's logging)."""

    def save_neural_points(self, *a, **kw):
        pass

    def print_details(self, *a, **kw):
        pass


def _planepoints_clouds(root, out, monkeypatch):
    """The cloud each driver's main starts from with bgmodel planepoints."""
    jopt, opt = plane_opt(root, out, bgmodel="planepoints")
    caught = {}

    class Stop(Exception):
        pass

    def jax_spy(opt_, key, point_state):
        caught["jax"] = jax.tree.map(
            lambda x: None if x is None else np.asarray(x), point_state,
            is_leaf=lambda x: x is None)
        raise Stop

    def port_spy(opt_, point_state, gen):
        caught["port"] = {k: None if v is None else v.numpy().copy()
                          for k, v in point_state.items()}
        raise Stop

    monkeypatch.setattr(jtr, "create_train_state", jax_spy)
    monkeypatch.setattr(ttr, "create_train_state", port_spy)
    for main, o in ((jdriver.main, jopt), (tdriver.main, opt)):
        with pytest.raises(Stop):
            main(o) if main is jdriver.main else main(o, device="cpu")
    monkeypatch.undo()
    return jopt, opt, caught


def test_planepoints_cloud_and_grow_filter_match_jax(dtu_root, tmp_path,
                                                     plate_plane,
                                                     monkeypatch):
    """bgmodel planepoints: the starting cloud (the PFM points and the 8000
    plane points drawn from RandomState(seed)) equal JAX's; probe_hole's
    candidates with the plane's cut away equal JAX's on the same probe
    maps; then the port's CLI runs 2 steps with it."""
    jopt, opt, caught = _planepoints_clouds(dtu_root, str(tmp_path),
                                            monkeypatch)
    want, got = caught["jax"], caught["port"]
    n = int(want["mask"].sum())
    assert int(got["mask"].sum()) == n > 8000
    for k, v in want.items():
        if v is None:
            assert got[k] is None, k
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)

    # the probe: the same maps for both drivers, a third of the candidates
    # on the plane
    H = W = 64
    rng = np.random.RandomState(4)
    hit = rng.rand(H, W) > 0.3
    loc = rng.uniform(-0.5, 0.5, (H, W, 3)).astype(np.float32)
    loc[..., 2] = np.where(rng.rand(H, W) < 0.33, -0.2 + 0.1 * loc[..., 2],
                           0.3 + loc[..., 2])
    maps = {"ray_mask": hit[..., None].astype(np.float32),
            "ray_max_sample_loc_w": loc,
            "ray_max_shading_opacity": rng.rand(H, W, 1).astype(np.float32),
            "shading_avg_embedding": rng.rand(H, W, 16).astype(np.float32),
            "shading_avg_color": rng.rand(H, W, 3).astype(np.float32),
            "shading_avg_dir": rng.rand(H, W, 3).astype(np.float32),
            "shading_avg_conf": rng.rand(H, W, 1).astype(np.float32),
            "coarse_raycolor": rng.rand(H, W, 3).astype(np.float32)}
    fake = lambda *a, **kw: maps
    monkeypatch.setattr(jdriver, "render_image", fake)
    monkeypatch.setattr(tdriver, "render_image", fake)
    jds = jcreate(jopt, split="train")
    ds = create_dataset(opt, "train")
    state = jcommon.init_point_state_from_dataset(jopt, jds,
                                                  jax.random.PRNGKey(0))
    ts = jtr.create_train_state(jopt, jax.random.PRNGKey(0), state)
    pspec, pgrid = jcommon.make_spec_and_grid(jopt, jtr.point_state_of(ts))
    frames = np.arange(len(jds))
    want = jdriver.probe_hole(ts, pgrid, jopt, pspec, jds, frames,
                              _NoLog(), 1)
    tts = ttr.create_train_state(
        opt, tcommon.init_point_state_from_dataset(opt, ds, device="cpu"),
        torch.Generator().manual_seed(0))
    got = tdriver.probe_hole(tts, opt, ds, frames, _NoLog(), 1)
    unfiltered = tdriver.probe_hole(tts, opt.replace(bgmodel="no"), ds,
                                    frames, _NoLog(), 1)
    assert 0 < len(got["xyz"]) < len(unfiltered["xyz"])
    assert not ds.filter_plane(got["xyz"]).any()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    monkeypatch.undo()

    path = os.path.join(str(tmp_path), "planepoints.json")
    with open(path, "w") as f:
        f.write(opt.replace(maximum_step=2, save_iter_freq=2).to_json())
    res = tdriver.cli(["--device", "cpu", "--config", path,
                       "--experiment", "planepoints_cli"])
    assert res["total_steps"] == 2 and res["timing"]["plane_points"] == 8000
    assert np.isfinite(res["final_psnr"])


def test_train_step_with_bg_ray_matches_jax(datasets, bg_views, dtu_root):
    """One train step on a dtu_ft batch whose rays carry the plane
    background's bg_ray: loss items and every gradient, with JAX's jitter
    draws; then a full test image with its bg_ray through render_image
    (ray masks equal, colours at 1e-5)."""
    views, jviews, fg_xyz = bg_views
    jopt, opt = plane_opt(dtu_root, "unused")
    ds, jds = datasets["train"]
    maps = jbg.create_all_bg(jds, jviews, fg_xyz, jds.get_plane_param())
    item = jds.get_item(2, rng=np.random.RandomState(2))
    pix = item["pixel_idx"][0].astype(np.int64)
    item["bg_ray"] = maps[2][pix[:, 1], pix[:, 0]][None]
    assert (item["bg_ray"] > 0).any()
    jb = {k: jax.numpy.asarray(item[k]) for k in
          ("raydir", "campos", "camrotc2w", "near", "far", "bg_color",
           "gt_image", "bg_ray")}
    state = jcommon.init_point_state_from_dataset(jopt, jds,
                                                  jax.random.PRNGKey(0))
    ts = jtr.create_train_state(jopt, jax.random.PRNGKey(2), state)
    spec, grid = jcommon.make_spec_and_grid(jopt, jtr.point_state_of(ts))
    key = jax.random.PRNGKey(8)
    want, jn, jp = jtr.compute_grads(ts, grid, jb, key, jopt, spec)
    st, spec_t, grid_t, tb = _port(opt, ts, jb)
    R = jb["raydir"].shape[1]
    u = torch.tensor(_uniform(key, 1, R, opt.z_depth_dim))
    items, g_net, g_pts = ttr.compute_grads(st, grid_t, tb, opt, spec_t, u)
    _close_items(items, want, **LOSS_TOL)
    _close_grads(g_net, g_pts, jn, jp, **GRAD_TOL)
    # without bg_ray the loss differs: the background takes part
    tb.pop("bg_ray")
    other, _, _ = ttr.compute_grads(st, grid_t, tb, opt, spec_t, u)
    assert float(other["loss_total"]) != float(items["loss_total"])

    # a full test image with its bg_ray, chunk by chunk in groups: JAX's
    # render_image and the port's
    tds, tjds = datasets["test"]
    tmaps = jbg.create_all_bg(tjds, jviews, fg_xyz, jds.get_plane_param())
    full = tdriver.with_bg_ray(tjds.get_item(1, full_img=True), tmaps[1])
    ropt = jopt.replace(random_sample="no_crop")
    want = jcommon.render_image(ts, grid, ropt, spec, full)
    got = tcommon.render_image(st, grid_t, Options.from_json(ropt.to_json()),
                               spec_t, full)
    np.testing.assert_array_equal(got["ray_mask"], want["ray_mask"])
    miss = want["ray_mask"][..., 0] == 0
    assert miss.any() and (tmaps[1][miss] > 0).any()
    np.testing.assert_allclose(got["coarse_raycolor"],
                               want["coarse_raycolor"], **BG_TOL)


@pytest.fixture(scope="module")
def jax_plane_run(dtu_root, plate_plane, tmp_path_factory):
    """The JAX driver's 8 steps with bgmodel plane, once."""
    out = str(tmp_path_factory.mktemp("jax_plane"))
    jopt, _ = plane_opt(dtu_root, out)
    res = jdriver.main(jopt)
    with open(os.path.join(out, "dtu_plane_e2e", "log.txt")) as f:
        return res["final_psnr"], f.read()


def test_driver_with_plane_background_matches_jax(dtu_root, tmp_path,
                                                  jax_plane_run):
    """The whole driver with bgmodel plane: the maps precomputed (the log
    line), 8 steps whose batches carry bg_ray, the final test render with
    the test maps, and a final PSNR within 1.5 dB of the JAX driver's."""
    jpsnr, jlog = jax_plane_run
    assert "plane background precomputed" in jlog
    _, opt = plane_opt(dtu_root, str(tmp_path))
    seen = []
    step = ttr.train_step

    def spy(ts, grid, batch, *a, **kw):
        seen.append("bg_ray" in batch)
        return step(ts, grid, batch, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttr, "train_step", spy)
        res = tdriver.main(opt, device="cpu")
    assert res["total_steps"] == STEPS and seen == [True] * STEPS
    assert res["timing"]["bg_s"] > 0
    with open(os.path.join(str(tmp_path), "dtu_plane_e2e", "log.txt")) as f:
        assert "plane background precomputed for 4 train / 2 test" in f.read()
    assert np.isfinite(res["final_psnr"])
    assert abs(res["final_psnr"] - jpsnr) < 1.5, (res["final_psnr"], jpsnr)
    # the held-out render used the maps: without them it scores otherwise
    ds = create_dataset(opt, "test")
    vis = Visualizer(opt.replace(checkpoints_dir=str(tmp_path / "x")))
    plain = tdriver.test(res["state"], res["grid"], opt, res["spec"], ds,
                         vis, STEPS, write_images=False)
    assert plain != res["final_psnr"]
