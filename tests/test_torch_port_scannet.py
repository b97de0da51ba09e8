"""The ScanNet finetune slice against the JAX package: the `scannet_ft`
dataset (`data/scannet_ft.py`), the sensor-depth point inits of
`run/common.init_point_state_from_dataset` (load_points 2 and 3, with
`comb_file`) and the whole driver, on the fixture scene of
`tests/fixtures.py::make_scannet_scene` (40x30 JPEG frames, 16-bit depth
PNGs written by imageio) and on scenes the port's `run/workload.
make_scannet_scene` writes at other sizes.

JAX reads the files through Pillow and cv2; the port through its own
decoders (`utils/jpeg.py`, `utils/png.py`, `utils/cvimg.py`), which give
the same bytes, and the rest is the same numpy code. So the split lists,
images, depths, intrinsics, poses, items, point clouds and point states
are held exactly, the rays within 1e-6 (the same float32 code), and the
whole driver, whose randomness differs (JAX keys against torch
generators), to the JAX driver's final PSNR within 1.5 dB.
"""

import os

import numpy as np
import jax
import pytest

from pointnerf_tpu.config import Options as JOptions
from pointnerf_tpu.data import create_dataset as jcreate
from pointnerf_tpu.run import common as jcommon
from pointnerf_tpu.run import train_ft as jdriver
from pointnerf_tpu_torch.config import Options
from pointnerf_tpu_torch.data import create_dataset
from pointnerf_tpu_torch.run import common as tcommon
from pointnerf_tpu_torch.run import train_ft as tdriver
from pointnerf_tpu_torch.run.workload import make_scannet_scene as port_scene
from pointnerf_tpu_torch.utils.jpeg import encode_jpeg, read_jpeg
from pointnerf_tpu_torch.utils.png import read_png

from fixtures import make_nerf_synth_scene, make_scannet_scene

TOL = dict(rtol=1e-6, atol=1e-6)
SCAN = "scene0101_04"
SPLIT_ATTRS = ("all_id_list", "train_id_list", "test_id_list", "id_list")
ARRAY_ATTRS = ("cam2worlds", "world2cams", "intrinsics", "near_far",
               "base_intrinsic", "depth_intrinsic")


@pytest.fixture(scope="module")
def sc_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scannet"))
    make_scannet_scene(root, n=10, wh=(40, 30))
    return root


def _opts(root, **kw):
    jopt = JOptions(data_root=root, scan=SCAN, dataset_name="scannet_ft",
                    img_wh=(40, 30), random_sample="random",
                    random_sample_size=6, near_plane=0.1, far_plane=8.0,
                    bg_color="black", ranges=(-100.0,) * 3 + (100.0,) * 3,
                    test_num_step=5, point_features_dim=8, vox_res=0,
                    feature_init_method="rand").replace(**kw)
    return jopt, Options.from_json(jopt.to_json())


def _same_item(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_allclose(np.asarray(b[k], np.float64),
                                   np.asarray(a[k], np.float64), **TOL,
                                   err_msg=k)


def _same_dataset(tds, jds):
    assert len(tds) == len(jds)
    for name in SPLIT_ATTRS:
        assert getattr(tds, name) == getattr(jds, name), name
    for name in ARRAY_ATTRS:
        np.testing.assert_array_equal(getattr(tds, name),
                                      getattr(jds, name), err_msg=name)
    for name in ("render_gtimgs", "alphas", "depths"):
        assert len(getattr(tds, name)) == len(getattr(jds, name)), name
        for a, b in zip(getattr(tds, name), getattr(jds, name)):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert tds.has_metric_depth == jds.has_metric_depth


@pytest.mark.parametrize("test_num_step", [5, 1])
def test_scannet_splits_and_items_match_jax(sc_root, test_num_step):
    jopt, opt = _opts(sc_root, test_num_step=test_num_step)
    for split, n in (("train", 2), ("test", 8 if test_num_step != 1 else 10),
                     ("render", 10)):
        jds, tds = jcreate(jopt, split=split), create_dataset(opt, split)
        assert len(tds) == n
        _same_dataset(tds, jds)
        for a, b in zip(tds.get_campos_ray(), jds.get_campos_ray()):
            np.testing.assert_array_equal(a, b)
        for i in range(len(tds)):
            if split == "render":
                _same_item(tds.get_dummyrot_item(i, np.random.RandomState(i)),
                           jds.get_dummyrot_item(i, np.random.RandomState(i)))
            else:
                _same_item(tds.get_item(i, np.random.RandomState(i)),
                           jds.get_item(i, np.random.RandomState(i)))
        _same_item(tds.get_item(0, full_img=True),
                   jds.get_item(0, full_img=True))


def _frames(root, n, invalid=(), wh=(8, 8)):
    """A scene of n tiny frames sharing one JPEG, poses valid but for the
    ids in `invalid` (an inf entry, a translation past 30)."""
    exp = os.path.join(root, SCAN, "exported")
    for sub in ("color", "pose", "intrinsic"):
        os.makedirs(os.path.join(exp, sub), exist_ok=True)
    K = np.eye(4)
    K[0, 0] = K[1, 1] = 7.0
    np.savetxt(os.path.join(exp, "intrinsic", "intrinsic_color.txt"), K)
    y, x = np.mgrid[0:wh[1], 0:wh[0]] * 30
    jpg = encode_jpeg(np.stack([x, y, x + y], -1).astype(np.uint8), 90)
    pose = np.eye(4)
    pose[:3, 3] = (0.0, 0.0, 2.0)
    text = "\n".join(" ".join(f"{v:.6f}" for v in r) for r in pose)
    for i in range(n):
        with open(os.path.join(exp, "color", f"{i}.jpg"), "wb") as f:
            f.write(jpg)
        t = text
        if i in invalid:
            t = text.replace("2.000000", "inf" if i % 2 else "31.000000")
        with open(os.path.join(exp, "pose", f"{i}.txt"), "w") as f:
            f.write(t)
    return exp


def test_scannet_split_rules_invalid_poses_and_blur_list(tmp_path):
    """Past 2,900 valid frames the NPBG rule splits (every 100th frame to
    test, frames 20-80 of each hundred to train, the last hundred whole);
    invalid poses drop out first, and blur_list.txt's ids leave train."""
    exp = _frames(str(tmp_path), 2950, invalid=(3, 4, 1500, 2949))
    with open(os.path.join(exp, "blur_list.txt"), "w") as f:
        f.write("25\n\n26\n2925\n")
    jopt, opt = _opts(str(tmp_path), img_wh=(8, 8))
    jds, tds = jcreate(jopt, split="test"), create_dataset(opt, "test")
    _same_dataset(tds, jds)
    assert len(tds.all_id_list) == 2946 and len(tds.test_id_list) == 30
    assert 25 not in tds.train_id_list and 2925 not in tds.train_id_list
    assert 2930 in tds.train_id_list and 1500 not in tds.all_id_list
    # under the NSVF rule (fewer frames), with test_num_step 1
    exp2 = _frames(str(tmp_path / "small"), 23, invalid=(6,))
    for step in (5, 1):
        jopt, opt = _opts(str(tmp_path / "small"), img_wh=(8, 8),
                          test_num_step=step)
        for split in ("train", "test", "render"):
            _same_dataset(create_dataset(opt, split),
                          jcreate(jopt, split=split))
    assert os.path.isdir(exp2)


def test_scannet_detect_blurry_matches_jax(sc_root):
    jopt, opt = _opts(sc_root)
    jds, tds = jcreate(jopt, split="train"), create_dataset(opt, "train")
    ids = tds.all_id_list
    for worst in (3, 10):
        assert tds.detect_blurry(ids, worst) == jds.detect_blurry(ids, worst)
    gray = (read_jpeg(os.path.join(tds.exported, "color", "3.jpg"))[..., 1])
    assert tds.variance_of_laplacian(gray) == \
        jds.variance_of_laplacian(gray)


def test_scannet_resized_colours_and_sensor_depth_match_jax(tmp_path):
    """Colours at another size than img_wh go through LANCZOS and scale the
    intrinsic; depth_loss_items reads the 16-bit depths and nearest-resizes
    them to img_wh (gt_depth in every item)."""
    root = str(tmp_path)
    port_scene(root, n=6, wh=(52, 39), depth_wh=(32, 24), half=0.5,
               radius=2.0)
    jopt, opt = _opts(root, depth_loss_items=("coarse_depth",),
                      depth_loss_weights=(0.1,))
    for split in ("train", "test"):
        jds, tds = jcreate(jopt, split=split), create_dataset(opt, split)
        _same_dataset(tds, jds)
        assert tds.render_gtimgs[0].shape == (30, 40, 3)
        assert tds.depths[0].shape == (30, 40) and tds.depths[0].max() > 1
        _same_item(tds.get_item(0, np.random.RandomState(1)),
                   jds.get_item(0, np.random.RandomState(1)))
    assert not np.array_equal(tds.intrinsics[0], tds.base_intrinsic)


@pytest.mark.parametrize("ranges", [(-100.0,) * 3 + (100.0,) * 3,
                                    (-0.3, -0.25, -0.1, 0.3, 0.3, 0.1)])
def test_scannet_init_points_match_jax(sc_root, ranges):
    jopt, opt = _opts(sc_root, ranges=ranges)
    jds, tds = jcreate(jopt, split="train"), create_dataset(opt, "train")
    np.testing.assert_array_equal(tds.load_init_points(),
                                  jds.load_init_points())
    for vox in (0, 100, 7):
        got = tds.load_init_depth_points(vox_res=vox)
        want = jds.load_init_depth_points(vox_res=vox)
        assert got.dtype == want.dtype == np.float32 and len(got) > 50
        np.testing.assert_array_equal(got, want)
    stats = {}
    tds.load_init_depth_points(vox_res=0, stats=stats)
    assert stats["frames"] == 10 and sum(stats["n_frame"]) == \
        stats["n_points"]
    rng = np.random.RandomState(0)
    pc, depth = rng.normal(0, 1, (800, 3)), rng.normal(0.5, 1, (900, 3))
    for res in (5, 40):
        np.testing.assert_array_equal(
            tcommon.filter_depth_by_pc_occupancy(pc, depth, res),
            jcommon.filter_depth_by_pc_occupancy(pc, depth, res))
        np.testing.assert_array_equal(
            tcommon.construct_vox_points_xyz(depth, res),
            jcommon.construct_vox_points_xyz(depth, res))
        for a, b in zip(tcommon.construct_vox_points_ind(depth, res),
                        jcommon.construct_vox_points_ind(depth, res)):
            np.testing.assert_array_equal(a, b)


def _assert_state_equal(got, want):
    for k, v in want.items():
        if v is None:
            assert got.get(k) is None, k
        else:
            np.testing.assert_array_equal(got[k].detach().numpy(),
                                          np.asarray(v), err_msg=k)


def _comb_file(root):
    rng = np.random.RandomState(3)
    pts = np.concatenate([rng.uniform(-0.6, 0.6, (50, 3)),
                          rng.rand(50, 3)], -1)
    path = os.path.join(root, "comb.txt")
    np.savetxt(path, pts, delimiter=";")
    return path


CROP = (-0.3, -0.25, -0.1, 0.3, 0.3, 0.1)
STATES = {
    "lp2": dict(load_points=2),
    "lp2-vox": dict(load_points=2, vox_res=40, ranges=CROP),
    "lp3": dict(load_points=3),
    "lp3-vox-crop": dict(load_points=3, vox_res=40, ranges=CROP),
    "lp1-comb": dict(load_points=1, comb=True, vox_res=30),
    "lp2-comb-crop": dict(load_points=2, comb=True, ranges=CROP),
    "lp3-comb": dict(load_points=3, comb=True),
    "lp3-comb-crop": dict(load_points=3, comb=True, ranges=CROP),
    "lp3-comb-vox": dict(load_points=3, comb=True, vox_res=25),
    "lp2-resample": dict(load_points=2, resample_pnts=300, default_conf=0.6),
}


@pytest.mark.parametrize("case", list(STATES))
def test_scannet_point_states_match_jax(sc_root, case):
    """load_points 2 and 3 and comb_file: with load_points 3 the crop and
    the voxel downsample rebuild the cloud from the two sources, so the
    comb points leave it, as in the JAX package."""
    kw = dict(STATES[case])
    if kw.pop("comb", False):
        kw["comb_file"] = _comb_file(sc_root)
    jopt, opt = _opts(sc_root, **kw)
    want = jcommon.init_point_state_from_dataset(
        jopt, jcreate(jopt, split="train"), jax.random.PRNGKey(0))
    got = tcommon.init_point_state_from_dataset(
        opt, create_dataset(opt, "train"), device="cpu")
    _assert_state_equal(got, want)
    assert int(got["mask"].sum()) > 100


def test_depth_inits_fall_back_to_the_dataset_cloud(tmp_path):
    """A dataset without sensor depth (nerf_synth360_ft) takes its own
    cloud for load_points 2 and 3, as JAX's hasattr tests do; a
    cloud_path pickle takes the place of either, as in JAX."""
    root = str(tmp_path)
    make_nerf_synth_scene(root, wh=(40, 40))
    jopt = JOptions(data_root=root, scan="plate",
                    dataset_name="nerf_synth360_ft", img_wh=(40, 40),
                    random_sample_size=6, point_features_dim=8, vox_res=20,
                    ranges=(-1.0, -1.0, -1.0, 1.0, 1.0, 1.0))
    opt = Options.from_json(jopt.to_json())
    for lp in (1, 2, 3):
        want = jcommon.init_point_state_from_dataset(
            jopt.replace(load_points=lp), jcreate(jopt, split="train"),
            jax.random.PRNGKey(0))
        got = tcommon.init_point_state_from_dataset(
            opt.replace(load_points=lp), create_dataset(opt, "train"),
            device="cpu")
        _assert_state_equal(got, want)
    # a cloud_path pickle replaces every load_points source, in both
    import pickle
    cpath = os.path.join(root, "cloud.pkl")
    with open(cpath, "wb") as f:
        pickle.dump({"point_xyz": np.random.RandomState(1).uniform(
            -0.4, 0.4, (300, 3)).astype(np.float32)}, f)
    for lp in (2, 3):
        jc = jopt.replace(load_points=lp, cloud_path=cpath, num_point=200,
                          point_noise="pointuniformadd_0.01")
        want = jcommon.init_point_state_from_dataset(
            jc, jcreate(jc, split="train"), jax.random.PRNGKey(0))
        oc = Options.from_json(jc.to_json())
        got = tcommon.init_point_state_from_dataset(
            oc, create_dataset(oc, "train"), device="cpu")
        _assert_state_equal(got, want)


def test_scannet_grey_frame_is_refused(tmp_path):
    """A grey colour JPEG: JAX's `np.asarray(img)[..., :3]` keeps the first
    three columns of its one channel; the port raises (ROADMAP §3)."""
    root = str(tmp_path)
    make_scannet_scene(root, n=5, wh=(40, 30))
    p = os.path.join(root, SCAN, "exported", "color", "0.jpg")
    from PIL import Image
    Image.fromarray(read_jpeg(p)[..., 0]).save(p, "JPEG", quality=90)
    jopt, opt = _opts(root)
    assert jcreate(jopt, split="train").render_gtimgs[0].shape == (30, 3)
    with pytest.raises(ValueError, match="grey JPEG"):
        create_dataset(opt, "train")


def _driver_opt(root, ckpt, **kw):
    """The JAX package's ScanNet end-to-end options (tests/
    test_datasets_extra.py), load_points 2, 30 steps."""
    jopt = JOptions(
        experiment="scannet_e2e", checkpoints_dir=ckpt,
        data_root=root, scan=SCAN,
        dataset_name="scannet_ft", img_wh=(40, 30), load_points=2,
        random_sample="random", random_sample_size=10,
        near_plane=0.1, far_plane=8.0, bg_color="black", test_num_step=5,
        ranges=(-0.55, -0.55, -0.2, 0.55, 0.55, 0.2),
        vsize=(0.04, 0.04, 0.04), vscale=(1, 1, 1),
        kernel_size=(3, 3, 3), query_size=(3, 3, 3),
        max_o=16384, P=8, K=4, SR=12, z_depth_dim=64, vox_res=50,
        point_features_dim=16, shading_feature_num=32,
        shading_feature_mlp_layer1=1, shading_feature_mlp_layer3=1,
        shading_alpha_mlp_layer=1, shading_color_mlp_layer=2,
        num_feat_freqs=2, dist_xyz_freq=3, num_viewdir_freqs=2,
        default_conf=0.4, lr=0.002, plr=0.005,
        maximum_step=30, print_freq=15, save_iter_freq=30, test_freq=0,
        test_num=1, prune_iter=0, prob_freq=0, save_point_freq=0).replace(
            **kw)
    return jopt, Options.from_json(jopt.to_json())


def test_scannet_driver_from_sensor_depth_matches_jax(sc_root, tmp_path):
    """train_ft.main with load_points 2 (the preset's init): 30 steps, a
    checkpoint, and a final PSNR within 1.5 dB of the JAX driver's; the
    checkpoint renders the render split through test_ft's helpers."""
    jopt, _ = _driver_opt(sc_root, str(tmp_path / "jax"))
    want = jdriver.main(jopt)
    _, opt = _driver_opt(sc_root, str(tmp_path / "port"))
    res = tdriver.main(opt, device="cpu")
    assert res["total_steps"] == 30 and np.isfinite(res["final_psnr"])
    assert res["final_psnr"] > 8.0
    assert abs(res["final_psnr"] - want["final_psnr"]) < 1.5, \
        (res["final_psnr"], want["final_psnr"])
    n0 = len(tcommon.init_point_state_from_dataset(
        opt, create_dataset(opt, "train"), device="cpu")["xyz"])
    assert n0 > 100
    assert os.path.exists(os.path.join(str(tmp_path / "port"),
                                       "scannet_e2e", "30_full.npz"))


def test_make_scannet_scene_matches_the_fixture(tmp_path):
    """run/workload.make_scannet_scene at the fixture's arguments: the same
    poses, intrinsics, depth pixels and ply points; colours within JPEG
    tolerance (another encoder). At the sensor sizes the two intrinsics
    share one field of view and the depths lie in read_depth's range."""
    a = make_scannet_scene(str(tmp_path / "fixture"), n=10, wh=(40, 30))
    b = port_scene(str(tmp_path / "port"), n=10, wh=(40, 30))
    ea, eb = (os.path.join(s, "exported") for s in (a, b))
    for sub in ("pose", "intrinsic"):
        names = sorted(os.listdir(os.path.join(ea, sub)))
        assert names == sorted(os.listdir(os.path.join(eb, sub)))
        for f in names:
            np.testing.assert_array_equal(
                np.loadtxt(os.path.join(eb, sub, f)),
                np.loadtxt(os.path.join(ea, sub, f)))
    for i in range(10):
        np.testing.assert_array_equal(
            read_png(os.path.join(eb, "depth", f"{i}.png")),
            read_png(os.path.join(ea, "depth", f"{i}.png")))
        ca = read_jpeg(os.path.join(ea, "color", f"{i}.jpg")).astype(int)
        cb = read_jpeg(os.path.join(eb, "color", f"{i}.jpg")).astype(int)
        assert np.abs(ca - cb).max() <= 8
    from pointnerf_tpu_torch.data.ply import read_ply_points
    np.testing.assert_array_equal(
        read_ply_points(os.path.join(eb, "pcd.ply"))[0],
        read_ply_points(os.path.join(ea, "pcd.ply"))[0])
    c = port_scene(str(tmp_path / "sensor"), n=2, wh=(1296, 968),
                   depth_wh=(640, 480), half=2.0, radius=2.0, side=5)
    ec = os.path.join(c, "exported")
    kc = np.loadtxt(os.path.join(ec, "intrinsic", "intrinsic_color.txt"))
    kd = np.loadtxt(os.path.join(ec, "intrinsic", "intrinsic_depth.txt"))
    assert kc[0, 0] / 1296 == pytest.approx(kd[0, 0] / 640)
    assert read_jpeg(os.path.join(ec, "color", "0.jpg")).shape == \
        (968, 1296, 3)
    d = read_png(os.path.join(ec, "depth", "1.png"))
    assert d.dtype == np.uint16 and d.shape == (480, 640)
    hit = d[d > 0]
    assert hit.size > 0.5 * d.size and 300 < hit.min() and hit.max() < 8000
