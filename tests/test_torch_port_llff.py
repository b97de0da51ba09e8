"""The LLFF dataset (`llff_ft`) against the JAX package's `LlffFtDataset`.

Poses, near/far, splits, intrinsics, items, the render path and
load_init_points come from the same files through float64 numpy in both
packages and must be equal; the render path passes scipy's Euler
conversions and is held at 1e-6. Images: the port's PNG and JPEG decoders
and its LANCZOS resampler give Pillow's bytes, so the float images are
equal too. The driver on an LLFF scene is held to the JAX driver's PSNR
within 1.5 dB (its randomness is another).
"""

import os

import numpy as np
import pytest

from pointnerf_tpu.config import Options as JOptions
from pointnerf_tpu.data import create_dataset as jcreate
from pointnerf_tpu.run import train_ft as jdriver
from pointnerf_tpu_torch.config import Options
from pointnerf_tpu_torch.data import create_dataset
from pointnerf_tpu_torch.data.llff_ft import read_rgb
from pointnerf_tpu_torch.data.ply import read_ply_points, write_ply_points
from pointnerf_tpu_torch.run import train_ft as tdriver
from pointnerf_tpu_torch.run import workload
from pointnerf_tpu_torch.utils.jpeg import write_jpeg
from pointnerf_tpu_torch.utils.png import read_png, write_png

from fixtures import make_llff_scene

POSE_TOL = dict(rtol=0, atol=1e-6)


def _opts(root, **kw):
    jopt = JOptions(**dict(dict(
        data_root=root, scan="fern", dataset_name="llff_ft", img_wh=(40, 30),
        random_sample="random", random_sample_size=6, bg_color="white"),
        **kw))
    return jopt, Options.from_json(jopt.to_json())


@pytest.fixture(scope="module")
def llff_root(tmp_path_factory):
    """The fixture's 9-view scene, plus a fused.ply of the plate."""
    root = str(tmp_path_factory.mktemp("llff"))
    make_llff_scene(root, n=9, wh=(40, 30))
    xyz = workload.plate_points(20)
    dense = os.path.join(root, "fern", "colmap_results", "dense")
    os.makedirs(dense)
    write_ply_points(os.path.join(dense, "fused.ply"), xyz.astype(np.float32),
                     workload.plate_color(xyz[:, 0], xyz[:, 1]))
    return root


def _same_items(t, j, idx, full_img):
    a = t.get_item(idx, rng=np.random.RandomState(3), full_img=full_img)
    b = j.get_item(idx, rng=np.random.RandomState(3), full_img=full_img)
    assert sorted(a) == sorted(b)
    for k, v in b.items():
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(v),
                                      err_msg=k)


def _same_dataset(t, j):
    assert t.id_list == j.id_list and len(t) == len(j)
    assert t.focal == j.focal and t.img_wh == j.img_wh
    np.testing.assert_array_equal(t.near_far, j.near_far)
    for k in ("all_c2ws", "cam2worlds", "world2cams", "intrinsics"):
        np.testing.assert_allclose(getattr(t, k), getattr(j, k), **POSE_TOL,
                                   err_msg=k)
        assert getattr(t, k).dtype == getattr(j, k).dtype, k


@pytest.mark.parametrize("testskip", [1, 4, 8])
def test_llff_dataset_matches_jax(llff_root, testskip):
    """train, test and render splits under the holdoff max(2, testskip)
    (testskip 1, the default, holds out every second view)."""
    jopt, opt = _opts(llff_root, testskip=testskip)
    for split in ("train", "test"):
        t, j = create_dataset(opt, split), jcreate(jopt, split=split)
        _same_dataset(t, j)
        for a, b in zip(t.render_gtimgs, j.render_gtimgs):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        for i in range(len(j)):
            _same_items(t, j, i, full_img=False)
        _same_items(t, j, 0, full_img=True)
        for a, b in zip(t.get_campos_ray(), j.get_campos_ray()):
            np.testing.assert_allclose(a, b, **POSE_TOL)
    holdoff = max(2, testskip)
    assert create_dataset(opt, "test").id_list == list(range(9))[::holdoff]
    t, j = create_dataset(opt, "render"), jcreate(jopt, split="render")
    _same_dataset(t, j)
    assert len(t) == len(j) == len(t.id_list) * 10
    np.testing.assert_allclose(t.render_poses, j.render_poses, **POSE_TOL)
    a = t.get_dummyrot_item(3, rng=np.random.RandomState(0))
    b = j.get_dummyrot_item(3, rng=np.random.RandomState(0))
    assert sorted(a) == sorted(b) and "gt_image" not in a
    for k, v in b.items():
        np.testing.assert_allclose(np.asarray(a[k]), np.asarray(v),
                                   **POSE_TOL, err_msg=k)
    np.testing.assert_array_equal(t.load_init_points(), j.load_init_points())


def test_llff_images_of_another_size_match_jax(llff_root):
    """img_wh smaller and larger than the files: Pillow's LANCZOS in both;
    the focal scales with the size."""
    for wh in ((32, 24), (52, 39)):
        jopt, opt = _opts(llff_root, img_wh=wh, testskip=4)
        t, j = create_dataset(opt, "train"), jcreate(jopt, split="train")
        _same_dataset(t, j)
        for a, b in zip(t.render_gtimgs, j.render_gtimgs):
            assert a.shape == (wh[1], wh[0], 3)
            np.testing.assert_array_equal(a, b)


def test_llff_reads_jpeg_grey_and_alpha_images_as_jax(llff_root, tmp_path):
    """No images_4/: images/ holds baseline JPEGs (4:2:0) and PNGs that are
    grey, grey + alpha and RGBA; both packages read them as Pillow's
    .convert("RGB") (grey replicated, alpha dropped), and resize them."""
    root = str(tmp_path)
    scene = os.path.join(root, "fern")
    os.makedirs(os.path.join(scene, "images"))
    src = os.path.join(llff_root, "fern")
    os.link(os.path.join(src, "poses_bounds.npy"),
            os.path.join(scene, "poses_bounds.npy"))
    rng = np.random.RandomState(1)
    for i in range(9):
        rgb = read_png(os.path.join(src, "images_4", f"image{i:03d}.png"))
        noisy = np.clip(rgb + rng.randint(-20, 20, rgb.shape), 0, 255)
        rgb = noisy.astype(np.uint8)
        a = rng.randint(0, 256, rgb.shape[:2]).astype(np.uint8)
        path = os.path.join(scene, "images", f"IMG_{i:04d}")
        kind = i % 4
        if kind == 0:
            write_jpeg(path + ".JPG", rgb, quality=80)
        elif kind == 1:
            write_png(path + ".png", rgb[..., 1])
        elif kind == 2:
            write_png(path + ".png", np.stack([rgb[..., 0], a], -1))
        else:
            write_png(path + ".png", np.concatenate([rgb, a[..., None]], -1))
    for wh in ((40, 30), (36, 27)):
        jopt, opt = _opts(root, img_wh=wh)
        for split in ("train", "test"):
            t, j = create_dataset(opt, split), jcreate(jopt, split=split)
            for a, b in zip(t.render_gtimgs, j.render_gtimgs):
                np.testing.assert_array_equal(a, b)
    bad = os.path.join(root, "bad.bmp")
    with open(bad, "wb") as f:
        f.write(b"BM" + bytes(60))
    with pytest.raises(ValueError, match="neither PNG nor JPEG"):
        read_rgb(bad)


def test_workload_llff_scene_equals_the_fixture(tmp_path):
    """run/workload.make_llff_scene at the fixture's arguments: the same
    poses_bounds.npy and images (the port's PNG writer); its fused.ply
    lies on the plate in the loader's normalised frame."""
    make_llff_scene(str(tmp_path / "f"), n=9, wh=(40, 30))
    n = workload.make_llff_scene(str(tmp_path / "w"), n=9, wh=(40, 30),
                                 side=12)
    a, b = (str(tmp_path / d / "fern") for d in ("w", "f"))
    np.testing.assert_array_equal(np.load(os.path.join(a, "poses_bounds.npy")),
                                  np.load(os.path.join(b, "poses_bounds.npy")))
    for i in range(9):
        name = os.path.join("images_4", f"image{i:03d}.png")
        np.testing.assert_array_equal(read_png(os.path.join(a, name)),
                                      read_png(os.path.join(b, name)))
    jopt, opt = _opts(str(tmp_path / "w"))
    ds = create_dataset(opt, "train")
    xyz, rgb = read_ply_points(os.path.join(
        a, "colmap_results", "dense", "fused.ply"))
    assert len(xyz) == n == 144 and rgb is not None
    # the centre view's centre ray meets the cloud's plane near its middle
    c2w = ds.cam2worlds[len(ds) // 2]
    normal = np.linalg.svd(xyz - xyz.mean(0))[2][-1]
    d = c2w[:3, 2]
    t = np.dot(xyz.mean(0) - c2w[:3, 3], normal) / np.dot(d, normal)
    hit = c2w[:3, 3] + t * d
    assert t > 0 and np.linalg.norm(hit - xyz.mean(0)) < 0.3


def test_llff_driver_matches_jax(tmp_path):
    """A few finetune steps on an LLFF scene from its fused.ply in both
    drivers: final PSNR within 1.5 dB."""
    root = str(tmp_path)
    workload.make_llff_scene(root, n=9, wh=(40, 30), side=30)
    jopt = JOptions(
        experiment="llff", checkpoints_dir=os.path.join(root, "j"),
        load_points=1, data_root=root, scan="fern", dataset_name="llff_ft",
        img_wh=(40, 30), random_sample="random", random_sample_size=12,
        bg_color="white", testskip=4, vsize=(0.04, 0.04, 0.04),
        vscale=(1, 1, 1), kernel_size=(3, 3, 3), query_size=(3, 3, 3),
        max_o=16384, P=8, K=4, SR=12, z_depth_dim=64, radius_limit_scale=4.0,
        vox_res=64, point_features_dim=16, num_feat_freqs=2,
        dist_xyz_freq=3, num_viewdir_freqs=2, num_pos_freqs=4,
        shading_feature_num=32, shading_feature_mlp_layer1=1,
        shading_feature_mlp_layer3=1, shading_alpha_mlp_layer=1,
        shading_color_mlp_layer=2, which_tonemap_func="off",
        default_conf=0.4, lr=0.002, plr=0.005, maximum_step=40,
        prune_iter=0, prob_freq=0, print_freq=20, save_iter_freq=40,
        save_point_freq=0, test_freq=0, test_num=1)
    want = jdriver.main(jopt)
    got = tdriver.main(Options.from_json(jopt.replace(
        checkpoints_dir=os.path.join(root, "t")).to_json()), device="cpu")
    assert got["total_steps"] == want["total_steps"] == 40
    assert np.isfinite(got["final_psnr"]) and got["final_psnr"] > 8.0
    assert abs(got["final_psnr"] - want["final_psnr"]) < 1.5, \
        (got["final_psnr"], want["final_psnr"])
