"""The Tanks&Temples dataset (`data/tt_ft.py`) against the JAX package's,
on the fixture scene of `tests/fixtures.py::make_tt_scene` (40×40 RGBA
views, NSVF layout): the train, test and render splits, the point init from
the scene's fused.ply, a size that differs from img_wh, and the
`load_points 0` init of `tt_preset`, which has no view triplets and fails in
both drivers with a ValueError.

The same numpy code runs on both sides, so the splits are held within 1e-6
(rays, gt_image, alphas, bbox, intrinsics, the 100 render poses) and the
point init exactly. `run/workload.make_tt_scene`, the port's writer of the
same scene for the chip smoke, is held to the fixture byte for byte in its
images and to its poses, intrinsics and bbox.
"""

import os

import numpy as np
import jax
import pytest

from pointnerf_tpu.config import Options as JOptions, tt_preset as jtt_preset
from pointnerf_tpu.data import create_dataset as jcreate
from pointnerf_tpu.data.ply import write_ply_points
from pointnerf_tpu.run import common as jcommon
from pointnerf_tpu.run import train_ft as jdriver
from pointnerf_tpu_torch.config import Options
from pointnerf_tpu_torch.data import create_dataset
from pointnerf_tpu_torch.run import common as tcommon
from pointnerf_tpu_torch.run import train_ft as tdriver
from pointnerf_tpu_torch.run.workload import make_tt_scene as port_scene
from pointnerf_tpu_torch.utils.png import read_png

from fixtures import make_tt_scene

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def tt_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tt"))
    make_tt_scene(root, wh=(40, 40))
    os.makedirs(os.path.join(root, "Truck", "colmap_results", "dense"))
    rng = np.random.RandomState(1)
    xyz = np.concatenate([rng.uniform(-0.4, 0.4, (600, 2)),
                          rng.normal(0, 0.003, (600, 1))], -1)
    write_ply_points(os.path.join(root, "Truck", "colmap_results", "dense",
                                  "fused.ply"), xyz.astype(np.float32),
                     rng.rand(600, 3))
    return root


def _opts(root, **kw):
    jopt = JOptions(data_root=root, scan="Truck", dataset_name="tt_ft",
                    img_wh=(40, 40), random_sample="random",
                    random_sample_size=6, near_plane=1.5, far_plane=5.0,
                    bg_color="white", ranges=(-100.0,) * 3 + (100.0,) * 3,
                    load_points=1, vox_res=0, point_features_dim=8,
                    feature_init_method="rand").replace(**kw)
    return jopt, Options.from_json(jopt.to_json())


def _same_item(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_allclose(np.asarray(b[k], np.float64),
                                   np.asarray(a[k], np.float64), **TOL,
                                   err_msg=k)


@pytest.mark.parametrize("ranges", [(-100.0,) * 3 + (100.0,) * 3,
                                    (-0.3, -0.3, -0.1, 0.3, 0.3, 0.1)])
def test_tt_splits_match_jax(tt_root, ranges):
    jopt, opt = _opts(tt_root, ranges=ranges)
    for split, n in (("train", 6), ("test", 2)):
        jds, tds = jcreate(jopt, split=split), create_dataset(opt, split)
        assert len(tds) == len(jds) == n
        for name in ("spacemin", "spacemax", "intrinsics", "cam2worlds",
                     "world2cams", "near_far"):
            np.testing.assert_allclose(getattr(tds, name),
                                       getattr(jds, name), **TOL,
                                       err_msg=name)
        for name in ("render_gtimgs", "mvsimgs", "alphas", "depths"):
            np.testing.assert_allclose(np.stack(getattr(tds, name)),
                                       np.stack(getattr(jds, name)), **TOL,
                                       err_msg=name)
        assert tds.view_id_list == jds.view_id_list == []
        for i in (0, n - 1):
            for full in (False, True):
                _same_item(jds.get_item(i, np.random.RandomState(i),
                                        full_img=full),
                           tds.get_item(i, np.random.RandomState(i),
                                        full_img=full))
    for a, b in zip(jcreate(jopt, split="train").get_campos_ray(),
                    create_dataset(opt, "train").get_campos_ray()):
        np.testing.assert_allclose(b, a, **TOL)


def test_tt_render_split_matches_jax(tt_root):
    jopt, opt = _opts(tt_root)
    jds, tds = jcreate(jopt, split="render"), create_dataset(opt, "render")
    assert len(tds) == len(jds) == 100
    np.testing.assert_allclose(tds.render_poses, jds.render_poses, **TOL)
    for i in (0, 37, 99):
        a = jds.get_dummyrot_item(i, np.random.RandomState(0))
        b = tds.get_dummyrot_item(i, np.random.RandomState(0))
        assert "gt_image" not in b
        _same_item(a, b)


def test_tt_point_init_matches_jax(tt_root):
    """load_points 1: the scene's fused.ply cropped, with directions to the
    nearest train camera and the seeded embeddings."""
    for ranges in ((-100.0,) * 3 + (100.0,) * 3,
                   (-0.3, -0.3, -0.1, 0.3, 0.3, 0.1)):
        jopt, opt = _opts(tt_root, ranges=ranges)
        want = jcommon.init_point_state_from_dataset(
            jopt, jcreate(jopt, split="train"), jax.random.PRNGKey(0))
        got = tcommon.init_point_state_from_dataset(
            opt, create_dataset(opt, "train"), device="cpu")
        for k, v in want.items():
            if v is None:
                assert got.get(k) is None, k
            else:
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                              err_msg=k)


def test_tt_image_size_mismatch_raises(tt_root):
    _, opt = _opts(tt_root, img_wh=(32, 24))
    with pytest.raises(ValueError, match="img_wh"):
        create_dataset(opt, "train")


def test_tt_preset_mvs_init_fails_in_both(tt_root, tmp_path):
    """tt_preset leaves load_points 0 and tt_ft defines no view triplets:
    the JAX driver stops concatenating no MVS rows (ValueError), the port
    raises ValueError naming load_points before building the nets."""
    jopt = jtt_preset("Truck").replace(
        data_root=tt_root, img_wh=(40, 40), checkpoints_dir=str(tmp_path),
        maximum_step=2, random_sample_size=8)
    assert jopt.load_points == 0
    with pytest.raises(ValueError):
        jdriver.main(jopt)
    opt = Options.from_json(jopt.to_json())
    with pytest.raises(ValueError, match="load_points"):
        tdriver.main(opt, device="cpu")


def test_workload_tt_scene_is_the_fixture(tmp_path):
    a, b = str(tmp_path / "fixture"), str(tmp_path / "port")
    make_tt_scene(a, wh=(40, 30))
    n = port_scene(b, wh=(40, 30))
    assert n == 900
    for sub in ("rgb", "pose"):
        names = sorted(os.listdir(os.path.join(a, "Truck", sub)))
        assert names == sorted(os.listdir(os.path.join(b, "Truck", sub)))
        for name in names:
            pa, pb = (os.path.join(r, "Truck", sub, name) for r in (a, b))
            if sub == "rgb":
                np.testing.assert_array_equal(read_png(pb), read_png(pa))
            else:
                np.testing.assert_array_equal(np.loadtxt(pb),
                                              np.loadtxt(pa))
    for name in ("intrinsics.txt", "bbox.txt"):
        np.testing.assert_array_equal(
            np.loadtxt(os.path.join(b, "Truck", name)),
            np.loadtxt(os.path.join(a, "Truck", name)))
    _, opt = _opts(b, img_wh=(40, 30))
    assert len(create_dataset(opt, "train").load_init_points()) == 900


@pytest.mark.parametrize("text", ["40 20.5 19.5 0.\n0. 0. 0.\n1.\n40 40\n",
                                  "40 0 20.5\n0 40 19.5\n0 0 1\n"])
def test_tt_intrinsics_forms_match_jax(tmp_path, text):
    """intrinsics.txt in the DeepVoxels form (a first line 'f cx cy _',
    then lines of other lengths) or as a matrix."""
    from pointnerf_tpu.data.tt_ft import read_intrinsics as jread
    from pointnerf_tpu_torch.data.tt_ft import read_intrinsics
    path = tmp_path / "intrinsics.txt"
    path.write_text(text)
    np.testing.assert_array_equal(read_intrinsics(str(path)),
                                  jread(str(path)))
    np.testing.assert_array_equal(read_intrinsics(str(path))[:2, 2],
                                  [20.5, 19.5])
