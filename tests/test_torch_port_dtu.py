"""DTU dataset parity: the port's `data/dtu.py` (numpy, its own PNG codec
and nearest resizes) against the JAX package's (cv2 and Pillow), on
tests/fixtures.py::make_dtu_scene and on the port's own
run/workload.make_dtu_scene. Every array equal exactly.
"""

import os

import cv2
import numpy as np
import pytest

from pointnerf_tpu.data import create_dataset as jcreate
from pointnerf_tpu.data.pfm import read_pfm as jread_pfm
from pointnerf_tpu_torch.config import Options
from pointnerf_tpu_torch.data import create_dataset
from pointnerf_tpu_torch.data.dtu import resize_nearest_cv2
from pointnerf_tpu_torch.data.pfm import read_pfm, write_pfm
from pointnerf_tpu_torch.run.workload import make_dtu_scene as port_scene
from pointnerf_tpu_torch.utils.png import read_png

from fixtures import make_dtu_scene
from test_generalizable import gen_opt


@pytest.fixture(scope="module")
def dtu_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dtu"))
    make_dtu_scene(root, n_views=6, wh=(64, 64))
    return root


def _same(a, b, path=""):
    if isinstance(b, dict):
        assert set(a) == set(b), path
        for k in b:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(b, (str, int, float, np.floating, np.integer)):
        assert a == b, path
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)
        assert np.asarray(a).dtype == np.asarray(b).dtype, path


def _both(root, split, **kw):
    jopt = gen_opt(root, **kw)
    return (create_dataset(Options.from_json(jopt.to_json()), split),
            jcreate(jopt, split=split))


@pytest.mark.parametrize("split", ["train", "test"])
def test_dtu_dataset_matches_jax(dtu_root, split):
    """Metas, camera tables, two items (bundle, rays, gt) and a full-image
    item, with the same RandomStates."""
    ds, jds = _both(dtu_root, split)
    assert len(ds) == len(jds) == (42 if split == "train" else 6)
    assert ds.metas == jds.metas
    for k in ("id_list", "remap", "intrinsics", "world2cams", "cam2worlds",
              "near_far"):
        _same(getattr(ds, k), getattr(jds, k), k)
    for (a, na), (b, nb) in zip(ds.affines, jds.affines):
        np.testing.assert_array_equal(a, b)
        assert na == nb
    for idx in (0, 5):
        got = ds.get_item(idx, rng=np.random.RandomState(idx))
        want = jds.get_item(idx, rng=np.random.RandomState(idx))
        _same(got, want)
    _same(ds.get_item(2, full_img=True), jds.get_item(2, full_img=True))


def test_dtu_depth_chain_matches_jax(dtu_root):
    """read_depth's nearest halving, crop and resize to img_wh (96x64 here,
    so the second resize runs) equal cv2's."""
    ds, jds = _both(dtu_root, "test", img_wh=(96, 64))
    path = os.path.join(dtu_root, "Depths_raw/scan1/depth_map_0002.pfm")
    _same(ds.read_depth(path), jds.read_depth(path))


@pytest.mark.parametrize("src,dst", [
    ((1200, 1600), None), ((512, 640), (96, 64)), ((37, 53), (20, 11)),
    ((11, 7), (64, 96)), ((33, 65), (65, 33))])
def test_nearest_resize_matches_cv2(src, dst):
    """resize_nearest_cv2 against cv2.resize(INTER_NEAREST): by scale
    factor 0.5 (dst None) and to an explicit size, down and up."""
    a = np.random.RandomState(0).rand(*src).astype(np.float32)
    if dst is None:
        want = cv2.resize(a, None, fx=0.5, fy=0.5,
                          interpolation=cv2.INTER_NEAREST)
        got = resize_nearest_cv2(
            a, (round(src[1] * 0.5), round(src[0] * 0.5)), (2.0, 2.0))
    else:
        want = cv2.resize(a, dst, interpolation=cv2.INTER_NEAREST)
        got = resize_nearest_cv2(a, dst)
    np.testing.assert_array_equal(got, want)


def test_pfm_roundtrip_matches_jax(tmp_path):
    a = np.random.RandomState(1).rand(5, 7).astype(np.float32)
    c = np.random.RandomState(2).rand(4, 3, 3).astype(np.float32)
    for img in (a, c):
        path = str(tmp_path / "x.pfm")
        write_pfm(path, img, scale=2.0)
        got, want = read_pfm(path), jread_pfm(path)
        np.testing.assert_array_equal(got[0], img)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1] == 2.0


def test_port_dtu_scene_reads_alike(tmp_path, dtu_root):
    """run/workload.make_dtu_scene at the fixture's size writes the
    fixture's scene, file for file; at 96x64 the port and JAX read its
    items alike."""
    root = str(tmp_path / "port")
    port_scene(root, n_views=6, wh=(64, 64))
    for dirpath, _, files in os.walk(dtu_root):
        rel = os.path.relpath(dirpath, dtu_root)
        for f in files:
            if f.endswith(".png"):
                np.testing.assert_array_equal(
                    read_png(os.path.join(root, rel, f)),
                    cv2.cvtColor(cv2.imread(os.path.join(dirpath, f)),
                                 cv2.COLOR_BGR2RGB))
            else:
                with open(os.path.join(root, rel, f), "rb") as a, \
                        open(os.path.join(dirpath, f), "rb") as b:
                    assert a.read() == b.read(), os.path.join(rel, f)
    root2 = str(tmp_path / "wide")
    port_scene(root2, n_views=5, wh=(96, 64))
    ds, jds = _both(root2, "train", img_wh=(96, 64))
    _same(ds.get_item(3, rng=np.random.RandomState(0)),
          jds.get_item(3, rng=np.random.RandomState(0)))
    d = ds.get_init_item(1)["depths_h"][0]
    assert 2.0 < d[d > 0].mean() < 4.0


def test_dtu_image_size_must_match(dtu_root):
    """A PNG of another size than img_wh is resized with Pillow's BILINEAR
    in both packages: the bundles are equal exactly. img_wh must still be
    a multiple of 32 in both."""
    ds, jds = _both(dtu_root, "test", img_wh=(96, 64))
    got = ds.get_init_item(0)
    assert got["images"].shape[-2:] == (64, 96)
    _same(got, jds.get_init_item(0))
    with pytest.raises(ValueError, match="multiples of 32"):
        _both(dtu_root, "test", img_wh=(70, 64))
