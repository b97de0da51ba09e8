"""The legacy NeRF-Synthetic dataset (`nerf_synth_ft`) against the JAX
package's `NerfSynthFtDataset`, on the cases of
tests/test_datasets_extra.py:229-302: the pairs file's view groups and
their remap to id positions, the extra init groups, the test and val ids
from pairs.th (TRAIN frames), the fixed [2, 6] near/far, the render path's
blender ray directions and distance-derived planes, the fallbacks without
the tables, and normview.

Everything comes from the same files through the same float64 numpy, so
arrays are equal; the MVS init from the pairs groups is held at rtol =
atol = 1e-4 (conv stacks in another summation order, as
tests/test_torch_port_mvs.py states).
"""

import os

import numpy as np
import jax
import pytest

from pointnerf_tpu.config import Options as JOptions
from pointnerf_tpu.data import _REGISTRY as JREGISTRY
from pointnerf_tpu.data import create_dataset as jcreate
from pointnerf_tpu.data import find_dataset_class_by_name as jfind
from pointnerf_tpu.data.nerf_synth_ft import load_pairs_txt as jload_pairs
from pointnerf_tpu.run import common as jcommon
from pointnerf_tpu_torch.config import Options
from pointnerf_tpu_torch.data import PORTED, create_dataset
from pointnerf_tpu_torch.data import find_dataset_class_by_name
from pointnerf_tpu_torch.data.nerf_synth_ft import (load_pairs_th,
                                                    load_pairs_txt)
from pointnerf_tpu_torch.run import common as tcommon
from pointnerf_tpu_torch.run import workload

from fixtures import make_nerf_synth_scene
from test_datasets_extra import _write_legacy_configs
from test_torch_port_mvs import NET_TOL, mvs_params, n
from test_torch_port_mvs_points import lego_like

ARRAYS = ("intrinsics", "cam2worlds", "world2cams", "near_far")
IMAGES = ("render_gtimgs", "mvsimgs", "alphas", "depths")


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """A 12-view plate with the legacy tables, and an 8-view one without
    them (the fallbacks)."""
    legacy = str(tmp_path_factory.mktemp("legacy"))
    make_nerf_synth_scene(legacy, wh=(40, 40), n_train=12)
    _write_legacy_configs(legacy)
    plain = str(tmp_path_factory.mktemp("plain"))
    make_nerf_synth_scene(plain, wh=(40, 40), n_train=8)
    return {"legacy": legacy, "plain": plain}


def _opts(root, **kw):
    jopt = JOptions(**dict(dict(
        data_root=root, scan="plate", dataset_name="nerf_synth_ft",
        img_wh=(40, 40), random_sample="random", random_sample_size=6,
        near_plane=2.0, far_plane=4.5, bg_color="white", testskip=2), **kw))
    return jopt, Options.from_json(jopt.to_json())


def _same_item(a, b):
    assert sorted(a) == sorted(b)
    for k, v in b.items():
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(v),
                                      err_msg=k)


@pytest.mark.parametrize("normview", [0, 1])
@pytest.mark.parametrize("which", ["legacy", "plain"])
def test_nerf_synth_ft_dataset_matches_jax(roots, which, normview):
    """Every split's ids, groups, cameras, images and items; the init
    bundle of every view group (the extra ones too); the render path with
    the CLI planes and with planes from the camera distance."""
    jopt, opt = _opts(roots[which], normview=normview)
    for split in ("train", "test", "val", "render"):
        t, j = create_dataset(opt, split), jcreate(jopt, split=split)
        assert t.id_list == j.id_list and len(t) == len(j)
        assert t.view_id_list == j.view_id_list
        assert t.test_id_list == j.test_id_list and t.focal == j.focal
        for k in ARRAYS:
            np.testing.assert_array_equal(getattr(t, k), getattr(j, k),
                                          err_msg=k)
        if split == "render":
            np.testing.assert_array_equal(t.render_poses, j.render_poses)
            for o in (opt, opt.replace(near_plane=0.0, far_plane=0.0)):
                t.opt = o
                j.opt = jopt.replace(near_plane=o.near_plane,
                                     far_plane=o.far_plane)
                for i in (0, 7):
                    _same_item(t.get_dummyrot_item(i, np.random.RandomState(1)),
                               j.get_dummyrot_item(i, np.random.RandomState(1)))
            continue
        for k in IMAGES:
            for a, b in zip(getattr(t, k), getattr(j, k)):
                np.testing.assert_array_equal(a, b, err_msg=k)
        for i in range(len(j)):
            _same_item(t.get_item(i, np.random.RandomState(i)),
                       j.get_item(i, np.random.RandomState(i)))
        item = t.get_item(0, full_img=True)
        assert float(item["near"]) == 2.0 and float(item["far"]) == 6.0
        for g in range(len(j.view_id_list)):
            _same_item(t.get_init_item(g), j.get_init_item(g))
    if which == "legacy":
        assert create_dataset(opt, "train").id_list == [0, 1, 2, 3]
        assert len(create_dataset(opt, "train").view_id_list) == 6
        assert create_dataset(opt, "test").id_list == [4, 5, 6]
        assert create_dataset(opt, "val").id_list == [4]
    else:
        assert create_dataset(opt, "test").id_list == [0, 2, 4, 6]
    if normview:
        ds = create_dataset(opt, "train")
        first = 4 if which == "legacy" else 0
        pose = ds.cam2worlds[ds.id_list.index(first)] \
            if first in ds.id_list else None
        if pose is not None:
            np.testing.assert_allclose(pose, np.eye(4), atol=1e-5)


def test_pairs_tables_match_jax(roots, tmp_path):
    """load_pairs_txt, a src view that is no ref view (ValueError in
    both), and run/workload.write_legacy_pairs against the tests'
    _write_legacy_configs."""
    path = os.path.join(roots["legacy"], "nerf_synth_configs", "list",
                        "plate_finetune_init_pairs_final.txt")
    assert load_pairs_txt(path) == tuple(jload_pairs(path))
    root = str(tmp_path)
    workload.write_legacy_pairs(root, n_ref=5, n_extra=3, n_test=2)
    _write_legacy_configs(os.path.join(root, "f"), n_ref=5, n_extra=3,
                          n_test=2)
    for rel in (os.path.join("nerf_synth_configs", "list",
                             "plate_finetune_init_pairs_final.txt"),):
        with open(os.path.join(root, rel)) as a, \
                open(os.path.join(root, "f", rel)) as b:
            assert a.read() == b.read()
    th = os.path.join("dtu_configs", "pairs.th")
    assert load_pairs_th(os.path.join(root, th)) == \
        load_pairs_th(os.path.join(root, "f", th)) == \
        {"plate_test": [5, 6], "plate_val": [5]}
    bad = str(tmp_path / "bad")
    make_nerf_synth_scene(bad, wh=(20, 20), n_train=6, n_test=1)
    lst = os.path.join(bad, "nerf_synth_configs", "list")
    os.makedirs(lst)
    with open(os.path.join(lst, "plate_finetune_init_pairs_final.txt"),
              "w") as f:
        f.write("2,2\n0\n1,5\n1\n0,0\n")
    jopt, opt = _opts(bad, img_wh=(20, 20))
    for make, o in ((create_dataset, opt), (jcreate, jopt)):
        with pytest.raises(ValueError, match="src view 5"):
            make(o, "train")


def test_every_jax_dataset_is_ported():
    """find_dataset_class_by_name raises for no name the JAX package
    registers."""
    jfind("nerf_synth360_ft")           # imports every JAX dataset
    assert set(JREGISTRY) == set(PORTED)
    for name in PORTED:
        assert find_dataset_class_by_name(name).__name__ == \
            JREGISTRY[name].__name__


def test_mvs_points_from_pairs_groups_match_jax(tmp_path):
    """The MVS init (load_points 0) over a ref group and an extra group of
    the pairs file, on a 64x64 legacy scene: the same point count, the
    state at NET_TOL (mask exactly). With random weights the init finds
    the plate only in the plate's depth range, so both datasets' fixed
    [2, 6] is cut to lego_like's 2.5-3.5, as chip_smoke's MVS phases cut
    it."""
    root = str(tmp_path)
    make_nerf_synth_scene(root, wh=(64, 64), n_train=8, n_test=2)
    workload.write_legacy_pairs(root)
    jopt, topt = (o.replace(dataset_name="nerf_synth_ft")
                  for o in lego_like(root))
    p, mvs = mvs_params(jopt)
    jds, tds = jcreate(jopt, split="train"), create_dataset(topt, "train")
    assert tds.view_id_list == jds.view_id_list and len(jds.view_id_list) == 6
    for ds in (jds, tds):
        ds.view_id_list = [ds.view_id_list[0], ds.view_id_list[5]]
        ds.near_far = np.array([2.5, 3.5], np.float32)
    want = jcommon.gen_points_filter_embeddings(
        jopt, jds, jax.random.PRNGKey(0), mvs_params=p)
    stats = {}
    got = tcommon.gen_points_filter_embeddings(topt, tds, mvs=mvs,
                                               device="cpu", stats=stats)
    assert stats["triplets"] == 2 and stats["n_vox"] > 100
    np.testing.assert_array_equal(n(got["mask"]), n(want["mask"]))
    m = n(want["mask"])
    for k in ("xyz", "embedding", "color", "dir", "conf"):
        np.testing.assert_allclose(n(got[k])[m], n(want[k])[m], err_msg=k,
                                   **NET_TOL)
