"""The port's resampler (`utils/resize.py`) against Pillow's
`Image.resize`, uint8 for uint8: BILINEAR and LANCZOS on L, LA, RGB and
RGBA images (RGBA and LA through Pillow's premultiplied conversions, with
alphas of 0 and 255 among the others), shrinking, enlarging and one axis
only, at odd sizes; real DTU's raw 1600x1200 to its working 640x512; and
the NeRF-Synthetic dataset's items against the JAX package's when its
images differ from img_wh (the dtu and tt_ft cases are in
test_torch_port_dtu.py and test_torch_port_tt.py, dtu_ft's in
test_torch_port_dtu_ft.py). Every comparison is exact.
"""

import ast
import inspect

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st
from PIL import Image

from pointnerf_tpu.config import Options as JOptions
from pointnerf_tpu.data import create_dataset as jcreate
from pointnerf_tpu_torch.config import Options
from pointnerf_tpu_torch.data import create_dataset
from pointnerf_tpu_torch.utils import resize as rz

from fixtures import make_nerf_synth_scene

MODES = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}
FILTERS = {"bilinear": Image.Resampling.BILINEAR,
           "lanczos": Image.Resampling.LANCZOS}


def _pillow(img: np.ndarray, mode: str, size, name: str) -> np.ndarray:
    return np.asarray(Image.fromarray(img, mode).resize(size, FILTERS[name]))


def _image(rng, mode, w, h):
    img = rng.randint(0, 256, (h, w, MODES[mode])).astype(np.uint8)
    if mode in ("LA", "RGBA"):
        u = rng.rand(h, w)
        img[..., -1][u < 0.25] = 0
        img[..., -1][u > 0.75] = 255
    return img[..., 0] if mode == "L" else img


@st.composite
def cases(draw):
    mode = draw(st.sampled_from(sorted(MODES)))
    name = draw(st.sampled_from(sorted(FILTERS)))
    w, h = draw(st.integers(1, 41)), draw(st.integers(1, 41))
    kind = draw(st.sampled_from(["both", "x", "y"]))
    W = w if kind == "y" else draw(st.integers(1, 61))
    H = h if kind == "x" else draw(st.integers(1, 61))
    return mode, name, (w, h), (W, H), draw(st.integers(0, 2 ** 31 - 1))


@settings(max_examples=300, deadline=None)
@given(cases())
def test_resize_matches_pillow(case):
    mode, name, (w, h), size, seed = case
    img = _image(np.random.RandomState(seed), mode, w, h)
    got = rz.resize(img, size, name)
    want = _pillow(img, mode, size, name)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode,size,name", [
    ("RGBA", (7, 5), "lanczos"), ("RGBA", (61, 3), "bilinear"),
    ("L", (13, 29), "lanczos"), ("RGB", (1, 1), "bilinear"),
    ("RGB", (31, 17), "lanczos"), ("LA", (9, 40), "lanczos")])
def test_resize_matches_pillow_at_fixed_cases(mode, size, name):
    """Shrink and enlarge by odd factors, one pixel, and the extreme alphas
    beside every other value."""
    img = _image(np.random.RandomState(3), mode, 23, 19)
    if mode == "RGBA":
        img[..., 3] = np.arange(23 * 19).reshape(19, 23) % 256
    np.testing.assert_array_equal(rz.resize(img, size, name),
                                  _pillow(img, mode, size, name))


@pytest.mark.parametrize("smooth", [False, True])
def test_raw_dtu_size_to_working_size(smooth):
    """Real DTU's raw 1600x1200 RGB to its 640x512 working size with
    BILINEAR, the resize of the JAX package's dtu and dtu_ft loaders."""
    rng = np.random.RandomState(4)
    if smooth:
        y, x = np.mgrid[0:1200, 0:1600]
        img = np.stack([x * 255 // 1599, y * 255 // 1199,
                        (x + y) % 256], -1).astype(np.uint8)
    else:
        img = rng.randint(0, 256, (1200, 1600, 3)).astype(np.uint8)
    got = rz.resize(img, (640, 512), "bilinear")
    assert got.shape == (512, 640, 3)
    np.testing.assert_array_equal(got, _pillow(img, "RGB", (640, 512),
                                               "bilinear"))


def test_same_size_is_a_copy_and_bad_inputs_raise():
    img = _image(np.random.RandomState(5), "RGB", 8, 6)
    out = rz.resize(img, (8, 6))
    np.testing.assert_array_equal(out, img)
    assert out is not img
    with pytest.raises(ValueError, match="uint8"):
        rz.resize(img.astype(np.float32), (4, 4))
    with pytest.raises(ValueError, match="resample"):
        rz.resize(img, (4, 4), "bicubic")
    with pytest.raises(ValueError, match=">= 1"):
        rz.resize(img, (0, 4))


def test_resize_imports_no_pil():
    tree = ast.parse(inspect.getsource(rz))
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    assert not [m for m in names if m.split(".")[0] == "PIL"], names


def test_nerf_synth_items_resized_like_jax(tmp_path):
    """40x40 RGBA views read at img_wh 32x32 (LANCZOS through premultiplied
    alpha, then the alpha composite): the images, MVS images, alphas and a
    full item equal the JAX package's."""
    root = str(tmp_path)
    make_nerf_synth_scene(root, wh=(40, 40), n_train=4, n_test=2)
    jopt = JOptions(data_root=root, scan="plate",
                    dataset_name="nerf_synth360_ft", img_wh=(32, 32),
                    bg_color="white", random_sample="random",
                    random_sample_size=6)
    opt = Options.from_json(jopt.to_json())
    for split in ("train", "test"):
        jds, tds = jcreate(jopt, split=split), create_dataset(opt, split)
        for name in ("render_gtimgs", "mvsimgs", "alphas"):
            got, want = getattr(tds, name), getattr(jds, name)
            assert len(got) == len(want) > 0, name
            for a, b in zip(got, want):
                assert a.shape[:2] == (32, 32), name
                np.testing.assert_array_equal(a, b, err_msg=name)
        got = tds.get_item(1, rng=np.random.RandomState(0), full_img=True)
        want = jds.get_item(1, rng=np.random.RandomState(0), full_img=True)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)
