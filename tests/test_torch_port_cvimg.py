"""The port's copies of cv2's image operations (`utils/cvimg.py`) and its
16-bit PNG codec (`utils/png.py`) against cv2 5.0.0, exactly:
`resize_nearest` against `cv2.resize(INTER_NEAREST)` on downsizes,
upsizes and odd sizes; `bgr2gray` against `cvtColor(BGR2GRAY)` on all
2^24 colours in one 4096x4096 image; `laplacian_var` against
`cv2.Laplacian(gray, CV_64F).var()` on random and decoded images down to
one and two pixels thin; the 16-bit grey PNG reader against
`cv2.imread(path, -1)` on files written by imageio (the test fixture's
writer), cv2 and the port.
"""

import os

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest

from pointnerf_tpu_torch.utils import cvimg
from pointnerf_tpu_torch.utils.jpeg import decode_jpeg, encode_jpeg
from pointnerf_tpu_torch.utils.png import read_png, write_png


@pytest.mark.parametrize("src_wh, dst_wh", [
    ((640, 480), (40, 30)), ((640, 480), (320, 240)), ((640, 480), (333, 211)),
    ((640, 480), (1296, 968)), ((40, 30), (640, 480)), ((97, 61), (398, 5)),
    ((13, 7), (1, 1)), ((13, 7), (386, 333)), ((640, 480), (641, 481)),
    ((1000, 3), (3, 1000)), ((6, 6), (34, 74))])
def test_resize_nearest_matches_cv2(src_wh, dst_wh):
    """(6, 6) -> (34, 74): x · (6 / 34) floors to 3 at x = 17, where cv2's
    x · (1 / (34 / 6)) floors to 2 (the port's DTU depths used the first
    form before)."""
    rng = np.random.RandomState(src_wh[0] + dst_wh[1])
    for src in (rng.rand(src_wh[1], src_wh[0]).astype(np.float32),
                rng.randint(0, 65536, (src_wh[1], src_wh[0]))
                .astype(np.uint16)):
        want = cv2.resize(src, dst_wh, interpolation=cv2.INTER_NEAREST)
        got = cvimg.resize_nearest(src, dst_wh)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_bgr2gray_matches_cv2_on_every_colour():
    v = np.arange(1 << 24, dtype=np.uint32)
    img = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255],
                   -1).astype(np.uint8).reshape(4096, 4096, 3)
    np.testing.assert_array_equal(cvimg.bgr2gray(img),
                                  cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))


@pytest.mark.parametrize("shape", [(30, 40), (2, 40), (40, 2), (2, 2),
                                   (1, 5), (5, 1), (1, 1), (97, 131)])
def test_laplacian_var_matches_cv2(shape):
    rng = np.random.RandomState(shape[0] * 7 + shape[1])
    gray = rng.randint(0, 256, shape).astype(np.uint8)
    np.testing.assert_array_equal(cvimg.laplacian(gray),
                                  cv2.Laplacian(gray, cv2.CV_64F))
    assert cvimg.laplacian_var(gray) == cv2.Laplacian(gray, cv2.CV_64F).var()


def test_blur_score_of_a_decoded_frame_matches_cv2():
    """The JAX package's blur chain (cv2 decode, BGR2GRAY, Laplacian
    variance) against the port's (its decoder reversed to BGR)."""
    y, x = np.mgrid[0:90, 0:130] / 130.0
    rgb = np.clip(np.stack([np.sin(9 * x), np.cos(7 * y), x * y], -1)
                  * 120 + 128, 0, 255).astype(np.uint8)
    data = encode_jpeg(rgb, 75)
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    want = float(cv2.Laplacian(cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY),
                               cv2.CV_64F).var())
    got = cvimg.laplacian_var(cvimg.bgr2gray(decode_jpeg(data)[..., ::-1]))
    assert got == want


def test_png_16_bit_grey_matches_cv2(tmp_path):
    rng = np.random.RandomState(0)
    depth = rng.randint(0, 65536, (30, 40)).astype(np.uint16)
    depth[5:10] = np.arange(40) * 1600                  # smooth rows: filters
    files = {}
    for who, write in (("imageio", imageio.imwrite),
                       ("cv2", cv2.imwrite), ("port", write_png)):
        p = str(tmp_path / f"{who}.png")
        write(p, depth)
        files[who] = p
    for who, p in files.items():
        want = cv2.imread(p, -1)
        got = read_png(p)
        assert got.dtype == np.uint16 == want.dtype, who
        np.testing.assert_array_equal(got, want, err_msg=who)
        np.testing.assert_array_equal(got, depth, err_msg=who)
    p8 = str(tmp_path / "grey8.png")
    imageio.imwrite(p8, depth.astype(np.uint8))
    got = read_png(p8)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, cv2.imread(p8, -1))


def test_png_refuses_other_16_bit_and_interlaced(tmp_path):
    rgb16 = np.zeros((4, 5, 3), np.uint16)
    p = str(tmp_path / "rgb16.png")
    cv2.imwrite(p, rgb16)
    with pytest.raises(NotImplementedError, match="bit depth 16"):
        read_png(p)
    q = str(tmp_path / "interlaced.png")
    write_png(q, np.zeros((4, 5), np.uint16))
    data = bytearray(open(q, "rb").read())
    data[8 + 8 + 12] = 1                     # IHDR's interlace byte
    with open(q, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(NotImplementedError, match="interlace 1"):
        read_png(q)
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "x.png"), rgb16)
    assert os.path.getsize(p) > 0
