"""The port's baseline JPEG codec (`utils/jpeg.py`) against Pillow and cv2.

The decoder must give Pillow's pixels exactly, uint8 for uint8
(`np.asarray(Image.open(p).convert("RGB"))`; the grey image as it is), and
cv2's decode reversed to RGB, over the sampling, quality and size grid,
custom Huffman tables, restart markers, 16-bit quantization tables, a
noise image at quality 100, a grey image and files with APPn and COM
segments. Progressive, arithmetic, 12-bit, CMYK, 4:1:1 and truncated files
raise ValueError. `write_jpeg`'s files decode to the same bytes through
Pillow, cv2 and the port, sit 30 dB or more from a smooth input at
quality 75, and carry libjpeg's quality-75 tables at 4:2:0.
"""

import io

import cv2
import numpy as np
import pytest
from PIL import Image

from pointnerf_tpu_torch.utils.jpeg import (decode_jpeg, encode_jpeg,
                                            quality_tables, read_jpeg)


def natural(h, w, seed=0):
    """A smooth colour field with noise: AC terms in every block."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w] / max(h, w, 1)
    img = np.stack([np.sin(7 * x + 3 * y), np.cos(5 * y - 2 * x),
                    np.sin(11 * x * y)], -1) * 90 + 128
    img += rng.normal(0, 12, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def plate(h, w):
    """A smooth image like the synthetic scenes' frames."""
    y, x = np.mgrid[0:h, 0:w] / max(h, w, 1)
    img = np.stack([x, y, 0.5 + 0 * x], -1)
    return np.clip(img * 255, 0, 255).astype(np.uint8)


def pil_jpeg(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def cv2_jpeg(img, quality, sampling):
    ok, enc = cv2.imencode(".jpg", img[..., ::-1], [
        cv2.IMWRITE_JPEG_QUALITY, quality,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling])
    assert ok
    return enc.tobytes()


def pil_decode(data):
    im = Image.open(io.BytesIO(data))
    return np.asarray(im.convert("RGB") if im.mode != "L" else im)


def cv2_decode(data):
    return cv2.imdecode(np.frombuffer(data, np.uint8),
                        cv2.IMREAD_COLOR)[..., ::-1]


def assert_decodes_like_pillow_and_cv2(data):
    got = decode_jpeg(data)
    np.testing.assert_array_equal(got, pil_decode(data))
    if got.ndim == 3:
        np.testing.assert_array_equal(got, cv2_decode(data))
    return got


SAMPLINGS = {"4:4:4": (1, 1), "4:2:2": (2, 1), "4:2:0": (2, 2),
             "4:4:0": (1, 2)}


@pytest.mark.parametrize("wh", [(1, 1), (7, 5), (17, 33), (40, 30)])
@pytest.mark.parametrize("quality", [50, 75, 95, 100])
@pytest.mark.parametrize("sub", list(SAMPLINGS))
def test_decoder_matches_pillow_over_sampling_quality_size(sub, quality, wh):
    img = natural(wh[1], wh[0], seed=wh[0] * 31 + quality)
    if sub == "4:4:0":                   # Pillow cannot write 4:4:0
        data = cv2_jpeg(img, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440)
    else:
        data = pil_jpeg(img, quality=quality, subsampling=sub)
    assert [c[1:3] for c in Image.open(io.BytesIO(data)).layer][0] \
        == SAMPLINGS[sub]
    got = assert_decodes_like_pillow_and_cv2(data)
    assert got.shape == (wh[1], wh[0], 3) and got.dtype == np.uint8


def test_decoder_matches_pillow_at_the_sensor_size(tmp_path):
    """ScanNet's 1296x968 colour frames at 4:2:0 end in half an MCU row."""
    img = natural(968, 1296)
    p = str(tmp_path / "frame.jpg")
    with open(p, "wb") as f:
        f.write(pil_jpeg(img, quality=75))
    np.testing.assert_array_equal(read_jpeg(p), pil_decode(open(p, "rb")
                                                           .read()))


@pytest.mark.parametrize("kw", [
    dict(optimize=True), dict(optimize=True, subsampling="4:4:4"),
    dict(restart_marker_blocks=1), dict(restart_marker_blocks=5,
                                        subsampling="4:2:2"),
    dict(restart_marker_rows=1), dict(restart_marker_rows=2, optimize=True)],
    ids=["optimize", "optimize-444", "rst-1-block", "rst-5-blocks-422",
         "rst-1-row", "rst-2-rows-optimize"])
def test_decoder_custom_huffman_and_restart_markers(kw):
    data = pil_jpeg(natural(45, 67, 3), quality=80, **kw)
    if "restart_marker_blocks" in kw or "restart_marker_rows" in kw:
        assert b"\xff\xdd" in data and b"\xff\xd0" in data
    assert_decodes_like_pillow_and_cv2(data)


@pytest.mark.parametrize("sub", ["4:4:4", "4:2:0"])
def test_decoder_noise_at_quality_100(sub):
    """Uniform noise at q100 drives the IDCT to and past the sample range:
    the range limit must clamp as libjpeg's table does."""
    img = np.random.RandomState(0).randint(0, 256, (64, 80, 3)).astype(
        np.uint8)
    data = pil_jpeg(img, quality=100, subsampling=sub)
    got = assert_decodes_like_pillow_and_cv2(data)
    assert (got == 0).any() and (got == 255).any()


def test_decoder_16_bit_tables_and_sof1():
    q = list(range(1, 65))
    q[0] = 300
    data = pil_jpeg(natural(30, 40, 5), qtables=[q, [400] * 64])
    assert b"\xff\xc1" in data                      # extended sequential
    assert_decodes_like_pillow_and_cv2(data)


def test_decoder_grey_and_app_segments():
    grey = pil_jpeg(natural(33, 45, 7)[..., 1], quality=85)
    got = assert_decodes_like_pillow_and_cv2(grey)
    assert got.shape == (33, 45)
    np.testing.assert_array_equal(got, cv2.imdecode(
        np.frombuffer(grey, np.uint8), cv2.IMREAD_GRAYSCALE))
    data = pil_jpeg(natural(30, 40, 8), quality=75,
                    icc_profile=b"\0" * 3000, exif=Image.Exif().tobytes(),
                    comment="a comment")
    for marker in (b"\xff\xe1", b"\xff\xe2", b"\xff\xfe"):
        assert marker in data
    assert_decodes_like_pillow_and_cv2(data)


def _sof_offset(data):
    return min(i for i in (data.find(b"\xff\xc0"), data.find(b"\xff\xc1"))
               if i >= 0)


def test_decoder_refuses_what_it_does_not_take():
    img = natural(30, 40, 9)
    base = pil_jpeg(img, quality=75)
    cases = {
        "progressive": pil_jpeg(img, quality=75, progressive=True),
        "sampling factors": cv2_jpeg(img, 75,
                                     cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411),
    }
    buf = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(buf, "JPEG", quality=75)
    cases["4 components"] = buf.getvalue()
    i = _sof_offset(base)
    cases["arithmetic coding"] = base[:i + 1] + b"\xc9" + base[i + 2:]
    cases["12-bit"] = base[:i + 4] + b"\x0c" + base[i + 5:]
    scan = base.find(b"\xff\xda")
    cases["truncated"] = base[:(scan + len(base)) // 2]
    cases["truncated JPEG"] = base[:(scan + len(base)) // 2] + b"\xff\xd9"
    cases["SOI"] = b"\x89PNG" + base[4:]
    for what, data in cases.items():
        with pytest.raises(ValueError, match=what):
            decode_jpeg(data)
    with pytest.raises(OSError, match="truncated"):
        Image.open(io.BytesIO(cases["truncated"])).load()


@pytest.mark.parametrize("wh", [(1296, 968), (40, 30), (17, 33)])
def test_write_jpeg_round_trip(wh, tmp_path):
    img = plate(wh[1], wh[0])
    data = encode_jpeg(img, 75)
    assert data == encode_jpeg(img, 75)
    im = Image.open(io.BytesIO(data))
    assert im.format == "JPEG" and im.size == wh
    assert [c[1:3] for c in im.layer] == [(2, 2), (1, 1), (1, 1)]
    want = quality_tables(75)
    assert [list(t) for t in want] == [im.quantization[0],
                                       im.quantization[1]]
    ref = Image.open(io.BytesIO(pil_jpeg(img, quality=75)))
    assert ref.quantization == im.quantization
    got = assert_decodes_like_pillow_and_cv2(data)
    mse = np.mean((got.astype(np.float64) - img) ** 2)
    assert 10 * np.log10(255.0 ** 2 / max(mse, 1e-12)) >= 30.0
