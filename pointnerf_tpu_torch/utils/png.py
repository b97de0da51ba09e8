"""A minimal PNG codec on zlib and numpy.

The port reads the datasets' images and writes its renders with this
module alone, so every machine runs the same code whether or not Pillow or
imageio is installed. It covers 8-bit gray, gray+alpha, RGB and RGBA and
16-bit gray, non-interlaced: reading undoes all five scanline filters,
writing uses filter 0 (none). A 16-bit gray file reads as uint16 [H, W]
(big-endian samples, filters over 2-byte pixels), as
`cv2.imread(path, -1)` reads ScanNet's depth maps; an 8-bit gray file
still reads as uint8. Palette, other 16-bit and interlaced files raise.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}          # color type → channels
_COLOR_TYPE = {c: t for t, c in _CHANNELS.items()}


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def write_png(path: str, img: np.ndarray) -> None:
    """Write a uint8 [H, W] or [H, W, C] image (C = 1, 2, 3 or 4), or a
    uint16 [H, W] one as 16-bit gray."""
    img = np.asarray(img)
    if img.dtype == np.uint16 and img.ndim == 2:
        H, W = img.shape
        raw = np.concatenate([np.zeros((H, 1), np.uint8),
                              img.astype(">u2").view(np.uint8)], axis=1)
        ihdr = struct.pack(">IIBBBBB", W, H, 16, 0, 0, 0, 0)
    elif img.dtype == np.uint8:
        if img.ndim == 2:
            img = img[..., None]
        H, W, C = img.shape
        if C not in _COLOR_TYPE:
            raise ValueError(f"{C} channels: PNG takes 1-4")
        raw = np.concatenate([np.zeros((H, 1), np.uint8),
                              img.reshape(H, W * C)], axis=1)
        ihdr = struct.pack(">IIBBBBB", W, H, 8, _COLOR_TYPE[C], 0, 0, 0)
    else:
        raise ValueError(f"write_png takes uint8, or uint16 [H, W], not "
                         f"{img.dtype} {img.shape}")
    with open(path, "wb") as f:
        f.write(_SIG + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _chunk(b"IEND", b""))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(data: np.ndarray, H: int, W: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters of an image of `bpp` bytes a pixel:
    [H, W·bpp] uint8."""
    stride = W * bpp
    rows = data.reshape(H, stride + 1)
    out = np.zeros((H, stride), np.uint8)
    prior = np.zeros(stride, np.int64)
    for y in range(H):
        kind, line = int(rows[y, 0]), rows[y, 1:].astype(np.int64)
        if kind == 0:
            cur = line
        elif kind == 1:           # Sub: a running sum per byte of a pixel
            cur = np.cumsum(line.reshape(W, bpp), axis=0).reshape(-1) % 256
        elif kind == 2:           # Up
            cur = (line + prior) % 256
        elif kind in (3, 4):      # Average, Paeth: pixel by pixel
            cur = np.zeros(stride, np.int64)
            left = np.zeros(bpp, np.int64)
            up_left = np.zeros(bpp, np.int64)
            for x in range(W):
                s = slice(x * bpp, (x + 1) * bpp)
                up = prior[s]
                pred = (left + up) // 2 if kind == 3 else \
                    _paeth(left, up, up_left)
                cur[s] = (line[s] + pred) % 256
                left, up_left = cur[s], up
        else:
            raise ValueError(f"unknown PNG filter type {kind}")
        out[y] = cur
        prior = cur
    return out


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit PNG as uint8 [H, W] (gray) or [H, W, C], a 16-bit gray
    one as uint16 [H, W]."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    W, H, depth, ctype, _, _, interlace = hdr
    if not ((depth == 8 and ctype in _CHANNELS) or (depth == 16 and ctype
                                                    == 0)) or interlace:
        raise NotImplementedError(
            f"{path}: bit depth {depth}, color type {ctype}, interlace "
            f"{interlace}; only non-interlaced 8-bit gray/RGB(A) and 16-bit"
            f" gray are read")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if depth == 16:
        return _unfilter(raw, H, W, 2).reshape(H, W, 2).view(">u2")[
            ..., 0].astype(np.uint16)
    C = _CHANNELS[ctype]
    img = _unfilter(raw, H, W, C).reshape(H, W, C)
    return img[..., 0] if C == 1 else img
