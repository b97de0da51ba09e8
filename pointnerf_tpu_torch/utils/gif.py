"""A minimal animated-GIF codec on numpy.

The port assembles its render-path videos with this module (the JAX
package writes an mp4 through imageio; neither imageio nor ffmpeg is on
every machine the port runs on). Writing: each frame gets its own
256-entry palette, then LZW, in a GIF89a file that loops forever (the
NETSCAPE2.0 block). Reading undoes that: it takes the files this module
writes (frames that cover the canvas, each with its own palette).

Palette: a frame with at most 256 distinct colors is stored exactly.
Otherwise its colors are cut into 256 boxes, each time halving the box
whose widest channel range is the largest (at the middle of that range),
and every pixel takes its box's midpoint. Quantisation bound: no channel
of a pixel moves by more than 32 of 255 levels (three halvings of 255
reach every box after seven levels of splits, leaving ranges ≤ 63); on
smooth renders it is a few levels.
"""

from __future__ import annotations

import heapq
import struct
from typing import List, Sequence, Tuple

import numpy as np

QUANT_BOUND = 32          # max per-channel error of a palette, 8-bit levels
_MAX_CODES = 4096         # GIF's LZW table holds 12-bit codes


def quantize(frame: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """uint8 [H, W, 3] → (palette indices uint8 [H, W], palette uint8
    [n ≤ 256, 3]), within QUANT_BOUND per channel."""
    flat = frame.reshape(-1, 3).astype(np.int64)
    packed = (flat[:, 0] << 16) | (flat[:, 1] << 8) | flat[:, 2]
    uniq, inv = np.unique(packed, return_inverse=True)
    colors = np.stack([uniq >> 16, (uniq >> 8) & 255, uniq & 255], axis=-1)
    if len(colors) <= 256:
        return inv.astype(np.uint8).reshape(frame.shape[:2]), \
            colors.astype(np.uint8)

    def entry(idx):
        c = colors[idx]
        lo, hi = c.min(0), c.max(0)
        ch = int(np.argmax(hi - lo))
        return (-int(hi[ch] - lo[ch]), int(idx[0]), ch, lo, hi, idx)

    heap = [entry(np.arange(len(colors)))]
    while len(heap) < 256 and heap[0][0] < 0:
        _, _, ch, lo, hi, idx = heapq.heappop(heap)
        mid = lo[ch] + (hi[ch] - lo[ch]) // 2
        low = colors[idx, ch] <= mid
        heapq.heappush(heap, entry(idx[low]))
        heapq.heappush(heap, entry(idx[~low]))
    box_of = np.empty(len(colors), np.uint8)
    palette = np.empty((len(heap), 3), np.uint8)
    for b, (_, _, _, lo, hi, idx) in enumerate(heap):
        box_of[idx] = b
        palette[b] = (lo + hi + 1) // 2
    return box_of[inv].reshape(frame.shape[:2]), palette


def _pack_codes(codes: List[int], sizes: List[int]) -> bytes:
    """Codes of the given bit widths, least significant bit first."""
    codes = np.asarray(codes, np.int64)
    sizes = np.asarray(sizes, np.int64)
    start = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    bits = np.zeros(int(sizes.sum()) + 7, np.uint8)
    for b in range(12):
        on = sizes > b
        bits[start[on] + b] = (codes[on] >> b) & 1
    return np.packbits(bits[: (int(sizes.sum()) + 7) // 8 * 8],
                       bitorder="little").tobytes()


def lzw_encode(indices: bytes, min_size: int = 8) -> bytes:
    """GIF's variable-width LZW of a byte string (a clear code first, then
    again whenever the 12-bit table fills)."""
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    codes, sizes = [clear], [min_size + 1]
    table = {bytes([i]): i for i in range(clear)}
    nxt, size = eoi + 1, min_size + 1
    w = b""
    for k in indices:
        wk = w + bytes((k,))
        if wk in table:
            w = wk
            continue
        codes.append(table[w])
        sizes.append(size)
        if nxt == _MAX_CODES:
            codes.append(clear)
            sizes.append(size)
            table = {bytes([i]): i for i in range(clear)}
            nxt, size = eoi + 1, min_size + 1
        else:
            table[wk] = nxt
            if nxt == 1 << size:
                size += 1
            nxt += 1
        w = bytes((k,))
    if w:
        codes.append(table[w])
        sizes.append(size)
    codes.append(eoi)
    sizes.append(size)
    return _pack_codes(codes, sizes)


def lzw_decode(data: bytes, min_size: int = 8) -> bytes:
    """Inverse of `lzw_encode` (any conforming GIF code stream)."""
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    base = [bytes([i]) for i in range(clear)] + [b"", b""]
    table, size, prev = list(base), min_size + 1, None
    out = bytearray()
    data = bytes(data) + b"\0\0\0"
    pos, end = 0, (len(data) - 3) * 8
    while pos + size <= end:
        byte = pos >> 3
        code = (int.from_bytes(data[byte:byte + 3], "little")
                >> (pos & 7)) & ((1 << size) - 1)
        pos += size
        if code == clear:
            table, size, prev = list(base), min_size + 1, None
            continue
        if code == eoi:
            break
        if prev is None:
            cur = table[code]
        else:
            cur = table[code] if code < len(table) else prev + prev[:1]
            if len(table) < _MAX_CODES:
                table.append(prev + cur[:1])
                if len(table) == 1 << size and size < 12:
                    size += 1
        out += cur
        prev = cur
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes((len(data[i:i + 255]),)) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\0"


def write_gif(path: str, frames: Sequence[np.ndarray], fps: int = 24
              ) -> None:
    """Write uint8 [H, W, 3] frames (one size) as an animated GIF that
    loops forever, each frame shown for round(100 / fps) centiseconds."""
    frames = [np.asarray(f) for f in frames]
    if not frames:
        raise ValueError("write_gif needs at least one frame")
    H, W = frames[0].shape[:2]
    for f in frames:
        if f.dtype != np.uint8 or f.shape != (H, W, 3):
            raise ValueError(f"frames must be uint8 [{H}, {W}, 3], not "
                             f"{f.dtype} {list(f.shape)}")
    delay = max(1, int(round(100.0 / fps)))
    out = [b"GIF89a", struct.pack("<HHBBB", W, H, 0x70, 0, 0),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"]
    for f in frames:
        idx, pal = quantize(f)
        table = np.zeros((256, 3), np.uint8)
        table[: len(pal)] = pal
        out += [struct.pack("<BBBBHBB", 0x21, 0xF9, 4, 0x04, delay, 0, 0),
                struct.pack("<BHHHHB", 0x2C, 0, 0, W, H, 0x87),
                table.tobytes(), b"\x08",
                _sub_blocks(lzw_encode(idx.tobytes(), 8))]
    out.append(b"\x3b")
    with open(path, "wb") as fh:
        fh.write(b"".join(out))


def _read_sub_blocks(data: bytes, pos: int) -> Tuple[bytes, int]:
    parts = []
    while data[pos]:
        parts.append(data[pos + 1:pos + 1 + data[pos]])
        pos += 1 + data[pos]
    return b"".join(parts), pos + 1


def read_gif(path: str) -> List[np.ndarray]:
    """The frames of a GIF as uint8 [H, W, 3] arrays. Interlaced frames,
    frames that do not cover the canvas and palettes other than each
    frame's own raise."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError(f"{path}: not a GIF file")
    W, H, flags, _, _ = struct.unpack("<HHBBB", data[6:13])
    if flags & 0x80:
        raise NotImplementedError(f"{path}: a global color table is not "
                                  f"read")
    pos, frames = 13, []
    while pos < len(data) and data[pos] != 0x3B:
        kind = data[pos]
        if kind == 0x21:
            _, pos = _read_sub_blocks(data, pos + 2)
        elif kind == 0x2C:
            x, y, w, h, fl = struct.unpack("<HHHHB", data[pos + 1:pos + 10])
            pos += 10
            if fl & 0x40 or not fl & 0x80 or (x, y, w, h) != (0, 0, W, H):
                raise NotImplementedError(f"{path}: interlaced or partial "
                                          f"frames, or frames without their "
                                          f"own palette, are not read")
            n = 2 << (fl & 7)
            table = np.frombuffer(data[pos:pos + 3 * n], np.uint8).reshape(
                n, 3)
            pos += 3 * n
            min_size = data[pos]
            code, pos = _read_sub_blocks(data, pos + 1)
            idx = np.frombuffer(lzw_decode(code, min_size), np.uint8)
            if idx.size < W * H:
                raise ValueError(f"{path}: frame {len(frames)} is short")
            frames.append(table[idx[:W * H]].reshape(H, W, 3))
        else:
            raise ValueError(f"{path}: unknown block 0x{kind:02x}")
    return frames
