"""A baseline JPEG decoder equal to Pillow's, and a baseline encoder.

The JAX package reads ScanNet's colour frames through Pillow
(`pointnerf_tpu/data/scannet_ft.py`) and ranks their blur through cv2's
decode; both sit on libjpeg-turbo, and the GPU machine has neither. This
module decodes what libjpeg-turbo's default path decodes, byte for byte:

- the entropy-coded data through table-driven Huffman lookups (16 bits
  peeked at once; a code and its extra bits together where they fit), into
  one int32 [blocks, 64] array; restart intervals reset the DC predictors;
- dequantization and the islow IDCT of `jidctint.c` (CONST_BITS 13,
  PASS1_BITS 2), with the post-IDCT range-limit table of `jdmaster.c`:
  the descaled value is taken modulo 1024 as a signed 10-bit number, then
  offset by 128 and clamped, so a sum that overflows wraps as the table
  does;
- the fancy upsampling of `jdsample.c`: `h2v1_fancy_upsample` (3/4 and 1/4
  of the two nearest chroma columns, biases 1 and 2), `h1v2_fancy_upsample`
  (the same over rows) and `h2v2_fancy_upsample` (the triangle filter with
  context rows, biases 8 and 7); the edges replicate the last real sample
  row and column; a component at most 2 samples wide takes the box
  upsampler, as libjpeg-turbo chooses;
- the fixed-point YCbCr to RGB tables of `jdcolor.c` (SCALEBITS 16,
  ONE_HALF rounding).

Dequantization, the IDCT, upsampling and colour conversion are numpy passes
over all blocks at once; only the entropy decoding is a Python loop.

It takes baseline and extended-sequential Huffman frames (SOF0, SOF1) with
8-bit samples and 1 or 3 components, luma sampling h, v in {1, 2} with 1x1
chroma (4:4:4, 4:2:2, 4:2:0, 4:4:0), 8- and 16-bit quantization tables,
several DHT segments, DRI with RSTn markers, and skips APPn and COM
segments. It raises ValueError, naming the marker or the property, for
progressive (SOF2), lossless and hierarchical frames, arithmetic coding
(SOF9 and up), 12-bit samples, 4 components (CMYK, YCCK), another
sampling, a colour transform other than YCbCr, and truncated or corrupt
data.

`write_jpeg` is a baseline 4:2:0 encoder: libjpeg's `jcparam.c` quality
scaling of the Annex K tables, the standard Huffman tables, `jccolor.c`'s
fixed-point RGB to YCbCr, `jcsample.c`'s 2x2 average and the integer
forward DCT of `jfdctint.c`. It computes in integers only, so its bytes
are the same on every machine.
"""

from __future__ import annotations

import array
import functools
import struct

import numpy as np

# natural (row-major) index of each zigzag position (jutils.c
# jpeg_natural_order)
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_UNZIGZAG = np.argsort(ZIGZAG)      # zigzag position of each natural index

_SOF_REFUSED = {
    0xC2: "progressive (SOF2)", 0xC3: "lossless (SOF3)",
    0xC5: "differential sequential (SOF5)",
    0xC6: "differential progressive (SOF6)",
    0xC7: "differential lossless (SOF7)",
    0xC9: "arithmetic coding (SOF9)", 0xCA: "arithmetic coding (SOF10)",
    0xCB: "arithmetic coding (SOF11)", 0xCC: "arithmetic coding (DAC)",
    0xCD: "arithmetic coding (SOF13)", 0xCE: "arithmetic coding (SOF14)",
    0xCF: "arithmetic coding (SOF15)"}

# jidctint.c / jfdctint.c constants, CONST_BITS 13
CONST_BITS, PASS1_BITS = 13, 2
F_0_298, F_0_390, F_0_541, F_0_765 = 2446, 3196, 4433, 6270
F_0_899, F_1_175, F_1_501, F_1_847 = 7373, 9633, 12299, 15137
F_1_961, F_2_053, F_2_562, F_3_072 = 16069, 16819, 20995, 25172


def _fix16(x: float) -> int:
    """jdcolor.c / jccolor.c FIX at SCALEBITS 16."""
    return int(x * 65536 + 0.5)


# --------------------------------------------------------------- Huffman
def _canonical_codes(counts, values):
    """(code, length) of each symbol of a DHT table (Annex C), in order."""
    codes, lengths, code = [], [], 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if code >= (1 << length):
                raise ValueError("corrupt DHT segment: too many codes of "
                                 f"length {length}")
            codes.append(code)
            lengths.append(length)
            code += 1
        code <<= 1
    return np.array(codes, np.int64), np.array(lengths, np.int64)


def _lookup(counts, values):
    """(code length, symbol) of every 16-bit peek: [65536] each; length 0
    where no code starts the peek."""
    codes, lengths = _canonical_codes(counts, values)
    span = 1 << (16 - lengths)
    length = np.zeros(65536, np.int64)
    symbol = np.zeros(65536, np.int64)
    first = codes << (16 - lengths)
    idx = np.repeat(first, span) + (np.arange(span.sum())
                                    - np.repeat(np.cumsum(span) - span, span))
    length[idx] = np.repeat(lengths, span)
    symbol[idx] = np.repeat(np.asarray(values, np.int64), span)
    return length, symbol


def _extra_value(peek, length, s):
    """The signed value of the s extra bits after a code of `length` bits
    in a 16-bit peek (F.2.2.1 EXTEND), where length + s <= 16."""
    x = (peek >> np.maximum(16 - length - s, 0)) & ((1 << s) - 1)
    return np.where(s == 0, 0, np.where(x < (1 << np.maximum(s - 1, 0)),
                                        x - (1 << s) + 1, x))


@functools.lru_cache(maxsize=16)
def _dc_table(counts, values):
    """A list over 16-bit peeks: value*64 + 32 + bits when the code and its
    extra bits fit in the peek, s*64 + code length when they do not, 0
    where no code matches."""
    length, sym = _lookup(counts, values)
    peek = np.arange(65536, dtype=np.int64)
    s = np.minimum(sym, 15)
    fits = length + s <= 16
    val = _extra_value(peek, length, np.where(fits, s, 0))
    e = np.where(fits, val * 64 + 32 + length + s, s * 64 + length)
    return np.where(length > 0, e, 0).tolist()


_EOB, _ZRL, _SLOW = 1 << 13, 2 << 13, 3 << 13


@functools.lru_cache(maxsize=16)
def _ac_table(counts, values):
    """A list over 16-bit peeks: value << 16 | run << 5 | bits for a
    coefficient whose code and extra bits fit in the peek; below 65536 the
    kind (_EOB, _ZRL, _SLOW: run << 9 | s << 5 | code length), 0 where no
    code matches. A zero-size symbol other than ZRL ends the block, as in
    jdhuff.c."""
    length, sym = _lookup(counts, values)
    peek = np.arange(65536, dtype=np.int64)
    r, s = sym >> 4, sym & 15
    fits = length + s <= 16
    val = _extra_value(peek, length, np.where(fits, s, 0))
    e = np.where(s == 0, np.where(r == 15, _ZRL, _EOB) | length,
                 np.where(fits, (val << 16) | (r << 5) | (length + s),
                          _SLOW | (r << 9) | (s << 5) | length))
    return np.where(length > 0, e, 0).tolist()


def _peeks(buf: bytes) -> list:
    """The 16 bits that start at every bit position of `buf` (zeros past its
    end, as libjpeg inserts at a marker)."""
    b = np.frombuffer(buf + b"\0\0\0", np.uint8).astype(np.int64)
    w = (b[:-2] << 16) | (b[1:-1] << 8) | b[2:]
    n = len(buf) + 1
    out = np.empty((n, 8), np.int64)
    for sh in range(8):
        out[:, sh] = (w[:n] >> (8 - sh)) & 0xFFFF
    return out.reshape(-1).tolist()


def _scan_segments(data: bytes, pos: int):
    """The entropy-coded data from `pos`: its restart intervals, unstuffed,
    and the position of the marker that ends it."""
    segs, start, i = [], pos, pos
    while True:
        i = data.find(b"\xff", i)
        if i < 0 or i + 1 >= len(data):
            raise ValueError("truncated JPEG data: the scan has no end "
                             "marker")
        nxt = data[i + 1]
        if nxt == 0x00:
            i += 2
        elif nxt == 0xFF:
            i += 1
        elif 0xD0 <= nxt <= 0xD7:
            segs.append(data[start:i].replace(b"\xff\x00", b"\xff"))
            i += 2
            start = i
        else:
            segs.append(data[start:i].replace(b"\xff\x00", b"\xff"))
            return segs, i


def _decode_scan(segs, blocks, pattern, restart, n_mcu, coefs):
    """Huffman-decode one scan into `coefs` (an int32 array, zigzag order,
    64 a block). blocks: block index of each decoded block in order; pattern:
    (scan component slot, DC table, AC table) of each block of an MCU."""
    buf = b"".join(segs)
    peek = _peeks(buf)
    starts = np.cumsum([0] + [8 * len(s) for s in segs]).tolist()
    per = restart if restart else n_mcu
    n_int = -(-n_mcu // per)
    if len(segs) < n_int:
        raise ValueError(f"truncated JPEG data: {len(segs)} of {n_int} "
                         f"restart intervals")
    bi = 0
    nslot = max(p[0] for p in pattern) + 1
    for it in range(n_int):
        pos = starts[it]
        pred = [0] * nslot
        for _ in range(min(per, n_mcu - it * per)):
            for slot, dct, act in pattern:
                base = blocks[bi] << 6
                bi += 1
                e = dct[peek[pos]]
                if e & 32:
                    pos += e & 31
                    pred[slot] += e >> 6
                elif e:
                    pos += e & 31
                    s = e >> 6
                    x = peek[pos] >> (16 - s)
                    pos += s
                    if x < (1 << (s - 1)):
                        x -= (1 << s) - 1
                    pred[slot] += x
                else:
                    raise ValueError("corrupt JPEG data: bad DC code")
                coefs[base] = pred[slot]
                k = 1
                while k < 64:
                    e = act[peek[pos]]
                    v = e >> 16
                    if v:
                        pos += e & 31
                        k += (e >> 5) & 15
                        if k > 63:
                            raise ValueError("corrupt JPEG data: AC run "
                                             "past the block")
                        coefs[base + k] = v
                        k += 1
                    elif e >= _SLOW:
                        pos += e & 31
                        k += (e >> 9) & 15
                        s = (e >> 5) & 15
                        x = peek[pos] >> (16 - s)
                        pos += s
                        if x < (1 << (s - 1)):
                            x -= (1 << s) - 1
                        if k > 63:
                            raise ValueError("corrupt JPEG data: AC run "
                                             "past the block")
                        coefs[base + k] = x
                        k += 1
                    elif e >= _ZRL:
                        pos += e & 31
                        k += 16
                    elif e:
                        pos += e & 31
                        break
                    else:
                        raise ValueError("corrupt JPEG data: bad AC code")
        if pos > starts[it + 1]:
            raise ValueError("truncated JPEG data: a restart interval ends "
                             "inside a block")


# ------------------------------------------------------------------ IDCT
def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _idct_1d(c):
    """jidctint.c's 1-D stage on c[0..7] (int64 arrays): the eight
    outputs before descaling."""
    z1 = (c[2] + c[6]) * F_0_541
    tmp2 = z1 - c[6] * F_1_847
    tmp3 = z1 + c[2] * F_0_765
    tmp0 = (c[0] + c[4]) << CONST_BITS
    tmp1 = (c[0] - c[4]) << CONST_BITS
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    o0, o1, o2, o3 = c[7], c[5], c[3], c[1]
    z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
    z5 = (z3 + z4) * F_1_175
    o0, o1 = o0 * F_0_298, o1 * F_2_053
    o2, o3 = o2 * F_3_072, o3 * F_1_501
    z1, z2 = z1 * -F_0_899, z2 * -F_2_562
    z3, z4 = z3 * -F_1_961 + z5, z4 * -F_0_390 + z5
    o0, o1 = o0 + z1 + z3, o1 + z2 + z4
    o2, o3 = o2 + z2 + z3, o3 + z1 + z4
    return (t10 + o3, t11 + o2, t12 + o1, t13 + o0,
            t13 - o0, t12 - o1, t11 - o2, t10 - o3)


def idct_islow(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """jpeg_idct_islow over blocks: coef [N, 64] natural order, quant [64]
    natural order, to uint8 [N, 8, 8] samples. The all-zero-AC shortcuts of
    jidctint.c give the same values as the full pass, so none is taken."""
    z = (coef.astype(np.int64) * quant.astype(np.int64)).reshape(-1, 8, 8)
    ws = np.stack([_descale(o, CONST_BITS - PASS1_BITS)
                   for o in _idct_1d([z[:, k, :] for k in range(8)])], 1)
    out = np.stack([_descale(o, CONST_BITS + PASS1_BITS + 3)
                    for o in _idct_1d([ws[:, :, k] for k in range(8)])], 2)
    signed = ((out + 512) & 1023) - 512      # the table's index & RANGE_MASK
    return np.clip(signed + 128, 0, 255).astype(np.uint8)


# ------------------------------------------------------------ upsampling
def _rows(p, i, n):
    return p[np.clip(i, 0, n - 1)]


def _h2v1_fancy(p):
    """jdsample.c h2v1_fancy_upsample over [rows, dw] int64."""
    left = np.concatenate([p[:, :1], p[:, :-1]], 1)
    right = np.concatenate([p[:, 1:], p[:, -1:]], 1)
    out = np.empty((p.shape[0], 2 * p.shape[1]), np.int64)
    out[:, 0::2] = (3 * p + left + 1) >> 2
    out[:, 1::2] = (3 * p + right + 2) >> 2
    return out


def _h1v2_fancy(p):
    """jdsample.c h1v2_fancy_upsample over [dh, cols] int64."""
    n = p.shape[0]
    i = np.arange(n)
    out = np.empty((2 * n, p.shape[1]), np.int64)
    out[0::2] = (3 * p + _rows(p, i - 1, n) + 1) >> 2
    out[1::2] = (3 * p + _rows(p, i + 1, n) + 2) >> 2
    return out


def _h2v2_fancy(p):
    """jdsample.c h2v2_fancy_upsample over [dh, dw] int64: column sums of
    the nearer row (x3) and the further one, then 3/4 and 1/4 across."""
    n = p.shape[0]
    i = np.arange(n)
    out = np.empty((2 * n, 2 * p.shape[1]), np.int64)
    for v, other in ((0, _rows(p, i - 1, n)), (1, _rows(p, i + 1, n))):
        cs = 3 * p + other
        left = np.concatenate([cs[:, :1], cs[:, :-1]], 1)
        right = np.concatenate([cs[:, 1:], cs[:, -1:]], 1)
        out[v::2, 0::2] = (3 * cs + left + 8) >> 4
        out[v::2, 1::2] = (3 * cs + right + 7) >> 4
    return out


def _upsample(p, h, v):
    """A chroma plane [dh, dw] to the luma's sampling (h, v = its factors
    relative to the chroma's)."""
    if h == 1 and v == 1:
        return p
    if p.shape[1] <= 2 and h == 2:         # jinit_upsampler: box filter
        return np.repeat(np.repeat(p, h, 1), v, 0)
    if h == 2 and v == 1:
        return _h2v1_fancy(p)
    if h == 1:
        return _h1v2_fancy(p)
    return _h2v2_fancy(p)


def ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """jdcolor.c ycc_rgb_convert on int64 planes: uint8 [H, W, 3]."""
    x_cb, x_cr = cb - 128, cr - 128
    r = y + ((_fix16(1.40200) * x_cr + (1 << 15)) >> 16)
    b = y + ((_fix16(1.77200) * x_cb + (1 << 15)) >> 16)
    g = y + ((-_fix16(0.34414) * x_cb + (1 << 15)
              - _fix16(0.71414) * x_cr) >> 16)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


# --------------------------------------------------------------- decoder
def _u16(data, i):
    return (data[i] << 8) | data[i + 1]


def decode_jpeg(data: bytes) -> np.ndarray:
    """A baseline JPEG's pixels: uint8 [H, W, 3] RGB for 3 components,
    [H, W] for 1, equal to Pillow's (libjpeg-turbo's default) decode."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file: no SOI marker")
    pos, qt, htab = 2, {}, {}
    restart, frame, adobe, jfif = 0, None, None, False
    comps, coefs, decoded = [], None, set()
    while True:
        if pos + 1 >= len(data):
            raise ValueError("truncated JPEG data: no EOI marker")
        if data[pos] != 0xFF:
            raise ValueError(f"corrupt JPEG data: 0x{data[pos]:02x} where "
                             f"a marker should start")
        while pos + 1 < len(data) and data[pos + 1] == 0xFF:
            pos += 1                                  # fill bytes
        marker = data[pos + 1]
        pos += 2
        if marker == 0xD9:
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        if pos + 2 > len(data):
            raise ValueError("truncated JPEG data: a segment's length")
        n = _u16(data, pos)
        seg = data[pos + 2:pos + n]
        if n < 2 or len(seg) != n - 2:
            raise ValueError(f"truncated JPEG data: marker 0x{marker:02x}'s"
                             f" segment")
        pos += n
        if marker in _SOF_REFUSED:
            raise ValueError(f"JPEG {_SOF_REFUSED[marker]} is not "
                             f"supported: baseline Huffman only")
        if marker == 0xDB:                                       # DQT
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                size = 64 * (pq + 1)
                if pq > 1 or i + 1 + size > len(seg):
                    raise ValueError("corrupt DQT segment")
                raw = np.frombuffer(seg[i + 1:i + 1 + size],
                                    ">u2" if pq else np.uint8)
                tab = np.zeros(64, np.int64)
                tab[ZIGZAG] = raw
                qt[tq] = tab
                i += 1 + size
        elif marker == 0xC4:                                     # DHT
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = tuple(seg[i + 1:i + 17])
                nv = sum(counts)
                if tc > 1 or len(counts) < 16 or i + 17 + nv > len(seg):
                    raise ValueError("corrupt DHT segment")
                vals = tuple(seg[i + 17:i + 17 + nv])
                htab[tc, th] = (_ac_table if tc else _dc_table)(counts, vals)
                i += 17 + nv
        elif marker == 0xDD and len(seg) >= 2:                   # DRI
            restart = _u16(seg, 0)
        elif marker in (0xC0, 0xC1):                             # SOF0/1
            if frame is not None:
                raise ValueError("corrupt JPEG data: two SOF markers")
            if len(seg) < 6 or len(seg) < 6 + 3 * seg[5]:
                raise ValueError("corrupt SOF segment")
            prec, H, W, nf = seg[0], _u16(seg, 1), _u16(seg, 3), seg[5]
            if prec != 8:
                raise ValueError(f"{prec}-bit JPEG samples are not "
                                 f"supported: 8-bit only")
            if nf not in (1, 3):
                raise ValueError(f"a JPEG of {nf} components (CMYK/YCCK at "
                                 f"4) is not supported: 1 or 3 only")
            if H == 0 or W == 0:
                raise ValueError("a JPEG frame of height 0 (DNL) is not "
                                 "supported")
            comps = [dict(id=seg[6 + 3 * c], h=seg[7 + 3 * c] >> 4,
                          v=seg[7 + 3 * c] & 15, tq=seg[8 + 3 * c])
                     for c in range(nf)]
            hv = [(c["h"], c["v"]) for c in comps]
            if hv[0][0] not in (1, 2) or hv[0][1] not in (1, 2) or \
                    any(f != (1, 1) for f in hv[1:]):
                raise ValueError(f"JPEG sampling factors {hv} are not "
                                 f"supported: luma h, v in (1, 2) with 1x1 "
                                 f"chroma")
            frame = (H, W)
            hmax = max(c["h"] for c in comps) if nf == 3 else 1
            vmax = max(c["v"] for c in comps) if nf == 3 else 1
            mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
            off = 0
            for c in comps:
                h, v = (c["h"], c["v"]) if nf == 3 else (1, 1)
                c.update(h=h, v=v, dw=-(-W * h // hmax), dh=-(-H * v // vmax),
                         bw=mcux * h, bh=mcuy * v, off=off)
                off += c["bw"] * c["bh"]
            coefs = array.array("i", bytes(4 * 64 * off))
        elif marker == 0xDA:                                     # SOS
            if frame is None:
                raise ValueError("corrupt JPEG data: SOS before SOF")
            ns = seg[0] if seg else 0
            if ns == 0 or len(seg) < 4 + 2 * ns:
                raise ValueError("corrupt SOS segment")
            byid = {c["id"]: c for c in comps}
            scomp = [(byid.get(seg[1 + 2 * j]), seg[2 + 2 * j] >> 4,
                      seg[2 + 2 * j] & 15) for j in range(ns)]
            ss, se, ahl = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns]
            if ss != 0 or se != 63 or ahl != 0 or \
                    any(c is None for c, _, _ in scomp):
                raise ValueError("corrupt JPEG data: a sequential scan "
                                 "with spectral selection or unknown "
                                 "components")
            pattern, blocks = _scan_layout(scomp, comps, htab, qt, decoded)
            segs, pos = _scan_segments(data, pos)
            try:
                _decode_scan(segs, blocks, pattern, restart,
                             len(blocks) // len(pattern), coefs)
            except IndexError:
                raise ValueError("truncated JPEG data: the scan ends "
                                 "before its last block") from None
        elif marker == 0xE0 and seg[:5] == b"JFIF\0":
            jfif = True
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe = seg[11]
    if frame is None or len(decoded) != len(comps):
        raise ValueError("truncated JPEG data: a component has no scan")
    if len(comps) == 3 and not jfif and (
            adobe == 0 or (adobe is None and [c["id"] for c in comps]
                           == [82, 71, 66])):
        raise ValueError("a JPEG in RGB (no YCbCr transform) is not "
                         "supported")
    H, W = frame
    allc = np.frombuffer(coefs, np.int32).reshape(-1, 64)[:, _UNZIGZAG]
    planes = []
    for c in comps:
        blk = allc[c["off"]:c["off"] + c["bw"] * c["bh"]]
        pix = idct_islow(blk, c["quant"]).reshape(c["bh"], c["bw"], 8, 8)
        plane = pix.transpose(0, 2, 1, 3).reshape(8 * c["bh"], 8 * c["bw"])
        planes.append(plane[:c["dh"], :c["dw"]].astype(np.int64))
    if len(comps) == 1:
        return planes[0][:H, :W].astype(np.uint8)
    y = planes[0]
    h0, v0 = comps[0]["h"], comps[0]["v"]
    cb, cr = (_upsample(p, h0, v0)[:H, :W] for p in planes[1:])
    return ycc_to_rgb(y[:H, :W], cb, cr)


def _scan_layout(scomp, comps, htab, qt, decoded):
    """(pattern, blocks) of a scan: (slot, DC table, AC table) per block of
    an MCU, and each decoded block's index in the coefficient store. One
    component: its blocks in raster order; several: interleaved MCUs."""
    pattern = []
    for slot, (c, td, ta) in enumerate(scomp):
        if (0, td) not in htab or (1, ta) not in htab:
            raise ValueError("corrupt JPEG data: a scan names a Huffman "
                             "table no DHT defined")
        if c["tq"] not in qt:
            raise ValueError("corrupt JPEG data: a component names a "
                             "quantization table no DQT defined")
        c["quant"] = qt[c["tq"]].copy()        # latched at its scan
        decoded.add(c["id"])
        n = 1 if len(scomp) == 1 else c["h"] * c["v"]
        pattern += [(slot, htab[0, td], htab[1, ta])] * n
    if len(scomp) == 1:
        c = scomp[0][0]
        r, q = np.mgrid[0:-(-c["dh"] // 8), 0:-(-c["dw"] // 8)]
        return pattern, (c["off"] + r * c["bw"] + q).reshape(-1).tolist()
    mcux = comps[0]["bw"] // comps[0]["h"]
    mcuy = comps[0]["bh"] // comps[0]["v"]
    my, mx = np.mgrid[0:mcuy, 0:mcux]
    per = []
    for c, _, _ in scomp:
        for v in range(c["v"]):
            for h in range(c["h"]):
                per.append(c["off"] + (my * c["v"] + v) * c["bw"]
                           + mx * c["h"] + h)
    return pattern, np.stack(per, -1).reshape(-1).tolist()


def read_jpeg(path: str) -> np.ndarray:
    """`decode_jpeg` of a file."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read())


# --------------------------------------------------------------- encoder
# Annex K.1 quantization tables, natural order
STD_LUMA_QT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
STD_CHROMA_QT = np.full(64, 99)
STD_CHROMA_QT[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]

# Annex K.3 Huffman tables: (code counts by length 1-16, symbols)
_AC_LUMA_SYMS = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7"
    "c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")
_AC_CHROMA_SYMS = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")
STD_HUFFMAN = {
    (0, 0): ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
             list(range(12))),
    (0, 1): ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
             list(range(12))),
    (1, 0): ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D],
             list(_AC_LUMA_SYMS)),
    (1, 1): ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77],
             list(_AC_CHROMA_SYMS)),
}


def quality_tables(quality: int):
    """jcparam.c jpeg_set_quality: the Annex K tables scaled, baseline."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return [np.clip((t * scale + 50) // 100, 1, 255)
            for t in (STD_LUMA_QT, STD_CHROMA_QT)]


def _fdct_1d(d):
    """jfdctint.c's 1-D stage on d[0..7]: outputs 0 and 4 unscaled, the
    others before their descale."""
    t0, t7 = d[0] + d[7], d[0] - d[7]
    t1, t6 = d[1] + d[6], d[1] - d[6]
    t2, t5 = d[2] + d[5], d[2] - d[5]
    t3, t4 = d[3] + d[4], d[3] - d[4]
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    z1 = (t12 + t13) * F_0_541
    even = (t10 + t11, z1 + t13 * F_0_765, t10 - t11, z1 - t12 * F_1_847)
    z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
    z5 = (z3 + z4) * F_1_175
    z1, z2 = z1 * -F_0_899, z2 * -F_2_562
    z3, z4 = z3 * -F_1_961 + z5, z4 * -F_0_390 + z5
    odd = (t7 * F_1_501 + z1 + z4, t6 * F_3_072 + z2 + z3,
           t5 * F_2_053 + z2 + z4, t4 * F_0_298 + z1 + z3)
    return even, odd


def fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """jpeg_fdct_islow over [N, 8, 8] centred samples: int64 [N, 8, 8]
    coefficients, scaled up by 8."""
    def stage(rows, first):
        even, odd = _fdct_1d(rows)
        sh = CONST_BITS - PASS1_BITS if first else CONST_BITS + PASS1_BITS
        e0, e4 = ((even[0] << PASS1_BITS, even[2] << PASS1_BITS) if first
                  else (_descale(even[0], PASS1_BITS),
                        _descale(even[2], PASS1_BITS)))
        return [e0, _descale(odd[0], sh), _descale(even[1], sh),
                _descale(odd[1], sh), e4, _descale(odd[2], sh),
                _descale(even[3], sh), _descale(odd[3], sh)]
    x = blocks.astype(np.int64)
    ws = np.stack(stage([x[:, :, k] for k in range(8)], True), 2)
    return np.stack(stage([ws[:, k, :] for k in range(8)], False), 1)


def _huffman_codes(counts, values):
    """(code, length) indexed by symbol (256 each) for encoding."""
    codes, lengths = _canonical_codes(counts, values)
    co, le = np.zeros(256, np.int64), np.zeros(256, np.int64)
    co[list(values)], le[list(values)] = codes, lengths
    return co, le


def _bit_length(x):
    t = np.abs(x)
    return sum(((t >> b) > 0).astype(np.int64) for b in range(16))


def _entropy_code(zz, table, dc_diff):
    """The baseline Huffman bit stream of blocks zz [N, 64] (zigzag order,
    in scan order) with their DC differences, as (codes, lengths) items in
    stream order; table [N] is 0 (luma) or 1 (chroma)."""
    tabs = {k: _huffman_codes(*v) for k, v in STD_HUFFMAN.items()}

    def pick(cls, sym, t):
        co = np.where(t == 0, tabs[cls, 0][0][sym], tabs[cls, 1][0][sym])
        le = np.where(t == 0, tabs[cls, 0][1][sym], tabs[cls, 1][1][sym])
        return co, le

    def extra(x, s):
        return (x - (x < 0)) & ((1 << s) - 1)

    n = zz.shape[0]
    keys, codes, lens = [], [], []
    s = _bit_length(dc_diff)
    co, le = pick(0, s, table)
    keys.append(np.arange(n) * 1024)
    codes.append((co << s) | extra(dc_diff, s))
    lens.append(le + s)
    b, k = np.nonzero(zz[:, 1:])
    k = k + 1
    prev = np.where(np.r_[False, b[1:] == b[:-1]], np.r_[0, k[:-1]], 0)
    run = k - prev - 1
    v = zz[b, k]
    s = _bit_length(v)
    co, le = pick(1, ((run & 15) << 4) | s, table[b])
    keys.append(b * 1024 + k * 4 + 3)
    codes.append((co << s) | extra(v, s))
    lens.append(le + s)
    nz = run >> 4
    zb = np.repeat(np.arange(len(b)), nz)
    zj = np.arange(len(zb)) - np.repeat(np.cumsum(nz) - nz, nz)
    co, le = pick(1, np.full(len(zb), 0xF0), table[b[zb]])
    keys.append(b[zb] * 1024 + k[zb] * 4 + zj)
    codes.append(co)
    lens.append(le)
    last = np.zeros(n, np.int64)
    last[b] = k                             # k ascends within a block
    eob = np.flatnonzero(last < 63)
    co, le = pick(1, np.zeros(len(eob), np.int64), table[eob])
    keys.append(eob * 1024 + 256)
    codes.append(co)
    lens.append(le)
    order = np.argsort(np.concatenate(keys), kind="stable")
    return np.concatenate(codes)[order], np.concatenate(lens)[order]


def _pack_bits(codes, lens) -> bytes:
    """Codes of the given lengths, MSB first, padded with 1-bits to a byte,
    with a 0x00 stuffed after every 0xFF."""
    total = int(lens.sum())
    item = np.repeat(np.arange(len(lens)), lens)
    j = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
    bits = ((codes[item] >> (lens[item] - 1 - j)) & 1).astype(np.uint8)
    bits = np.concatenate([bits, np.ones(-total % 8, np.uint8)])
    by = np.packbits(bits)
    return np.insert(by, np.flatnonzero(by == 0xFF) + 1, 0).tobytes()


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def encode_jpeg(rgb: np.ndarray, quality: int = 75) -> bytes:
    """A baseline 4:2:0 JFIF of a uint8 [H, W, 3] RGB image."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError("encode_jpeg takes uint8 [H, W, 3] RGB")
    H, W = rgb.shape[:2]
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half, off = 1 << 15, 128 << 16
    y = (_fix16(0.29900) * r + _fix16(0.58700) * g + _fix16(0.11400) * b
         + half) >> 16
    cb = (-_fix16(0.16874) * r - _fix16(0.33126) * g + _fix16(0.5) * b
          + off + half - 1) >> 16
    cr = (_fix16(0.5) * r - _fix16(0.41869) * g - _fix16(0.08131) * b
          + off + half - 1) >> 16
    Hp, Wp = -(-H // 16) * 16, -(-W // 16) * 16
    pad = ((0, Hp - H), (0, Wp - W))
    y = np.pad(y, pad, mode="edge")
    bias = np.tile([1, 2], Wp // 4)
    chroma = []
    for c in (cb, cr):
        c = np.pad(c, pad, mode="edge")
        chroma.append((c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2]
                       + c[1::2, 1::2] + bias) >> 2)
    my, mx = Hp // 16, Wp // 16

    yb = y.reshape(my, 2, 8, mx, 2, 8).transpose(0, 3, 1, 4, 2, 5) \
        .reshape(my * mx, 4, 8, 8)
    cbb, crb = (c.reshape(my, 8, mx, 8).transpose(0, 2, 1, 3)
                .reshape(my * mx, 1, 8, 8) for c in chroma)
    mcu = np.concatenate([yb, cbb, crb], 1).reshape(-1, 8, 8)
    table = np.tile([0, 0, 0, 0, 1, 1], my * mx)
    comp = np.tile([0, 0, 0, 0, 1, 2], my * mx)
    qtabs = quality_tables(quality)
    div = np.stack([qtabs[t] for t in table]).reshape(-1, 64) * 8
    coef = fdct_islow(mcu - 128).reshape(-1, 64)
    quant = np.sign(coef) * ((np.abs(coef) + div // 2) // div)
    zz = quant[:, ZIGZAG]
    dc_diff = np.zeros(len(zz), np.int64)
    for c in range(3):
        sel = comp == c
        dc_diff[sel] = np.diff(zz[sel, 0], prepend=0)
    scan = _pack_bits(*_entropy_code(zz, table, dc_diff))

    out = [b"\xff\xd8",
           _segment(0xE0, b"JFIF\0\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for t, q in enumerate(qtabs):
        out.append(_segment(0xDB, bytes([t]) + bytes(q[ZIGZAG].tolist())))
    out.append(_segment(0xC0, struct.pack(">BHHB", 8, H, W, 3)
                        + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for (tc, th), (counts, vals) in STD_HUFFMAN.items():
        out.append(_segment(0xC4, bytes([tc << 4 | th] + counts + vals)))
    out.append(_segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11,
                                     0, 63, 0])))
    out += [scan, b"\xff\xd9"]
    return b"".join(out)


def write_jpeg(path: str, rgb: np.ndarray, quality: int = 75) -> None:
    """Write `encode_jpeg(rgb, quality)` to `path`."""
    with open(path, "wb") as f:
        f.write(encode_jpeg(rgb, quality))
