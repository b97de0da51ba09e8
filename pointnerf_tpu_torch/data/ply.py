"""Minimal PLY reader/writer (copy of `pointnerf_tpu/data/ply.py`; it
replaces the plyfile dependency).

Reference loads COLMAP fused.ply / ScanNet meshes via plyfile
(nerf_synth360_ft_dataset.py:356-373, scannet_ft_dataset.py:375-410). Supports
ascii and binary_little_endian vertex elements with float/double/uchar/int
properties — enough for COLMAP fused.ply, ScanNet *_vh_clean_2.ply, and our
own exports.
"""

from __future__ import annotations

import io
from typing import Dict, Optional, Tuple

import numpy as np

_TYPES = {
    "float": ("<f4", 4), "float32": ("<f4", 4),
    "double": ("<f8", 8), "float64": ("<f8", 8),
    "uchar": ("u1", 1), "uint8": ("u1", 1),
    "char": ("i1", 1), "int8": ("i1", 1),
    "short": ("<i2", 2), "int16": ("<i2", 2),
    "ushort": ("<u2", 2), "uint16": ("<u2", 2),
    "int": ("<i4", 4), "int32": ("<i4", 4),
    "uint": ("<u4", 4), "uint32": ("<u4", 4),
}


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Returns {property_name: array} for the `vertex` element (+ `face` ignored)."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header\n")
    if header_end < 0:
        raise ValueError(f"{path}: not a PLY file")
    header = data[:header_end].decode("ascii").splitlines()
    body = data[header_end + len(b"end_header\n"):]

    if not header or header[0].strip() != "ply":
        raise ValueError(f"{path}: missing ply magic")
    fmt = None
    elements = []  # (name, count, [(prop_name, type_str)])
    for line in header[1:]:
        parts = line.strip().split()
        if not parts or parts[0] == "comment":
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append((parts[-1], ("list", parts[2], parts[3])))
            else:
                elements[-1][2].append((parts[2], parts[1]))

    out: Dict[str, np.ndarray] = {}
    if fmt == "ascii":
        text = io.StringIO(body.decode("ascii"))
        for name, count, props in elements:
            if any(isinstance(t, tuple) for _, t in props):  # list props (faces)
                for _ in range(count):
                    text.readline()
                continue
            rows = np.loadtxt(text, max_rows=count, ndmin=2)
            if name == "vertex":
                for j, (pname, ptype) in enumerate(props):
                    out[pname] = rows[:, j].astype(_TYPES[ptype][0])
    elif fmt == "binary_little_endian":
        off = 0
        for name, count, props in elements:
            if any(isinstance(t, tuple) for _, t in props):
                # variable-length faces: walk them
                for _ in range(count):
                    for pname, ptype in props:
                        cnt_t, item_t = ptype[1], ptype[2]
                        cdt, csz = _TYPES[cnt_t]
                        n = int(np.frombuffer(body, cdt, 1, off)[0])
                        off += csz + n * _TYPES[item_t][1]
                continue
            dt = np.dtype([(p, _TYPES[t][0]) for p, t in props])
            arr = np.frombuffer(body, dt, count, off)
            off += dt.itemsize * count
            if name == "vertex":
                for pname, _ in props:
                    out[pname] = np.ascontiguousarray(arr[pname])
    else:
        raise ValueError(f"{path}: unsupported PLY format {fmt}")
    return out


def read_ply_points(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(xyz [N,3] float32, rgb [N,3] float32 in [0,1] or None)."""
    props = read_ply(path)
    xyz = np.stack([props["x"], props["y"], props["z"]], -1).astype(np.float32)
    rgb = None
    if all(k in props for k in ("red", "green", "blue")):
        rgb = np.stack([props["red"], props["green"], props["blue"]], -1)
        rgb = rgb.astype(np.float32)
        if rgb.max() > 1.0 + 1e-6:
            rgb = rgb / 255.0
    return xyz, rgb


def write_ply_points(path: str, xyz: np.ndarray, rgb: Optional[np.ndarray] = None,
                     binary: bool = True) -> None:
    xyz = np.asarray(xyz, np.float32)
    n = xyz.shape[0]
    props = ["property float x", "property float y", "property float z"]
    if rgb is not None:
        rgb8 = (np.clip(np.asarray(rgb), 0, 1) * 255).astype(np.uint8)
        props += ["property uchar red", "property uchar green", "property uchar blue"]
    header = ("ply\nformat {} 1.0\nelement vertex {}\n{}\nend_header\n").format(
        "binary_little_endian" if binary else "ascii", n, "\n".join(props))
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            if rgb is None:
                f.write(xyz.astype("<f4").tobytes())
            else:
                dt = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                               ("r", "u1"), ("g", "u1"), ("b", "u1")])
                rec = np.empty(n, dt)
                rec["x"], rec["y"], rec["z"] = xyz.T
                rec["r"], rec["g"], rec["b"] = rgb8.T
                f.write(rec.tobytes())
        else:
            for i in range(n):
                row = "%g %g %g" % tuple(xyz[i])
                if rgb is not None:
                    row += " %d %d %d" % tuple(rgb8[i])
                f.write((row + "\n").encode("ascii"))
