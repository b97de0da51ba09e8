"""PFM depth-map IO (copy of `pointnerf_tpu/data/pfm.py`, numpy only;
replaces the read_pfm in reference mvs_utils.py:228-258)."""

from __future__ import annotations

import re

import numpy as np


def read_pfm(path: str):
    with open(path, "rb") as f:
        header = f.readline().decode("ascii").rstrip()
        if header == "PF":
            channels = 3
        elif header == "Pf":
            channels = 1
        else:
            raise ValueError(f"{path}: not a PFM file")
        m = re.match(r"^(\d+)\s+(\d+)\s*$", f.readline().decode("ascii"))
        if not m:
            raise ValueError(f"{path}: malformed PFM dims")
        width, height = map(int, m.groups())
        scale = float(f.readline().decode("ascii").rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.frombuffer(f.read(), endian + "f4")
        shape = (height, width, 3) if channels == 3 else (height, width)
        data = data.reshape(shape)
        # PFM stores rows bottom-to-top
        return np.ascontiguousarray(data[::-1]), abs(scale)


def write_pfm(path: str, image: np.ndarray, scale: float = 1.0):
    image = np.asarray(image, np.float32)
    color = image.ndim == 3 and image.shape[2] == 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode("ascii"))
        f.write(f"{-scale}\n".encode("ascii"))  # little-endian
        f.write(np.ascontiguousarray(image[::-1]).astype("<f4").tobytes())
