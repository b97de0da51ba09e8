"""The port's hand-written CUDA kernels: build, load and bookkeeping.

The sources in ``pointnerf_tpu_torch/csrc/*.cu`` expose a plain C interface.
At first use each is compiled by its own ``nvcc`` process for ``sm_90a``,
all started together, into a shared library under ``build/kernels/``
(named by a hash of the source and the shared ``csrc/*.cuh`` headers, so
an edit rebuilds it) and loaded with
ctypes. Nothing here runs at import time, so the package imports on a
machine without CUDA; the CPU paths never call `library()`.

Each kernel has a `Kernel` record whose `launches` count its wrapper
increments once per launch, so a run can show that it went through the
kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


@dataclass
class Kernel:
    name: str
    source: str        # path in the repository
    replaces: str      # the Pallas kernel it replaces (file:line)
    launches: int = 0


TRUNK_FWD = Kernel("trunk_fwd", "pointnerf_tpu_torch/csrc/trunk_fwd.cu",
                   "pointnerf_tpu/ops/pallas_trunk.py:168")
TRUNK_BWD = Kernel("trunk_bwd", "pointnerf_tpu_torch/csrc/trunk_bwd.cu",
                   "pointnerf_tpu/ops/pallas_trunk.py:191")
OCCUPANCY = Kernel("occupancy", "pointnerf_tpu_torch/csrc/occupancy.cu",
                   "pointnerf_tpu/ops/query.py:122")
SHADE_FWD = Kernel("shade_fwd", "pointnerf_tpu_torch/csrc/shade_fwd.cu",
                   "pointnerf_tpu/ops/pallas_trunk.py:512")
SHADE_BWD = Kernel("shade_bwd", "pointnerf_tpu_torch/csrc/shade_bwd.cu",
                   "pointnerf_tpu/ops/pallas_trunk.py:543")
SCATTER_ROWS = Kernel("scatter_rows", "pointnerf_tpu_torch/csrc/scatter_rows.cu",
                      "scripts/scatter_pallas.py:68")
ROW_SELECT = Kernel("row_select", "pointnerf_tpu_torch/csrc/row_select.cu",
                    "scripts/occ_micro3.py:134")
KERNELS = (TRUNK_FWD, TRUNK_BWD, OCCUPANCY, SHADE_FWD, SHADE_BWD,
           SCATTER_ROWS, ROW_SELECT)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # pointers..., ints..., stream
    "trunk_fwd": [_P] * 16 + [_I] * 13 + [_P],
    "trunk_bwd": [_P] * 26 + [_I] * 14 + [_P],
    "occupancy": [_P] * 5 + [ctypes.c_longlong] * 3 + [_I] * 3
    + [ctypes.c_float] * 6 + [_I] * 3 + [_P],
    "shade_fwd": [_P] * 25 + [_I] * 12 + [_P],
    "shade_bwd": [_P] * 37 + [_I] * 13 + [_P],
    "scatter_rows": [_P] * 3 + [_I] * 3 + [_P],
    "row_select": [_P] * 4 + [_I] * 4 + [ctypes.c_longlong] + [_I] * 2
    + [_P],
}


class _Build:
    lib = None
    log = ""
    seconds = 0.0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


class _Library:
    """The kernels' C entry points by name, each from its own library."""


def _so_path(src: Path) -> Path:
    """The library of `src`, named by a hash of the source, the headers it
    may include and the flags."""
    digest = hashlib.sha1(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}_{digest.hexdigest()[:12]}.so"


def library() -> _Library:
    """Build (once per source hash, one nvcc per source, all in parallel)
    and load the kernels' shared libraries."""
    if _Build.lib is not None:
        return _Build.lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sos = {src: _so_path(src) for src in sorted(CSRC.glob("*.cu"))}
    t0 = time.perf_counter()
    procs = []
    for src, so in sos.items():
        if not so.exists():
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs.append((so, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    logs, failed = [], []
    for so, tmp, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {so.name}\n{out}")
        if proc.returncode != 0:
            failed.append(so.name)
        else:
            os.replace(tmp, so)
    _Build.log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{_Build.log}")
    if procs:
        _Build.seconds = time.perf_counter() - t0
    lib = _Library()
    for so in sos.values():
        cdll = ctypes.CDLL(str(so))
        for name, args in _SIGNATURES.items():
            fn = getattr(cdll, name, None)
            if fn is not None:
                fn.argtypes = args
                fn.restype = ctypes.c_int
                setattr(lib, name, fn)
    missing = [n for n in _SIGNATURES if not hasattr(lib, n)]
    if missing:
        raise RuntimeError(f"no kernel library exports {missing}")
    _Build.lib = lib
    return lib


def build_info():
    """(seconds spent compiling in this process, nvcc's output)."""
    return _Build.seconds, _Build.log


def check(err: int, kernel: Kernel) -> None:
    """Raise on a nonzero cudaGetLastError() returned by a launch."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel.name} failed to launch: "
                           f"cudaError {err}")


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, dtype, device, shape=None,
            aligned: bool = False) -> None:
    """Validate a kernel operand before its pointer is passed; `aligned`
    operands are read with 16-byte copies."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if aligned and t.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned")
