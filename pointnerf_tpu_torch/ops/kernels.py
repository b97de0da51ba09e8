"""The port's hand-written CUDA kernels: build, load and bookkeeping.

The sources in ``pointnerf_tpu_torch/csrc/*.cu`` expose a plain C interface.
At first use they are compiled by ``nvcc`` for ``sm_90a`` into one shared
library under ``build/kernels/`` (named by a hash of the sources, so an edit
rebuilds) and loaded with ctypes. Nothing here runs at import time, so the
package imports on a machine without CUDA; the CPU paths never call
`library()`.

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
OCCUPANCY = Kernel("occupancy", "pointnerf_tpu_torch/csrc/occupancy.cu",
                   "pointnerf_tpu/ops/query.py:122")
KERNELS = (TRUNK_FWD, OCCUPANCY)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # pointers..., ints..., stream
    "trunk_fwd": [_P] * 16 + [_I] * 13 + [_P],
    "occupancy": [_P] * 5 + [ctypes.c_longlong] * 3 + [_I] * 3
    + [ctypes.c_float] * 6 + [_I] * 3 + [_P],
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


def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernels' shared library."""
    if _Build.lib is not None:
        return _Build.lib
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha1()
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"libpointnerf_kernels_{digest.hexdigest()[:12]}.so"
    if not so.exists():
        t0 = time.perf_counter()
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        _Build.log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{_Build.log}")
        os.replace(tmp, so)
        _Build.seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
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


def require(t: torch.Tensor, name: str, dtype, device, shape=None) -> None:
    """Validate a kernel operand before its pointer is passed."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
