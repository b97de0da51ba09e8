"""Package hygiene: the port never imports JAX (nor a JAX-importing module of
the JAX package), and CPU runs never launch a CUDA kernel."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pointnerf_tpu_torch.ops import kernels
from pointnerf_tpu_torch.ops import query as tq
from pointnerf_tpu_torch.ops import trunk as tt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import pointnerf_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in mods:
    importlib.import_module(name)
allowed = {"pointnerf_tpu", "pointnerf_tpu.config", "pointnerf_tpu.utils",
           "pointnerf_tpu.utils.cache"}
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "optax")
       or (m.startswith("pointnerf_tpu.") and m not in allowed)]
print(len(mods), bad)
sys.exit(1 if bad or len(mods) < 14 else 0)
"""


def test_port_modules_import_without_jax():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cpu_paths_launch_no_kernel_and_other_devices_are_refused():
    """The kernel wrappers take their plain versions only for CPU tensors;
    any other device must launch (CUDA) or raise — never fall back."""
    from test_torch_port_query import query_workload
    campos, rd, t, _, _, grid_t, _, spec_t = query_workload(0, B=1, R=4, D=16)
    mask, over = tq.mask_raypos_segmented(
        torch.as_tensor(campos), torch.as_tensor(rd), torch.as_tensor(t),
        grid_t, spec_t)
    assert mask.any() and int(over) == 0
    rng = np.random.RandomState(0)
    lin = lambda i, o: torch.as_tensor(rng.normal(0, 0.1, (i, o)),
                                       dtype=torch.float32)
    ops = [lin(4, 16), lin(8, 16), lin(12, 16), lin(1, 16),
           lin(16, 16), lin(7, 16), lin(1, 16), lin(16, 1), lin(1, 1)]
    args = [lin(8, 4), lin(8, 6), lin(8, 7), lin(8, 1)]
    feat, alpha = tt.fused_trunk(1, 1, 1, 1, 8, True, False, *args, ops)
    assert feat.shape == (1, 16) and alpha.shape == (1, 1)
    assert kernels.TRUNK_FWD.launches == 0
    assert kernels.OCCUPANCY.launches == 0
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="cpu or cuda"):
        tt.fused_trunk(1, 1, 1, 1, 8, True, False, *meta, ops)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tq.mask_raypos_segmented(torch.zeros(1, 3, device="meta"),
                                 torch.zeros(1, 4, 3, device="meta"),
                                 torch.zeros(1, 4, 16, device="meta"),
                                 grid_t, spec_t)
