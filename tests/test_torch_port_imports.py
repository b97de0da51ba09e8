"""Package hygiene: the port never imports JAX nor any module of the JAX
package, its constructors default to the card, and CPU runs never launch a
CUDA kernel."""

import inspect
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
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "optax", "pointnerf_tpu")]
print(len(mods), bad)
sys.exit(1 if bad or len(mods) < 14 else 0)
"""


def test_port_modules_import_without_jax():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("module", ["pointnerf_tpu_torch.ops.sh",
                                    "pointnerf_tpu_torch.ops.geometry"])
def test_copied_numeric_modules_import_alone(module):
    """The port's copies of the JAX package's ops/sh.py and
    ops/geometry.py import on their own without JAX or the JAX package."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    probe = (f"import sys, {module} as m\n"
             "bad = [n for n in sys.modules if n.split('.')[0] in "
             "('jax', 'jaxlib', 'pointnerf_tpu')]\n"
             "sys.exit(1 if bad or not m.__file__.startswith(sys.argv[1]) "
             "else 0)")
    proc = subprocess.run([sys.executable, "-c", probe,
                           os.path.join(REPO, "pointnerf_tpu_torch")],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_constructors_default_to_the_card():
    """The four constructors of the port's state place it on the card
    unless told otherwise; where there is none, the default raises as
    torch raises, with no fallback to the CPU."""
    from pointnerf_tpu_torch.config import Options
    from pointnerf_tpu_torch.models import neural_points as npc
    from pointnerf_tpu_torch.models.aggregator import init_aggregator_params
    from pointnerf_tpu_torch.utils import checkpoint
    for fn in (npc.create_point_cloud, init_aggregator_params,
               checkpoint.from_jax_params, checkpoint.from_jax_train_state):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present, so the default does not raise")
    xyz, emb = np.zeros((4, 3), np.float32), np.zeros((4, 8), np.float32)
    with pytest.raises((AssertionError, RuntimeError)):
        npc.create_point_cloud(xyz, emb)
    with pytest.raises((AssertionError, RuntimeError)):
        init_aggregator_params(Options(point_features_dim=8))
    state = npc.create_point_cloud(xyz, emb, device="cpu")
    assert state["xyz"].device.type == "cpu"


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
    # fused_shade: dist mode 0 (3 distance columns), K=8, one shading point
    rows = [lin(8, 4), lin(8, 3), lin(8, 3), lin(8, 3), lin(8, 3), lin(8, 1),
            torch.ones(8, 1), lin(1, 3), lin(1, 3), lin(1, 3), lin(3, 3)]
    ops0 = [lin(4, 16), lin(8, 16), lin(6, 16)] + ops[3:]
    out = tt.fused_shade(1, 1, 1, 1, 8, True, False, 0, *rows, ops0)
    assert [tuple(o.shape) for o in out] == [(1, 16), (1, 1), (8, 1), (8, 1)]
    assert not any(k.launches for k in kernels.KERNELS)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tt.fused_shade(1, 1, 1, 1, 8, True, False, 0,
                       *(r.to("meta") for r in rows), ops0)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tq.mask_raypos_segmented(torch.zeros(1, 3, device="meta"),
                                 torch.zeros(1, 4, 3, device="meta"),
                                 torch.zeros(1, 4, 16, device="meta"),
                                 grid_t, spec_t)


_IMAGE_LIBS = ("PIL", "cv2", "imageio")


def _imported_modules(path):
    """Top-level names of every module a file imports, at any depth of its
    code (inside functions and try blocks too)."""
    import ast
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_port_imports_no_image_library():
    """Neither a module of the port nor chip_smoke.py imports Pillow, cv2
    or imageio, anywhere in its code: the GPU machine has none of them, so
    the port decodes and resizes images itself (utils/jpeg, png, resize,
    cvimg). Importing every module leaves none of them loaded."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, fs in os.walk(os.path.join(REPO, "pointnerf_tpu_torch")):
        files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    bad = {os.path.relpath(f, REPO): sorted(_imported_modules(f).intersection(
        _IMAGE_LIBS)) for f in files}
    assert len(files) > 40
    assert not {k: v for k, v in bad.items() if v}
    probe = _PROBE.replace('("jax", "jaxlib", "optax", "pointnerf_tpu")',
                           repr(_IMAGE_LIBS))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    proc = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("module,entry_points", [
    ("pointnerf_tpu_torch.models.mvs.probnet", ()),
    ("pointnerf_tpu_torch.run.editing", ("main", "compose_parts")),
    ("pointnerf_tpu_torch.run.visualize", ("splat_render", "render_turntable",
                                           "render_grow")),
])
def test_probnet_editing_visualize_import_alone(module, entry_points):
    """The ProbNet init, the editing driver and the viewer import on their
    own without JAX or the JAX package (nor an image library), and their
    entry points run on the card unless the caller names another device."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    probe = (f"import sys, {module}\n"
             "bad = [n for n in sys.modules if n.split('.')[0] in "
             f"('jax', 'jaxlib', 'pointnerf_tpu') + {_IMAGE_LIBS!r}]\n"
             "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    import importlib
    mod = importlib.import_module(module)
    for name in entry_points:
        fn = getattr(mod, name)
        assert inspect.signature(fn).parameters["device"].default == "cuda"
