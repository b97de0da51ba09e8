"""The harness at sizes the CPU holds: what it loads, how it finds a
cell's files by name, the faults and the control it must call not
correct, and its refusal to run without a card."""

import ast
import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from gpubench import run
from gpubench.tests.conftest import tiny

ROOT = Path(run.__file__).resolve().parent.parent
SEED = 2 ** 31 + 23
FORBIDDEN = ("jax", "jaxlib", "flax", "pointnerf_tpu")

_LOADS = """
import json, sys
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _top_names(body: str):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    proc = subprocess.run([sys.executable, "-c", _LOADS.format(body=body)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def _imported_tops(path: Path):
    """Top-level names of the modules a source file imports."""
    tree = ast.parse(path.read_text())
    return {n.name.split(".")[0] for node in ast.walk(tree)
            if isinstance(node, ast.Import) for n in node.names} | \
        {node.module.split(".")[0] for node in ast.walk(tree)
         if isinstance(node, ast.ImportFrom) and node.module}


def test_reference_loads_nothing_of_the_program():
    """Every module under gpubench/reference/ and gpubench/mixes/, loaded
    as the harness loads it, loads neither the program nor JAX; and of
    the harness's sources only system*.py and the trace record's reader
    import the program."""
    g = ROOT / "gpubench"
    refs = sorted(p.stem for p in (g / "reference").glob("*.py"))
    mixes = sorted(p.stem for p in (g / "mixes").glob("*.py"))
    assert {"model", "train"} <= set(refs) and {"train", "render"} <= \
        set(mixes)
    names = _top_names(
        "import gpubench.check, gpubench.inputs, gpubench.mix\n"
        + "".join(f"import gpubench.reference.{r}\n" for r in refs)
        + "from gpubench import run\n"
        + "".join(f"run.load_mix(run.HERE / 'mixes', {m!r})\n"
                  for m in mixes))
    assert not names & set(FORBIDDEN + ("pointnerf_tpu_torch",)), names
    for p in sorted(g.rglob("*.py")):
        if "tests" in p.relative_to(g).parts:
            continue
        tops = _imported_tops(p)
        assert not tops & set(FORBIDDEN), (p, tops)
        if "pointnerf_tpu_torch" in tops:
            assert p.parent == g and (p.name.startswith("system")
                                      or p.name == "record.py"), p


def test_a_run_loads_no_jax():
    """Whole top-level names after a traced train run and a render run:
    the port, and neither JAX nor the JAX package."""
    body = ("from gpubench.tests.conftest import tiny\n"
            "from gpubench import run\n"
            "for w, t in (('lego.train', True), ('lego.render', False)):\n"
            "    run.run_cell(tiny(w), 5, 0.5, t, 'cpu')\n")
    names = _top_names(body)
    assert "pointnerf_tpu_torch" in names
    assert not names & set(FORBIDDEN), names


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "pointnerf_tpu_torch_fake", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "pointnerf_tpu.fake", sys)
    assert run.forbidden_modules() == ["pointnerf_tpu.fake"]


def _digest(root: Path):
    return {p: hashlib.sha1(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def _copy_bench(tmp_path: Path):
    """A copy of BENCHMARK.json and gpubench/, its files' digests, and
    BENCHMARK.json read."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return (_digest(tmp_path),
            json.loads((tmp_path / "BENCHMARK.json").read_text()))


def _only_benchmark_changed(tmp_path: Path, before, bench):
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digest(tmp_path)
    changed = {p for p, h in before.items() if after[p] != h}
    assert changed == {tmp_path / "BENCHMARK.json"}, changed


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix, limits and a per-layer metric
    dropped into a copy of the benchmark are found by their names, with
    BENCHMARK.json the only file changed."""
    before, bench = _copy_bench(tmp_path)
    g = tmp_path / "gpubench"
    cfg = json.loads((g / "configs" / "lego.json").read_text())
    cfg["name"] = "mini"
    cfg["cloud"]["points"] = 2500
    (g / "configs" / "mini.json").write_text(json.dumps(cfg))
    traffic = json.loads((g / "traffic" / "train.json").read_text())
    traffic.update(steps_per_dispatch=3, pool_dispatches=2)
    (g / "traffic" / "short_train.json").write_text(json.dumps(traffic))
    (g / "limits" / "mini.short_train.json").write_text(
        (g / "limits" / "lego.train.json").read_text())
    (g / "metrics" / "window_units.train.py").write_text(
        "def read(ctx):\n    return float(ctx['window_units'])\n")
    bench["configs"].append({"name": "mini", "source": "x",
                             "file": "gpubench/configs/mini.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "mini.short_train", "config": "mini",
                               "traffic": "short_train", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "window_units.train", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "whole step",
                               "moves": "train_rays_per_s",
                               "workloads": ["mini.short_train"]})
    bench["end_to_end"][0]["workloads"].append("mini.short_train")
    _only_benchmark_changed(tmp_path, before, bench)

    spec = run.load_cell("mini.short_train", root=tmp_path)
    assert spec["cfg"]["name"] == "mini"
    assert spec["traffic"]["pool_dispatches"] == 2
    assert [m["name"] for m in spec["per_layer"]] == ["window_units.train"]
    assert [m["name"] for m in spec["end_to_end"]] == ["train_rays_per_s",
                                                       "setup_s"]
    spec["cfg"]["options"].update(random_sample_size=16, max_o=4000)
    spec["cfg"]["cameras"].update(wh=[48, 40], focal=70.0)
    out = run.run_cell(spec, SEED, 0.5, True, "cpu")
    assert out["metrics"]["window_units.train"]["value"] >= 3


REV_MIX = """\"\"\"The render mix over its path in reverse order.\"\"\"
from pathlib import Path

from gpubench import run
from gpubench.reference import reverse

base = run.load_mix(Path(__file__).parent, "render")
FAULTS, UNIT = base.FAULTS, base.UNIT
check, control, per_entry, model = (base.check, base.control,
                                    base.per_entry, base.model)


class RenderRev(base.Render):
    def __init__(self, spec, seed, card, fault):
        super().__init__(spec, seed, card, fault)
        self.path = reverse.order(self.path)
        self.items = reverse.order(self.items)
        self.reversed = True


MIX = RenderRev
"""

REV_RUN = """
import json
from pathlib import Path
from gpubench import inputs, run
assert Path(run.__file__).resolve().parent.parent == Path.cwd().resolve()
spec = run.load_cell("mini.rev", root=Path.cwd())
mod = run.load_mix(spec["mixes"], spec["traffic"]["kind"])
mix = mod.MIX(spec, 7, run.Card("cpu"), None)
out = {"reversed": mix.reversed, "views": [p["view"] for p in mix.path],
       "path": [p["view"] for p in inputs.render_path(
           spec["cfg"], spec["traffic"], 7, "cpu")]}
for fault, trace in ((None, True), ("pixels", False)):
    r = run.run_cell(spec, %d, 0.5, trace, "cpu", fault=fault)
    out[str(fault)] = {"correct": r["correct"], "metrics": r["metrics"],
                       "checks": r["checks"]}
print(json.dumps(out))
"""


def test_new_kind_is_found_by_name(tmp_path):
    """A mix of a new kind, the reference module it imports, its traffic,
    a configuration, limits and a metric, dropped into a copy of the
    benchmark, make a cell found by name that runs correct, and one of
    whose faults does not; BENCHMARK.json is the only file changed."""
    before, bench = _copy_bench(tmp_path)
    g = tmp_path / "gpubench"
    (g / "mixes" / "render_rev.py").write_text(REV_MIX)
    (g / "reference" / "reverse.py").write_text(
        '"""A sequence in reverse order."""\n\n\n'
        "def order(seq):\n    return list(seq)[::-1]\n")
    cfg = json.loads((g / "configs" / "lego.json").read_text())
    cfg["name"] = "mini"
    cfg["cloud"]["points"] = 2500
    cfg["options"].update(max_o=4000)
    cfg["cameras"].update(wh=[48, 40], focal=70.0)
    (g / "configs" / "mini.json").write_text(json.dumps(cfg))
    traffic = json.loads((g / "traffic" / "render.json").read_text())
    traffic.update(kind="render_rev", views=3, group=2)
    (g / "traffic" / "render_rev.json").write_text(json.dumps(traffic))
    (g / "limits" / "mini.rev.json").write_text(
        (g / "limits" / "lego.render.json").read_text())
    (g / "metrics" / "window_images.render_rev.py").write_text(
        "def read(ctx):\n"
        "    return float(ctx['window_units']) "
        "if ctx['kind'] == 'render_rev' else None\n")
    bench["configs"].append({"name": "mini", "source": "x",
                             "file": "gpubench/configs/mini.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "mini.rev", "config": "mini",
                               "traffic": "render_rev", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "window_images.render_rev",
                               "unit": "images", "better": "higher",
                               "source": "host_clock", "layer": "whole step",
                               "moves": "render_rays_per_s",
                               "workloads": ["mini.rev"]})
    bench["end_to_end"][1]["workloads"].append("mini.rev")
    _only_benchmark_changed(tmp_path, before, bench)

    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = str(ROOT)       # the program; gpubench is the copy's
    proc = subprocess.run([sys.executable, "-c", REV_RUN % SEED],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["reversed"] and out["views"] == out["path"][::-1], out
    assert out["None"]["correct"], out["None"]["checks"]
    assert out["None"]["metrics"]["window_images.render_rev"]["value"] >= 1
    assert not out["pixels"]["correct"], out["pixels"]["checks"]


@pytest.mark.parametrize("workload,fault", [
    ("lego.train", None), ("lego.train", "frozen"), ("lego.train", "half"),
    ("lego.train", "loss"), ("lego.train", "stale"), ("lego.train", "points"),
    ("truck.train", None), ("truck.train", "frozen"), ("truck.train", "half"),
    ("truck.train", "loss"), ("truck.train", "stale"),
    ("truck.train", "points"), ("lego.render", None),
    ("lego.render", "pixels"), ("lego.render", "half")])
def test_faults_are_not_correct(workload, fault):
    out = run.run_cell(tiny(workload, 20000, 120.0), SEED, 0.5, False,
                       "cpu", fault=fault)
    assert out["correct"] == (fault is None), out["checks"]
    assert list(out)[-1] == "checks"
    if fault in ("stale", "points"):
        # held by the number that only the steps after the first, or only
        # the point leaves, reach
        c = out["checks"]["loss_gap" if fault == "stale" else "point_gap"]
        assert c["value"] > c["limit"], out["checks"]


@pytest.mark.parametrize("workload", ["lego.train", "truck.train",
                                      "lego.render"])
def test_control_is_not_correct(workload):
    """The reference with TF32 products in the program's place fails one
    of the cell's numbers."""
    out = run.run_cell(tiny(workload, 20000, 120.0), SEED, 0.5, False,
                       "cpu", control=True)
    assert not out["correct"], out["checks"]


def test_no_card_no_result(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "lego.train", "--seed", str(SEED),
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["lego.train", "truck.train",
                                      "lego.render"])
def test_cell_on_the_card(card, workload):
    """One short run of each cell at its own size: correct, with its
    end-to-end metrics."""
    spec = run.load_cell(workload)
    out = run.run_cell(spec, SEED, 3.0, False, card)
    assert out["correct"], out["checks"]
    assert {m["name"] for m in spec["end_to_end"]} == set(out["metrics"])
