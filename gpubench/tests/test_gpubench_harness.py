"""The harness at sizes the CPU holds: what it loads, how it finds a
cell's files by name, the faults and the control it must call not
correct, and its refusal to run without a card."""

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


def test_reference_loads_nothing_of_the_program():
    names = _top_names("import gpubench.reference.model, "
                       "gpubench.reference.train, gpubench.reference.tf32, "
                       "gpubench.check, gpubench.inputs")
    assert not names & set(FORBIDDEN + ("pointnerf_tpu_torch",)), names


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


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix, limits and a per-layer metric
    dropped into a copy of the benchmark are found by their names, with
    BENCHMARK.json the only file changed."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path / "gpubench")
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
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
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
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digest(g)
    assert all(after[p] == h for p, h in before.items())

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


@pytest.mark.parametrize("workload,fault", [
    ("lego.train", None), ("lego.train", "frozen"), ("lego.train", "half"),
    ("lego.train", "loss"), ("lego.train", "stale"), ("lego.train", "points"),
    ("lego.render", None), ("lego.render", "pixels"),
    ("lego.render", "half")])
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
