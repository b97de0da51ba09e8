"""Shared fixtures of the benchmark's tests: a cell cut to a size the CPU
holds (the same code, the configuration's widths, far fewer points, rays
and pixels), and whether a card is present, decided when a test asks."""

import copy

import pytest

from gpubench import run


def tiny(workload: str, points: int = 3000, focal: float = 70.0,
         fill: float = None):
    """The cell at a CPU's size; `fill` in place of the configuration's
    share of points uniform in the ranges (half fills the volume, so that
    train steps overflow their budgets)."""
    spec = copy.deepcopy(run.load_cell(workload))
    cfg, o = spec["cfg"], spec["cfg"]["options"]
    cfg["cloud"]["points"] = points
    if fill is not None:
        cfg["cloud"]["fill"] = fill
    if o["SR_budget"] > 0:          # an explicit budget, to the row space
        share = o["SR_budget"] * 16 ** 2 / o["random_sample_size"] ** 2
        o["SR_budget"] = max(128, -(-int(share) // 128) * 128)
    o["random_sample_size"] = 16
    o["max_o"] = max(4000, points)
    cfg["cameras"]["wh"] = [48, 40]
    cfg["cameras"]["focal"] = focal
    t = spec["traffic"]
    if t["kind"] == "train":
        t.update(steps_per_dispatch=3, pool_dispatches=3, trace_units=1)
    else:
        t.update(views=3, group=2)
    return spec


@pytest.fixture
def tiny_spec():
    return tiny


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda:0"
