"""The plain reference against the port's own plain path on the CPU, at
sizes the CPU holds: the grid's tables, the row count, the first train
steps (losses, first gradients, the state after them; with and without
rows past the budgets) and whole images (with and without the budget
ladder)."""

import numpy as np
import pytest
import torch

from gpubench import inputs, run, system
from gpubench.mix import ones
from gpubench.reference import grid as rgrid, model

SEED = 2 ** 31 + 11


def _both_grids(spec):
    cfg = spec["cfg"]
    cloud = inputs.cloud(cfg, SEED, "cpu")
    opt = system.options(cfg)
    state = system.point_state(cloud)
    gspec, g = system.grid(opt, state)
    rspec = rgrid.make_spec(cfg["options"], cloud["xyz"])
    rg = rgrid.build(cloud["xyz"], ones(cloud), rspec)
    return cloud, opt, state, gspec, g, rspec, rg


@pytest.mark.parametrize("workload", ["lego.train", "truck.train"])
def test_grid_tables_equal_the_programs(tiny_spec, workload):
    *_, gspec, g, rspec, rg = _both_grids(tiny_spec(workload, 20000))
    assert tuple(gspec.vdim) == rspec.vdim
    assert int(g["num_occ"]) == int(rg["num_occ"])
    vol = rspec.vol
    assert torch.equal(g["coor_occ_rows"].reshape(-1)[:vol], rg["coor_occ"])
    assert torch.equal(g["coor_slot"], rg["coor_slot"])
    assert torch.equal(g["super_xyz"], rg["super_xyz"])


def _first_step(spec):
    """Step 0 of the pool's first dispatch, and its draws [1,R,D]."""
    d = inputs.train_pool(spec["cfg"], spec["traffic"], SEED, "cpu")[0]
    o = spec["cfg"]["options"]
    u = inputs.draws(d, torch.empty((spec["traffic"]["steps_per_dispatch"],
                                     1, o["random_sample_size"] ** 2,
                                     o["z_depth_dim"])))
    return inputs.step_of(d, 0), u[0]


@pytest.mark.parametrize("train", [False, True])
def test_row_count_equals_the_programs_query(tiny_spec, train):
    from pointnerf_tpu_torch.models.renderer import render_query
    spec = tiny_spec("lego.train", 20000)
    cloud, opt, state, gspec, g, rspec, rg = _both_grids(spec)
    o = spec["cfg"]["options"]
    b, u = _first_step(spec)
    u = u if train else None
    batch = {"raydir": b["raydir"][None], "campos": b["campos"][None],
             "camrotc2w": b["camrotc2w"][None], "near": b["near"],
             "far": b["far"]}
    q = render_query(state, g, gspec, opt, batch, is_train=train, u=u,
                     prob=True)
    n = (q.sample_pidx >= 0).sum(dim=-1)
    got = model.count_rows(o, rg, rspec, b["campos"], b["raydir"],
                           None if u is None else u[0], b["near"], b["far"])
    assert got["needed"] == (int(n.sum()), int((n > 0).sum()))
    assert got["needed"][0] > 0


@pytest.mark.parametrize("budget,drops", [(-1, False), (256, True)])
def test_shaded_rows_keep_to_the_budgets(tiny_spec, budget, drops):
    """A train batch's shaded rows are those its budgets keep: all the
    needed rows where the budget holds them, fewer where it drops some,
    and never more shading rows than the budget."""
    spec = tiny_spec("lego.train", 20000)
    spec["cfg"]["options"]["SR_budget"] = budget
    *_, rspec, rg = _both_grids(spec)
    o = spec["cfg"]["options"]
    b, u = _first_step(spec)
    got = model.count_rows(o, rg, rspec, b["campos"], b["raydir"], u[0],
                           b["near"], b["far"])
    assert (got["shaded"] != got["needed"]) == drops, got
    assert got["shaded"][0] > 0
    assert got["shaded"][1] <= model.row_budget(o, 16 ** 2 * o["SR"])


@pytest.mark.parametrize("workload,points,overflows", [
    ("lego.train", 3000, False), ("lego.train", 60000, True),
    ("truck.train", 60000, True)])
def test_first_steps_match_the_program(tiny_spec, workload, points,
                                       overflows):
    spec = tiny_spec(workload, points, focal=120.0,
                     fill=0.5 if overflows else None)
    mix = run.load_mix(spec["mixes"], "train").Train(spec, SEED,
                                                     run.Card("cpu"), None)
    over = mix.call(mix.pool[1])["sr_overflow"]
    assert (over.sum() > 0) == overflows
    n = mix.reference()
    assert len(mix.losses) == 1 + 2 * mix.S
    assert n["loss_gap"] < 1e-6, n
    assert n["grad_gap"] < 1e-4, n
    assert n["step_gap"] < 1e-3, n
    assert n["point_gap"] < 1e-3, n
    assert n["point_grad_gap"] < 1e-6, n


@pytest.mark.parametrize("points,ladder", [(3000, False), (60000, True)])
def test_images_match_the_program(tiny_spec, points, ladder):
    spec = tiny_spec("lego.render", points, focal=120.0,
                     fill=0.5 if ladder else None)
    mix = run.load_mix(spec["mixes"], "render").Render(spec, SEED,
                                                       run.Card("cpu"), None)
    for _ in range(2):
        mix.unit()
    assert (sum(mix.ladder) > 0) == ladder
    n = mix.reference(sample=[(0, 0), (1, 1)])
    assert n["pixel_gap"] < 1e-5, n


def test_widths_are_the_programs(tiny_spec):
    """The reference's layer bookkeeping gives the port's aggregator its
    own parameter names and shapes, and lego's 271,360 trunk
    multiply-adds a row (PERF.md §6)."""
    from pointnerf_tpu_torch.models.aggregator import init_aggregator_params
    for workload in ("lego.train", "truck.train"):
        spec = run.load_cell(workload)
        o = spec["cfg"]["options"]
        agg = init_aggregator_params(system.options(spec["cfg"]),
                                     generator=torch.Generator(),
                                     device="cpu")
        assert {k: tuple(v.shape) for k, v in agg.named_parameters()} \
            == model.weight_shapes(o)
    assert model.trunk_macs(run.load_cell("lego.train")["cfg"]["options"]) \
        == 271360


def test_inputs_repeat_from_the_seed(tiny_spec):
    spec = tiny_spec("lego.train")
    a = inputs.cloud(spec["cfg"], SEED, "cpu")
    b = inputs.cloud(spec["cfg"], SEED, "cpu")
    c = inputs.cloud(spec["cfg"], SEED + 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["xyz"], c["xyz"])
    w1 = inputs.weights(spec["cfg"], SEED, "cpu")
    w2 = inputs.weights(spec["cfg"], SEED, "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert np.isfinite(sum(float(v.abs().sum()) for v in w1.values()))
