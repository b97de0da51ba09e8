"""The multi-step dispatch against the JAX package's, on the CPU.

* `trainer.train_steps_scan` (S = 3; on the CPU the steps run in turn)
  against JAX's lax.scan (`pointnerf_tpu/train/trainer.py::
  train_steps_scan`) from the same state, grid and stacked batches, with
  JAX's draws of each step, uniform(fold_in(key, step)) (per ray chunk
  fold_in(fold_in(key, step), i)), injected; and against S `train_step`
  calls of the port from a twin state, which it must equal exactly.
* The finetune driver at steps_per_dispatch 4 against JAX's `train_ft.
  main`: the same dispatch lengths around print and save boundaries, the
  same "SR_budget overflow at N ... budget a -> b" lines (once a dispatch,
  on its largest overflow), the phase timer on each loss line, each
  step's own near and far where frames differ in them (the `near_far`
  case holds the dispatch itself to JAX's for such steps), and
  --profile_dir writing a torch.profiler trace. The depths a captured
  step reads in place of near and far give the same samples bit for bit.
* `MeshRunner.train_steps_scan` on two gloo ranks (mesh_points 1 and 2)
  against the one-device `train_steps_scan` at the comp_groups the runner
  sets.

Tolerances: each step's loss items rtol 1e-5 (atol 1e-7), sr_overflow
exactly; after the S steps the weights and point buffers rtol 1e-4, atol
1e-5, and both Adam chains' moments within a thousandth of each buffer's
largest (test_torch_port_train.py's bars for its three train steps), five
times that under ray_chunk (WIDER says why). Sharded against one device:
items rtol 2e-5, atol 2e-6 and the buffers at STEP_TOL
(test_torch_port_parallel.py's).
"""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnerf_tpu.run import train_ft as jdriver
from pointnerf_tpu.train import trainer as jtr
from pointnerf_tpu_torch.config import Options
from pointnerf_tpu_torch.parallel import checks, driver
from pointnerf_tpu_torch.run import train_ft as tdriver
from pointnerf_tpu_torch.train import trainer as ttr
from pointnerf_tpu_torch.utils.checkpoint import (_net_tensors,
                                                  from_jax_train_state,
                                                  train_state_arrays)
from pointnerf_tpu_torch.utils.profiling import TRACE_FILE, PhaseTimer

from fixtures import make_nerf_synth_scene
from test_torch_port_frustum import _port_opt
from test_torch_port_parallel import _np_batch, _scene_of
from test_torch_port_parallel import _port_opt as _runner_opt
from test_torch_port_parallel_query import _frustum_train_scene
from test_torch_port_train import (STEP_TOL, _np_tree, _port, _scene,
                                   _uniform)
from test_train_ft_driver import tiny_train_opt

S = 3
KEY = jax.random.PRNGKey(11)
ITEM_TOL = dict(rtol=1e-5, atol=1e-7)
RANK_TOL = dict(rtol=2e-5, atol=2e-6)
CHUNK = 16


def _jax_batches(batch, near_far=None):
    """The batch repeated over S steps, every leaf stacked [S, ...] (the
    JAX driver stacks near and far too); near_far: each step's near and
    far instead of the batch's."""
    out = {k: jnp.stack([jnp.asarray(v)] * S) for k, v in batch.items()}
    if near_far is not None:
        out.update(near=jnp.asarray(near_far[0], jnp.float32),
                   far=jnp.asarray(near_far[1], jnp.float32))
    return out


def _port_batches(tb, near_far=None):
    """The port's stacked batches; near_far as lists of S floats, as the
    driver passes each step's."""
    out = {k: (torch.stack([v] * S) if torch.is_tensor(v) else v)
           for k, v in tb.items()}
    if near_far is not None:
        out.update(near=list(near_far[0]), far=list(near_far[1]))
    return out


def _world_draws(opt, B, R, step0=0):
    """JAX's draws of steps step0.. [S, B, R, z_depth_dim]; under
    ray_chunk each chunk i draws from fold_in(step key, i)."""
    out = []
    for s in range(S):
        key = jax.random.fold_in(KEY, step0 + s)
        if opt.ray_chunk:
            out.append(np.concatenate(
                [_uniform(jax.random.fold_in(key, i), B, opt.ray_chunk,
                          opt.z_depth_dim)
                 for i in range(R // opt.ray_chunk)], axis=1))
        else:
            out.append(_uniform(key, B, R, opt.z_depth_dim))
    return torch.tensor(np.stack(out))


def _world_case(**kw):
    opt, ts, spec, grid, batch = _scene(**kw)
    st, spec_t, grid_t, tb = _port(opt, ts, batch)
    B, R = batch["raydir"].shape[:2]
    return (opt, ts, spec, grid, batch), (opt, st, spec_t, grid_t, tb), \
        _world_draws(opt, B, R), lambda: _port(opt, ts, batch)[0]


def _frustum_case():
    opt, ts, spec_j, jb, st, spec_t, tb = _frustum_train_scene()
    R = jb["raydir"].shape[1]
    u = torch.tensor(np.stack([np.asarray(jax.random.uniform(
        jax.random.fold_in(KEY, s), (1, R, opt.SR))) for s in range(S)]))
    return (opt, ts, spec_j, None, jb), (_port_opt(opt), st, spec_t, None,
                                         tb), u, \
        lambda: from_jax_train_state(_np_tree(ts), opt, device="cpu")


CASES = {
    "tiny": lambda: _world_case(),
    # the chains switch at every step inside the dispatch
    "alter_step": lambda: _world_case(alter_step=1),
    # the lr drops tenfold at count 2, inside the dispatch
    "lr_step": lambda: _world_case(lr_policy="step", lr_decay_iters=2),
    # four 16-ray chunks of the 64 rays, each at the auto budget
    "ray_chunk": lambda: _world_case(ray_chunk=CHUNK),
    "frustum": _frustum_case,
    "near_far": lambda: _world_case(),
}
# each step's own near and far, as a dataset with a depth range per view
# (dtu_ft) gives them within one dispatch
NEAR_FAR = {"near_far": ([2.0, 2.125, 1.9375], [4.5, 4.25, 4.75])}
# the state bars five times as wide under ray_chunk: its first step equals
# JAX's to the last digits (gradients within 4e-7 of their largest), but a
# few of its weights take gradients that change sign within the three
# steps, where Adam's step turns those digits into differences of up to
# 4.5e-5 (a point embedding, 0.3% of it) and 0.15% of the color buffer's
# largest moment
WIDER = {"ray_chunk": 5}


def _close_state(st, ts, opt, wider=1):
    """The state after S steps against JAX's at STEP_TOL and moments
    within a thousandth of each buffer's largest, both `wider` times."""
    tol = {k: wider * v for k, v in STEP_TOL.items()}
    jstate = _np_tree(ts)
    assert st.step == int(ts.step) == S
    for k, v in _net_tensors(jstate.agg_params).items():
        np.testing.assert_allclose(
            dict(st.aggregator.named_parameters())[k].detach().numpy(), v,
            err_msg=k, **tol)
    for k, v in jstate.pt_train.items():
        np.testing.assert_allclose(st.pt_train[k].detach().numpy(), v,
                                   err_msg=k, **tol)
    again = from_jax_train_state(jstate, opt, device="cpu")
    for mine, theirs in ((st.opt_pts, again.opt_pts),
                         (st.opt_net, again.opt_net)):
        assert mine.count == theirs.count == S
        for p, q in zip(mine.param_groups[0]["params"],
                        theirs.param_groups[0]["params"]):
            for name in ("exp_avg", "exp_avg_sq"):
                want = theirs.state[q][name].numpy()
                np.testing.assert_allclose(
                    mine.state[p][name].numpy(), want, rtol=0,
                    atol=wider * 1e-3 * np.abs(want).max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_steps_scan_matches_jax(case):
    """S steps in one dispatch: each step's items equal JAX's scan's, the
    state after them JAX's, and the S items and the state equal S
    train_step calls of the port exactly."""
    (jopt, ts, jspec, jgrid, jbatch), (opt, st, spec, grid, tb), u, twin = \
        CASES[case]()
    nf = NEAR_FAR.get(case)
    ts_after, want = jtr.train_steps_scan(ts, jgrid, _jax_batches(jbatch, nf),
                                          KEY, jopt, jspec)
    batches = _port_batches(tb, nf)
    st, got = ttr.train_steps_scan(st, grid, batches, opt, spec, u=u)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == (S,) and got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v),
                                   err_msg=k, **ITEM_TOL)
    np.testing.assert_array_equal(got["sr_overflow"].numpy(),
                                  np.asarray(want["sr_overflow"]))
    _close_state(st, ts_after, jopt, WIDER.get(case, 1))

    ref = twin()
    for s in range(S):
        ref, items = ttr.train_step(ref, grid, ttr.stacked_step(batches, s),
                                    opt, spec, u=u[s])
        for k, v in items.items():
            assert float(got[k][s]) == float(v), (k, s)
    for p, q in zip(st.aggregator.parameters(), ref.aggregator.parameters()):
        assert torch.equal(p, q)
    for k, v in ref.pt_train.items():
        assert torch.equal(st.pt_train[k], v), k


def test_train_steps_scan_draws_each_step_in_turn():
    """Without draws the dispatch takes each step's from state.generator
    in step order, as S train_step calls do."""
    (_, ts, _, _, batch), (opt, st, spec, grid, tb), _, twin = _world_case()
    st.generator.manual_seed(3)
    ref = twin()
    ref.generator.manual_seed(3)
    st, got = ttr.train_steps_scan(st, grid, _port_batches(tb), opt, spec)
    for s in range(S):
        ref, items = ttr.train_step(ref, grid, tb, opt, spec)
        for k, v in items.items():
            assert float(got[k][s]) == float(v), (k, s)
    assert torch.equal(st.generator.get_state(), ref.generator.get_state())


def test_phase_timer_is_jax_s():
    """The copied PhaseTimer: phases summed and counted by name, JAX's
    summary text, reset."""
    from pointnerf_tpu.utils.profiling import PhaseTimer as JPhaseTimer
    mine, theirs = PhaseTimer(), JPhaseTimer()
    for t in (mine, theirs):
        for name in ("host_data", "device_step", "host_data"):
            with t.phase(name):
                pass
        t.totals["host_data"] = 1.25
        t.totals["device_step"] = 0.5
    assert mine.summary() == theirs.summary() == \
        "phases[device_step: 0.50s/1, host_data: 1.25s/2]"
    mine.reset()
    assert mine.summary() == "phases[]"


# ------------------------------------------------------------ the driver
@pytest.fixture(scope="module")
def scene_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scene"))
    make_nerf_synth_scene(root, wh=(40, 40))
    return root


# 24 steps, 4 a dispatch, clamped before the print (10) and save (14)
# boundaries: dispatches 4, 4, 1, 1, 4, 4, 1, 1, 4. A 128-row budget of the
# 6,912-row batches overflows (the compaction's and the wide K tier's
# quarter of it), and rises 1.5x a dispatch while a dispatch overflows: at
# 4, 8, 9, 10 and 14.
DRIVER = dict(maximum_step=24, steps_per_dispatch=4, SR_budget=128,
              random_sample_size=24,
              print_freq=10, save_iter_freq=14, save_point_freq=0,
              prune_iter=-1, prob_freq=0, test_freq=0, test_num=1)
CHUNKS = [4, 4, 1, 1, 4, 4, 1, 1, 4]
RAISE = re.compile(r"SR_budget overflow at (\d+) \(\d+ rows dropped\): "
                   r"budget (\d+) -> (\d+)")


def _log(out):
    with open(os.path.join(out, "plate_e2e", "log.txt")) as f:
        return f.read().splitlines()


def _phase_names(lines):
    return [sorted(p.split(":")[0] for p in
                   re.search(r"phases\[(.*)\]", ln).group(1).split(", "))
            for ln in lines if ln.startswith("step:")]


@pytest.fixture(scope="module")
def drivers(scene_root, tmp_path_factory):
    """Both drivers on the fixture scene with DRIVER's options; JAX's
    dispatch lengths recorded at its trainer calls."""
    out = str(tmp_path_factory.mktemp("drivers"))
    jout, tout = os.path.join(out, "jax"), os.path.join(out, "port")
    lengths = []
    step, scan = jtr.train_step, jtr.train_steps_scan

    def one(*a, **k):
        lengths.append(1)
        return step(*a, **k)

    def many(ts, grid, batches, *a, **k):
        lengths.append(int(batches["raydir"].shape[0]))
        return scan(ts, grid, batches, *a, **k)
    jtr.train_step, jtr.train_steps_scan = one, many
    try:
        jdriver.main(tiny_train_opt(scene_root, jout, **DRIVER))
    finally:
        jtr.train_step, jtr.train_steps_scan = step, scan
    opt = Options.from_json(tiny_train_opt(scene_root, tout,
                                           **DRIVER).to_json())
    res = tdriver.main(opt, device="cpu")
    return lengths, _log(jout), res, _log(tout)


def test_driver_dispatches_like_jax(drivers):
    """The same dispatch lengths: steps_per_dispatch, one step before a
    print or save boundary."""
    lengths, _, res, _ = drivers
    assert lengths == CHUNKS
    assert res["timing"]["chunks"] == CHUNKS
    assert res["total_steps"] == res["timing"]["steps"] == 24


def test_driver_raises_the_budget_like_jax(drivers):
    """One budget raise a dispatch, on its largest overflow: the lines
    name the same steps and budgets in both drivers (the port raised it
    after every step before)."""
    _, jlog, _, tlog = drivers
    want = [m.groups() for m in map(RAISE.search, jlog) if m]
    got = [m.groups() for m in map(RAISE.search, tlog) if m]
    assert len(want) >= 3 and want[:3] == [
        ("4", "128", "256"), ("8", "256", "384"), ("9", "384", "640")]
    assert got == want


def test_driver_prints_the_phase_timer(drivers):
    """Every loss line carries phases[...] with JAX's phase names."""
    _, jlog, _, tlog = drivers
    names = _phase_names(tlog)
    assert len(names) == 2 and names == _phase_names(jlog)
    assert names[0] == ["device_step", "host_data"]


def test_profile_dir_writes_a_trace(scene_root, tmp_path):
    """--profile_dir writes a torch.profiler trace of the loop (it
    raised NotImplementedError)."""
    prof = os.path.join(tmp_path, "prof")
    opt = Options.from_json(tiny_train_opt(
        scene_root, str(tmp_path), maximum_step=3, steps_per_dispatch=2,
        prune_iter=-1, prob_freq=0, test_freq=0, test_num=1,
        profile_dir=prof).to_json())
    res = tdriver.main(opt, device="cpu")
    assert res["timing"]["chunks"] == [2, 1]
    with open(os.path.join(prof, TRACE_FILE)) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("aten::" in n for n in names)


# a depth range per view (dtu_ft reads each view's cam file): the fixture
# scene's near and far moved by the frame, in both packages' dataset
NEAR_SHIFT = 0.0625


def _near_far_by_frame(monkeypatch, cls):
    get = cls.get_item

    def get_item(self, idx, *a, **k):
        item = get(self, idx, *a, **k)
        item["near"] = np.float32(item["near"] + NEAR_SHIFT * (idx % 3))
        item["far"] = np.float32(item["far"] - NEAR_SHIFT * (idx % 2))
        return item
    monkeypatch.setattr(cls, "get_item", get_item)


def test_driver_takes_each_steps_near_far(scene_root, tmp_path,
                                          monkeypatch):
    """Frames whose near and far differ share a dispatch: both drivers
    run the same dispatch lengths, and every step of the port's renders
    with its own frame's near and far, the ones JAX's scan took for it
    (the port raised on such a dispatch before)."""
    import pointnerf_tpu.data.nerf_synth360_ft as jds
    import pointnerf_tpu_torch.data.nerf_synth360_ft as tds
    for mod in (jds, tds):
        _near_far_by_frame(monkeypatch, mod.NerfSynth360FtDataset)
    kw = dict(maximum_step=8, steps_per_dispatch=4, print_freq=8,
              save_iter_freq=8, save_point_freq=0, prune_iter=-1,
              prob_freq=0, test_freq=0, test_num=1)
    jsteps, tsteps = [], []
    scan, step = jtr.train_steps_scan, ttr.train_step

    def jscan(ts, grid, batches, *a, **k):
        jsteps.append(list(zip(np.asarray(batches["near"]).tolist(),
                               np.asarray(batches["far"]).tolist())))
        return scan(ts, grid, batches, *a, **k)

    def tstep(st, grid, batch, *a, **k):
        tsteps.append((float(batch["near"]), float(batch["far"])))
        return step(st, grid, batch, *a, **k)
    monkeypatch.setattr(jtr, "train_steps_scan", jscan)
    monkeypatch.setattr(ttr, "train_step", tstep)
    jdriver.main(tiny_train_opt(scene_root, str(tmp_path / "jax"), **kw))
    res = tdriver.main(Options.from_json(tiny_train_opt(
        scene_root, str(tmp_path / "port"), **kw).to_json()), device="cpu")
    assert [len(c) for c in jsteps] == res["timing"]["chunks"] == [4, 4]
    assert tsteps == [nf for c in jsteps for nf in c]
    assert any(len(set(c)) > 1 for c in jsteps)


@pytest.mark.parametrize("inverse", [0, 1])
def test_ray_depths_stand_for_near_far(inverse):
    """A batch's `depths` (a captured step's input) give the world
    query's depth samples bit for bit as its near and far do, linear and
    in disparity, jittered as at train."""
    from pointnerf_tpu_torch.models.renderer import ray_depths
    from pointnerf_tpu_torch.ops import raygen
    rng = np.random.RandomState(4)
    campos = torch.tensor(rng.normal(size=(1, 3)).astype(np.float32))
    raydir = torch.tensor(rng.normal(size=(1, 16, 3)).astype(np.float32))
    u = torch.tensor(rng.uniform(size=(1, 16, 40)).astype(np.float32))
    name = ("near_far_disparity_linear" if inverse else "near_far_linear")
    gen = raygen.find_ray_generation_method(name)
    opt = Options(z_depth_dim=40, inverse=inverse)
    for near, far in ((2.0, 6.0), (2.125, 4.525)):
        want = gen(campos, raydir, 40, near=near, far=far, jitter=0.3, u=u)
        got = gen(campos, raydir, 40, jitter=0.3, u=u,
                  depths=torch.tensor(ray_depths(opt, near, far)))
        for a, b in zip(got, want):
            assert torch.equal(a, b)


# ---------------------------------------------------- the runner's dispatch
def _runner_results(run_dir):
    """MeshRunner.train_steps_scan on two gloo ranks at mesh_points 1 and
    2 (one spawn), from the parallel tests' scene, state and draws."""
    (opt, ts, spec, grid, batch), (st, spec_t, grid_t, _) = _scene_of()
    B, R = batch["raydir"].shape[:2]
    job = dict(kind="scan", opt=_runner_opt(opt).to_json(),
               state=train_state_arrays(st), spec=spec_t,
               grid={k: v.numpy() for k, v in grid_t.items()},
               batch=_np_batch(batch), steps=S,
               draws=_world_draws(opt, B, R).numpy())
    return driver.launch(checks.run_jobs,
                         ([dict(job, points=1), dict(job, points=2)],), 2, 1,
                         "cpu", run_dir, threads=1)


def test_runner_train_steps_scan_equals_one_device(tmp_path_factory):
    """The runner's dispatch on two ranks (two ray shards at mesh_points
    1, two point shards at 2) equals the one-device dispatch at the
    comp_groups the runner sets (its ray shards): loss items at the
    parallel tests' bars, sr_overflow exactly, the buffers after the S
    steps at the train bars."""
    results = _runner_results(str(tmp_path_factory.mktemp("scan_ranks")))
    (opt, ts, spec, grid, batch), (_, spec_t, grid_t, tb) = _scene_of()
    B, R = batch["raydir"].shape[:2]
    for points, res in zip((1, 2), results):
        st = from_jax_train_state(_np_tree(ts), opt, device="cpu")
        st, want = ttr.train_steps_scan(
            st, grid_t, _port_batches(tb),
            _runner_opt(opt).replace(comp_groups=2 // points), spec_t,
            u=_world_draws(opt, B, R))
        assert float(want["sr_overflow"].max()) > 0
        assert set(res["items"]) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(res["items"][k], v.numpy(),
                                       err_msg=k, **RANK_TOL)
        np.testing.assert_array_equal(res["items"]["sr_overflow"],
                                      want["sr_overflow"].numpy())
        for k, v in st.pt_train.items():
            np.testing.assert_allclose(res["points_after"][k],
                                       v.detach().numpy(), err_msg=k,
                                       **STEP_TOL)
        for k, v in st.aggregator.named_parameters():
            np.testing.assert_allclose(res["net_after"][k],
                                       v.detach().numpy(), err_msg=k,
                                       **STEP_TOL)
