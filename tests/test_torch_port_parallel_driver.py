"""The drivers on the multi-GPU runner (`parallel/driver.py`) on the CPU:
the --n_devices / --mesh_points rule against JAX's `make_runner`, the
sharded finetune driver against the port's single-device run, and the
world-size-1 runner.

The sharded run (2 gloo ranks, mesh_points 2: one ray shard, the point
buffers and bucket tables in two shards) draws the same batches and
jitter as the single-device run, so its final PSNR is held to it within
0.5 dB (JAX's bar for its sharded driver, tests/test_train_ft_driver.py).
Under the vox-grid query (NN -1; the scene and options of
test_torch_port_voxgrid.py's driver test, with a budget that overflows
and grows) the 2 ranks are two ray shards sharing each batch's budget,
and test_ft scores the checkpoint by mesh serving on 2 ranks too.
"""

import multiprocessing
import os

import pytest
import torch.distributed as dist

from pointnerf_tpu.parallel import make_runner as jmake_runner
from pointnerf_tpu_torch.config import Options
from pointnerf_tpu_torch.parallel.driver import make_runner, world_size
from pointnerf_tpu_torch.run import render_vid, test_ft, train_ft

from fixtures import make_nerf_synth_scene
from test_torch_port_voxgrid import _driver_opt, vox_scene  # noqa: F401
from test_train_ft_driver import tiny_train_opt

# 100 steps with a prune at 60 (conf 0.4 points under the 0.41 threshold
# go) and a probe-and-grow at 90 over random test frames (no opacity gate)
RUN = dict(maximum_step=100, prune_iter=60, prune_thresh=0.41, prob_freq=90,
           prob_mode=1, prob_thresh=-0.7, save_iter_freq=100,
           save_point_freq=100)


@pytest.fixture(scope="module")
def scene_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scene"))
    make_nerf_synth_scene(root, wh=(40, 40))
    return root


def _opt(root, out, **kw):
    return Options.from_json(tiny_train_opt(root, out, **RUN, **kw).to_json())


@pytest.fixture(scope="module")
def single(scene_root, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("single"))
    return out, train_ft.main(_opt(scene_root, out), device="cpu")


def test_jax_builds_a_runner_where_the_cpu_port_refuses():
    """F1: n_devices 0 with mesh_points 2 is never a silent single-device
    run. JAX builds a runner over all local devices (its 8-device CPU
    mesh: 4 ray shards by 2 point shards); the port's CPU counts one
    device, as a JAX CPU backend does without the virtual-device flag,
    and 2 does not divide 1: ValueError naming mesh_points, as JAX's
    make_mesh fails on one device."""
    from pointnerf_tpu.config import Options as JOptions
    runner = jmake_runner(JOptions(n_devices=0, mesh_points=2))
    assert runner is not None and runner.points == 2
    assert dict(zip(runner.mesh.axis_names, runner.mesh.devices.shape)) \
        == {"batch": 1, "rays": 4, "points": 2}
    with pytest.raises(ValueError, match="mesh_points"):
        world_size(Options(n_devices=0, mesh_points=2), "cpu")


@pytest.mark.parametrize("driver", [train_ft, test_ft, render_vid],
                         ids=["train_ft", "test_ft", "render_vid"])
def test_drivers_refuse_mesh_points_on_one_cpu(driver, tmp_path):
    """Each driver raises before it starts a rank."""
    opt = Options(n_devices=0, mesh_points=2, checkpoints_dir=str(tmp_path))
    with pytest.raises(ValueError, match="mesh_points"):
        driver.main(opt, device="cpu")
    assert not multiprocessing.active_children()


@pytest.mark.parametrize("n_devices,mesh_points,device,want", [
    (0, 1, "cpu", 0), (1, 1, "cpu", 0), (-1, 1, "cpu", 1), (2, 1, "cpu", 2),
    (4, 2, "cpu", 4), (-1, 2, "cpu", "mesh_points"),
    (6, 4, "cpu", "mesh_points"), (2, 1, "cuda", "exceeds")])
def test_world_size_rule(n_devices, mesh_points, device, want):
    """JAX's make_runner rule with the port's device count (world_size,
    and make_runner outside the ranks): no runner for 0 or 1 device
    without point shards; -1 is every local device (one
    CPU); an explicit N > 1 on the CPU is N processes; more ranks than
    cards (this machine has none) or a mesh_points that does not divide
    the ranks raises ValueError."""
    opt = Options(n_devices=n_devices, mesh_points=mesh_points)
    if isinstance(want, int):
        assert world_size(opt, device) == want
        if want == 0:
            assert make_runner(opt, device) is None
        else:           # a runner lives in the ranks that launch starts
            with pytest.raises(RuntimeError, match="launch"):
                make_runner(opt, device)
    else:
        with pytest.raises(ValueError, match=want):
            world_size(opt, device)


def _vox_opt(root, cpath, out, **kw):
    return Options.from_json(_driver_opt(root, cpath, out, SR_budget=32,
                                         **kw).to_json())


@pytest.fixture(scope="module")
def vox_single(vox_scene, tmp_path_factory):  # noqa: F811
    out = str(tmp_path_factory.mktemp("vox_single"))
    return out, train_ft.main(_vox_opt(*vox_scene, out), device="cpu")


def test_sharded_vox_grid_driver_matches_single_device(vox_scene,  # noqa: F811
                                                       vox_single, tmp_path):
    """NN -1 on n_devices 2 (two ray shards): the budget overflows and
    grows as on one device, the final PSNR within 0.5 dB of the
    single-device run; test_ft on 2 ranks (mesh serving under NN -1)
    scores the checkpoint as the single-device test_ft does (1e-3 dB)."""
    out_1, want = vox_single
    opt = _vox_opt(*vox_scene, str(tmp_path), n_devices=2)
    got = train_ft.main(opt, device="cpu")
    assert got["total_steps"] == want["total_steps"] == 20
    assert abs(got["final_psnr"] - want["final_psnr"]) < 0.5, \
        (got["final_psnr"], want["final_psnr"])
    exp = os.path.join(str(tmp_path), opt.experiment)
    with open(os.path.join(exp, "log.txt")) as f:
        log = f.read()
    assert "SR_budget overflow" in log and "budget 32 -> 128" in log
    scored = test_ft.main(opt, device="cpu")
    scored_1 = test_ft.main(opt.replace(n_devices=0), device="cpu")
    assert scored["step"] == scored_1["step"] == 20
    assert abs(scored["psnr"] - scored_1["psnr"]) < 1e-3


def test_sharded_driver_matches_single_device(scene_root, single, tmp_path):
    """n_devices 2, mesh_points 2: the same prune and grow, the final PSNR
    within 0.5 dB of the single-device run, one log written (rank 0's),
    the single-device files, and a checkpoint that the single-device
    test_ft loads and scores as it scores the single-device run's."""
    out_1, want = single
    opt = _opt(scene_root, str(tmp_path), n_devices=2, mesh_points=2)
    got = train_ft.main(opt, device="cpu")
    assert got["total_steps"] == want["total_steps"] == 100
    assert got["timing"]["prune"] == want["timing"]["prune"]
    assert [g[0] for g in got["timing"]["grow"]] == [90]
    assert got["timing"]["grow"] == want["timing"]["grow"]
    assert abs(got["final_psnr"] - want["final_psnr"]) < 0.5, \
        (got["final_psnr"], want["final_psnr"])
    exp = os.path.join(str(tmp_path), "plate_e2e")
    with open(os.path.join(exp, "log.txt")) as f:
        log = f.read()
    assert log.count("done: 100 steps") == 1 and log.count("start:") == 1
    assert "(point buffers sharded)" in log
    assert sorted(f for f in os.listdir(exp) if not os.path.isdir(
        os.path.join(exp, f))) == sorted(f for f in os.listdir(
            os.path.join(out_1, "plate_e2e")) if not os.path.isdir(
            os.path.join(out_1, "plate_e2e", f)))
    assert not [f for f in os.listdir(exp) if f.startswith(".dist_store")]
    scored = test_ft.main(opt.replace(n_devices=0, mesh_points=1),
                          device="cpu")
    scored_1 = test_ft.main(_opt(scene_root, out_1), device="cpu")
    assert scored["step"] == 100
    assert abs(scored["psnr"] - scored_1["psnr"]) < 0.5
    assert got["state"].points["xyz"].shape == \
        want["state"].points["xyz"].shape


def test_world_size_one_runs_in_this_process(scene_root, single, tmp_path):
    """n_devices -1 on the CPU is one rank: no process is spawned, the
    driver runs over a world-size-1 group that is gone afterwards, and it
    trains as the single-device run does."""
    _, want = single
    opt = _opt(scene_root, str(tmp_path), n_devices=-1)
    got = train_ft.main(opt, device="cpu")
    assert not dist.is_initialized()
    assert not multiprocessing.active_children()
    assert got["timing"]["prune"] == want["timing"]["prune"]
    assert abs(got["final_psnr"] - want["final_psnr"]) < 1e-3
