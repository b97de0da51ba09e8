"""Scene editing against the JAX package: per-point Rw2c in the point state,
the neighbor gather and the aggregator (both the plain K1 route,
use_fused_trunk 1, and the composition), checkpoints that carry it,
`load_reference_torch`, and the editing driver (`run/editing.py`) with its
composite read back by test_ft.

Tolerances: renders rtol = atol = 1e-5 (float32, summation order differs);
composed point states and padding exactly; the driver's PSNR within
0.01 dB (nothing trains).
"""

import os
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointnerf_tpu.models import neural_points as jnpc
from pointnerf_tpu.ops import grid as jgrid
from pointnerf_tpu.run import editing as jediting
from pointnerf_tpu.train import trainer as jtrainer
from pointnerf_tpu.utils import checkpoint as jckpt
from pointnerf_tpu_torch.config import Options
from pointnerf_tpu_torch.models import neural_points as tnpc
from pointnerf_tpu_torch.run import editing as tediting
from pointnerf_tpu_torch.run import test_ft as ttest_ft
from pointnerf_tpu_torch.run import train_ft as tdriver
from pointnerf_tpu_torch.train import trainer as ttrainer
from pointnerf_tpu_torch.utils import checkpoint as tckpt

from fixtures import make_nerf_synth_scene
from test_end_to_end import tiny_setup
from test_torch_port_render import _lego_like, _port_grid, _port_state
from test_train_ft_driver import tiny_train_opt

TOL = dict(rtol=1e-5, atol=1e-5)
ROT90 = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                 np.float32)


def _tb(batch):
    return {k: (torch.tensor(np.asarray(v)) if hasattr(v, "shape") else v)
            for k, v in batch.items()}


def _rotated(opt, ts, batch, Rot):
    """JAX's test_rotated_scene_renders_consistently inputs: the cloud,
    its dirs, the camera and the rays rotated by Rot, per-point Rw2c =
    Rotᵀ; the grid rebuilt over the rotated points."""
    state = jtrainer.point_state_of(ts)
    n = int(np.asarray(state["mask"]).sum())
    cap = state["xyz"].shape[0]
    xyz_r = np.asarray(state["xyz"]) @ Rot.T
    rw2c = np.tile((np.eye(3, dtype=np.float32) @ Rot.T)[None], (cap, 1, 1))
    state_r = dict(state, xyz=jnp.asarray(xyz_r), Rw2c=jnp.asarray(rw2c),
                   dir=jnp.asarray(np.asarray(state["dir"]) @ Rot.T))
    spec_r = jgrid.make_grid_spec(opt, xyz_r[:n].min(0), xyz_r[:n].max(0),
                                  max_points=n)
    grid_r = jgrid.build_grid(state_r["xyz"], state_r["mask"], spec_r)
    batch_r = dict(batch,
                   campos=jnp.asarray(np.asarray(batch["campos"]) @ Rot.T),
                   camrotc2w=jnp.asarray(
                       Rot @ np.asarray(batch["camrotc2w"])[0])[None],
                   raydir=jnp.asarray(np.asarray(batch["raydir"]) @ Rot.T))
    pt_train, pt_static = jtrainer.split_point_params(state_r, opt)
    return (ts._replace(pt_train=pt_train, pt_static=pt_static), spec_r,
            grid_r, batch_r)


def _tiny(**kw):
    opt, state, spec, grid, batch, _ = tiny_setup()
    opt = opt.replace(**kw)
    return opt, jtrainer.create_train_state(opt, jax.random.PRNGKey(0),
                                            state), spec, grid, batch


def test_per_point_identity_rw2c_equals_global():
    """A per-point identity Rw2c renders as the global identity
    (JAX's test_editing.py:21), composition and plain K1 route."""
    for fused in (0, 1):
        opt, ts, _, _, batch = _tiny(use_fused_trunk=fused)
        st = _port_state(ts)
        spec, grid = _port_grid(opt, st.points)
        want = ttrainer.eval_step(st, grid, _tb(batch), opt, spec)
        cap = st.points["xyz"].shape[0]
        pp = dict(st.points, Rw2c=torch.eye(3).expand(cap, 3, 3).clone())
        got = ttrainer.eval_step(ttrainer.ServeState(st.aggregator, pp), grid,
                                 _tb(batch), opt, spec)
        np.testing.assert_allclose(got["coarse_raycolor"].numpy(),
                                   want["coarse_raycolor"].numpy(), **TOL)


CASES = {
    "tiny-composition": (_tiny, dict(use_fused_trunk=0)),
    "tiny-k1-plain": (_tiny, dict(use_fused_trunk=1)),
    "lego-k1-plain": (lambda **kw: _lego_like(**kw), dict(use_fused_trunk=1)),
    "lego-composition": (lambda **kw: _lego_like(**kw),
                         dict(use_fused_trunk=0)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_rotated_render_matches_jax(case):
    """A 90° rotated cloud, camera and per-point Rw2c: the port's
    eval_step against JAX's render of the same inputs at 1e-5 (JAX
    composes the trunk under per-point Rw2c; the port runs K1's plain
    version with use_fused_trunk 1, the composition with 0), through the
    uncompacted query (tiny) and the compacted, K-tiered one (lego);
    and within JAX's own bounds of the unrotated render."""
    make, kw = CASES[case]
    out = make(**kw)
    opt, ts, batch = out[0], out[1], out[-1]
    ts_r, _, grid_r, batch_r = _rotated(opt, ts, batch, ROT90)
    want = jtrainer.eval_step(ts_r, grid_r, batch_r, opt, _rotated(
        opt, ts, batch, ROT90)[1])
    st = _port_state(ts_r)
    assert st.points["Rw2c"].shape == (st.points["xyz"].shape[0], 3, 3)
    spec_t, grid_t = _port_grid(opt, st.points)
    got = ttrainer.eval_step(st, grid_t, _tb(batch_r), opt, spec_t)
    assert np.asarray(want["ray_mask"]).any()
    np.testing.assert_array_equal(got["ray_mask"].numpy(),
                                  np.asarray(want["ray_mask"]))
    for k in ("coarse_raycolor", "weight", "conf_coefficient"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)
    st0 = _port_state(ts)
    spec0, grid0 = _port_grid(opt, st0.points)
    ref = ttrainer.eval_step(st0, grid0, _tb(batch), opt, spec0)
    d = np.abs(got["coarse_raycolor"].numpy() - ref["coarse_raycolor"].numpy())
    assert d.mean() < 5e-4 and d.max() < 2e-2, (d.mean(), d.max())


def test_point_cloud_pads_rw2c():
    """create_point_cloud pads a per-point Rw2c with the identity,
    expand_capacity pads it with zeros, each as JAX's does; a per-point
    Rw2c whose rows are not the points' (an exported one, [cap,3,3]) fails
    in both: JAX's numpy broadcast, the port's ValueError."""
    rng = np.random.RandomState(1)
    n = 10
    xyz, emb = rng.randn(n, 3).astype(np.float32), rng.randn(n, 4).astype(
        np.float32)
    rw2c = rng.randn(n, 3, 3).astype(np.float32)
    want = jnpc.create_point_cloud(xyz, emb, Rw2c=rw2c, capacity=16)
    got = tnpc.create_point_cloud(xyz, emb, Rw2c=rw2c, capacity=16,
                                  device="cpu")
    np.testing.assert_array_equal(got["Rw2c"].numpy(),
                                  np.asarray(want["Rw2c"]))
    opt = tiny_setup()[0]
    jts = jtrainer.expand_capacity(
        jtrainer.create_train_state(opt, jax.random.PRNGKey(0), want), 24)
    tts = ttrainer.expand_capacity(ttrainer.create_train_state(
        opt, got, torch.Generator().manual_seed(0)), 24)
    np.testing.assert_array_equal(tts.pt_static["Rw2c"].numpy(),
                                  np.asarray(jts.pt_static["Rw2c"]))
    assert not tts.pt_static["Rw2c"][16:].any()
    # an exported per-point Rw2c has the capacity's rows (slot order): it
    # does not load as the points' in either package
    with pytest.raises(ValueError, match="broadcast"):
        jnpc.create_point_cloud(xyz[:4], emb[:4], Rw2c=rw2c)
    with pytest.raises(ValueError, match="Rw2c"):
        tnpc.create_point_cloud(xyz[:4], emb[:4], Rw2c=rw2c, device="cpu")


def test_checkpoints_carry_per_point_rw2c(tmp_path):
    """A train state with per-point Rw2c: JAX's save_checkpoint → the
    port's load_checkpoint, and back through JAX's load_checkpoint; both
    exports' neural_points.Rw2c equal ([cap,3,3], slot order)."""
    opt, ts, _, _, batch = _tiny()
    ts_r = _rotated(opt, ts, batch, ROT90)[0]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save_checkpoint(jdir, 5, ts_r, opt)
    port, _ = tckpt.load_checkpoint(jdir, Options.from_json(opt.to_json()),
                                    device="cpu")
    want = np.asarray(ts_r.pt_static["Rw2c"])
    np.testing.assert_array_equal(port.pt_static["Rw2c"].numpy(), want)
    tckpt.save_checkpoint(tdir, 5, port, opt)
    back, _ = jckpt.load_checkpoint(tdir, ts_r)
    np.testing.assert_array_equal(np.asarray(back.pt_static["Rw2c"]), want)
    for d in (jdir, tdir):
        raw = dict(np.load(os.path.join(d, "5_net_ray_marching.npz")))
        np.testing.assert_array_equal(raw["neural_points.Rw2c"], want)


def test_load_reference_torch(tmp_path):
    """A torch.save'd reference state dict reads as the npz of the same
    keys does, through import_reference_dict."""
    opt, ts, _, _, batch = _tiny()
    npz = str(tmp_path / "1_net_ray_marching.npz")
    jckpt.export_reference_npz(npz, ts.agg_params, jtrainer.point_state_of(ts))
    raw = dict(np.load(npz))
    pth = str(tmp_path / "1_net_ray_marching.pth")
    torch.save({k: torch.as_tensor(v) for k, v in raw.items()}, pth)
    agg, pts = tckpt.load_reference_torch(pth)
    jagg, jpts = jckpt.import_reference_dict(raw, opt)
    assert set(pts) == set(jpts)
    for k in pts:
        np.testing.assert_array_equal(pts[k], jpts[k], err_msg=k)
    for b in jagg:
        for a, c in zip(agg[b], jagg[b]):
            np.testing.assert_array_equal(a["w"], np.asarray(c["w"]))
            np.testing.assert_array_equal(a["b"], np.asarray(c["b"]))


@pytest.fixture(scope="module")
def edit_src(tmp_path_factory):
    """A 20-step source trained by the port on the 40x40 plate, staged
    under edit_srcs/plate_src with a 'left' subset (x < 0) and a 'rot90'
    transform (90° about z, lifted 0.15)."""
    root = str(tmp_path_factory.mktemp("edit_scene"))
    make_nerf_synth_scene(root, wh=(40, 40))
    out = str(tmp_path_factory.mktemp("edit_ckpt"))
    opt = tiny_train_opt(root, out, maximum_step=20, prune_iter=0,
                         prob_freq=0, save_iter_freq=20, save_point_freq=0,
                         test_freq=0, test_num=1, experiment="plate_src")
    tdriver.main(Options.from_json(opt.to_json()), device="cpu")
    src = os.path.join(out, "edit_srcs", "plate_src")
    os.makedirs(os.path.join(src, "parts_index"))
    os.makedirs(os.path.join(src, "transforms"))
    for f in os.listdir(os.path.join(out, "plate_src")):
        if f.endswith(".npz"):
            shutil.copy(os.path.join(out, "plate_src", f), src)
    raw = dict(np.load(os.path.join(src, "20_net_ray_marching.npz")))
    keep = raw["neural_points.xyz"][0, :, 0] < 0
    np.savetxt(os.path.join(src, "parts_index", "left.txt"),
               keep.astype(np.int32))
    M = np.eye(4)
    M[:3, :3] = ROT90
    M[2, 3] = 0.15
    np.savetxt(os.path.join(src, "transforms", "rot90.txt"), M)
    eopt = opt.replace(experiment="edited", test_num=1,
                       ranges=(-0.55, -0.55, -0.25, 0.55, 0.55, 0.25))
    return eopt, int(keep.sum()), raw["neural_points.xyz"].shape[1]


PARTS = (["plate_src", "plate_src"], ["all", "left"], ["no", "rot90"])


def test_editing_main_matches_jax(edit_src, monkeypatch):
    """compose_parts exactly as JAX's (every padded buffer); editing.main
    against JAX's: n_points equal, PSNR within 0.01 dB, the composite's
    0_net_ray_marching.npz equal; then test_ft reads the composite back
    from its 0_full.npz and renders the same PSNR."""
    eopt, n_left, n = edit_src
    topt = Options.from_json(eopt.to_json())
    jparts = [jediting.load_part(eopt.checkpoints_dir, *a, eopt)
              for a in zip(*PARTS)]
    tparts = [tediting.load_part(eopt.checkpoints_dir, *a, topt)
              for a in zip(*PARTS)]
    _, jstate = jediting.compose_parts(jparts, eopt)
    _, tstate = tediting.compose_parts(tparts, topt, device="cpu")
    assert set(tstate) == set(jstate)
    for k, v in jstate.items():
        np.testing.assert_array_equal(tstate[k].numpy(), np.asarray(v),
                                      err_msg=k)
    assert int(tstate["mask"].sum()) == n + n_left

    # JAX's main tries the whole render path's video and swallows its
    # failures: left out, to keep the test short
    monkeypatch.setattr(jediting, "render_vid", lambda *a, **kw: {})
    want = jediting.main(eopt, *PARTS)
    popt = topt.replace(experiment="edited_port")
    # the port's video over the render split's first pose only
    from pointnerf_tpu_torch.run import render_vid as trv
    whole = trv.render_vid

    def first_pose(ts, grid, opt, spec, ds, *args, **kw):
        ds.render_poses, ds.total = ds.render_poses[:1], 1
        return whole(ts, grid, opt, spec, ds, *args, **kw)

    monkeypatch.setattr(trv, "render_vid", first_pose)
    got = tediting.main(popt, *PARTS, device="cpu")
    assert got["n_points"] == want["n_points"] == n + n_left
    assert abs(got["psnr"] - want["psnr"]) < 0.01, (got["psnr"], want["psnr"])
    assert got["n_frames"] == 1 and os.path.exists(got["video"])
    ck = lambda e: dict(np.load(os.path.join(
        eopt.checkpoints_dir, e, "0_net_ray_marching.npz")))
    a, b = ck("edited_port"), ck("edited")
    assert set(a) == set(b)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    res = ttest_ft.main(popt.replace(test_num=1), device="cpu")
    assert res["step"] == 0
    assert abs(res["psnr"] - got["psnr"]) < 1e-6


def test_editing_video_rule(edit_src, monkeypatch):
    """The video is skipped, with a line in the log, only for a dataset
    with no render split; any other failure of it raises (JAX's main
    swallows every exception there)."""
    eopt, _, _ = edit_src
    popt = Options.from_json(eopt.to_json()).replace(experiment="edited_rule")

    class NoRender:
        pass

    monkeypatch.setattr(tediting, "find_dataset_class_by_name",
                        lambda name: NoRender)
    got = tediting.main(popt, *PARTS, device="cpu")
    assert "video" not in got
    with open(os.path.join(popt.checkpoints_dir, "edited_rule",
                           "log.txt")) as f:
        assert "has no render split" in f.read()
    monkeypatch.undo()

    from pointnerf_tpu_torch.run import render_vid as trv

    def boom(*a, **kw):
        raise RuntimeError("render failed")

    monkeypatch.setattr(trv, "render_vid", boom)
    with pytest.raises(RuntimeError, match="render failed"):
        tediting.main(popt, *PARTS, device="cpu")
