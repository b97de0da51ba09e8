"""The finetune driver slice against the JAX package: prune, grow and the
capacity expansion, the probe render and probe_hole, checkpoints both
ways, the point init, metrics, the PNG codec and the whole driver.

Inputs are made with numpy from seeds and carried across as numpy arrays.
Tolerances: integers, masks, buffers and moments exactly; float renders
and probe statistics rtol = atol = 1e-5 (float32, another summation
order); metrics rtol 1e-12 (the same float64 numpy code). The drivers'
randomness differs (JAX PRNG keys and threefry against torch generators),
so the whole-driver run is held to the JAX driver's PSNR within 1.5 dB.
"""

import os
import struct
import zlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointnerf_tpu.config import Options as JOptions
from pointnerf_tpu.data import create_dataset as jcreate
from pointnerf_tpu.models import neural_points as jnpc
from pointnerf_tpu.models.networks import PlateauTracker as JPlateau
from pointnerf_tpu.run import common as jcommon
from pointnerf_tpu.run import train_ft as jdriver
from pointnerf_tpu.train import trainer as jtr
from pointnerf_tpu.utils import checkpoint as jckpt
from pointnerf_tpu.utils import metrics as jmetrics
from pointnerf_tpu.utils.visualizer import Visualizer as JVisualizer
from pointnerf_tpu_torch.config import Options
from pointnerf_tpu_torch.data import create_dataset
from pointnerf_tpu_torch.models import neural_points as tnpc
from pointnerf_tpu_torch.models.networks import PlateauTracker
from pointnerf_tpu_torch.run import common as tcommon
from pointnerf_tpu_torch.run import train_ft as tdriver
from pointnerf_tpu_torch.train import trainer as ttr
from pointnerf_tpu_torch.utils import checkpoint as tckpt
from pointnerf_tpu_torch.utils import metrics as tmetrics
from pointnerf_tpu_torch.utils import png
from pointnerf_tpu_torch.utils.visualizer import Visualizer

from fixtures import make_nerf_synth_scene
from test_torch_port_render import _lego_like
from test_train_ft_driver import tiny_train_opt

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def scene_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scene"))
    make_nerf_synth_scene(root, wh=(40, 40))
    return root


def _port(opt):
    return Options.from_json(opt.to_json())


def _np_tree(tree):
    return jax.tree.map(lambda x: None if x is None else np.asarray(x), tree,
                        is_leaf=lambda x: x is None)


def _cloud(n=300, cap=512, seed=0):
    rng = np.random.RandomState(seed)
    arrs = (rng.uniform(-1, 1, (n, 3)), rng.uniform(-.5, .5, (n, 8)),
            rng.rand(n, 3), rng.rand(n, 3), rng.rand(n, 1))
    arrs = [a.astype(np.float32) for a in arrs]
    return (jnpc.create_point_cloud(*arrs, capacity=cap),
            tnpc.create_point_cloud(*arrs, capacity=cap, device="cpu"))


def _assert_state_equal(got, want):
    for k, v in want.items():
        if v is None:
            assert got.get(k) is None, k
        else:
            np.testing.assert_array_equal(got[k].detach().numpy(),
                                          np.asarray(v), err_msg=k)


def test_prune_matches_jax():
    js, ts = _cloud()
    for thresh in (0.3, 0.8):
        js = jnpc.prune(js, thresh)
        tnpc.prune(ts, thresh)
        _assert_state_equal(ts, js)
        assert int(tnpc.num_active(ts)) == int(jnpc.num_active(js))


@pytest.mark.parametrize("M", [40, 600])
def test_grow_matches_jax(M):
    """Candidates into freed and never-used slots, in the JAX ranking; with
    M=600 more real candidates than free slots, the rest dropped."""
    js, ts = _cloud()
    js = jnpc.prune(js, 0.5)
    tnpc.prune(ts, 0.5)
    rng = np.random.RandomState(M)
    add = [rng.rand(M, w).astype(np.float32) for w in (3, 8, 3, 3, 1)]
    mask = rng.rand(M) < 0.8
    js, jdrop = jnpc.grow(js, *map(jnp.asarray, add), jnp.asarray(mask))
    _, tdrop = tnpc.grow(ts, *map(torch.as_tensor, add),
                         torch.as_tensor(mask))
    _assert_state_equal(ts, js)
    assert tdrop == int(jdrop) and (tdrop > 0) == (M == 600)


def _jax_ts_with_moments(opt, state, seed=0, count=7):
    """A JAX TrainState whose point and net Adam moments are random draws
    (count steps taken)."""
    ts = jtr.create_train_state(opt, jax.random.PRNGKey(seed), state)
    rng = np.random.RandomState(seed)

    def fill(chain):
        adam = chain[0]
        rnd = lambda x: jnp.asarray(rng.uniform(0, 1e-3, x.shape), x.dtype)
        adam = adam._replace(count=jnp.int32(count),
                             mu=jax.tree.map(rnd, adam.mu),
                             nu=jax.tree.map(rnd, adam.nu))
        return (adam, chain[1]._replace(count=jnp.int32(count)))
    return ts._replace(opt_state_net=fill(ts.opt_state_net),
                       opt_state_pts=fill(ts.opt_state_pts),
                       step=jnp.int32(count))


def _scene_opt(**kw):
    from test_end_to_end import tiny_setup
    opt, state, _, _, _, xyz = tiny_setup()
    return opt.replace(**kw), state


@pytest.mark.parametrize("packed", [1, 0])
def test_expand_capacity_matches_jax(packed):
    """Padded buffers and moments, carried step counts and a rebuilt point
    optimizer over the new leaves; JAX packs the point moments by default,
    the port keeps them per buffer."""
    opt, state = _scene_opt(packed_point_adam=packed)
    jts = _jax_ts_with_moments(opt, state)
    pts = tckpt.from_jax_train_state(_np_tree(jts), _port(opt), device="cpu")
    cap = state["mask"].shape[0]
    jts = jtr.expand_capacity(jts, cap + 4096)
    ttr.expand_capacity(pts, cap + 4096)
    _assert_state_equal(pts.points, jtr.point_state_of(jts))
    jadam = _np_tree(jts.opt_state_pts[0])
    mu = tckpt._point_moments(jadam.mu, pts.pt_train)
    nu = tckpt._point_moments(jadam.nu, pts.pt_train)
    group = pts.opt_pts.param_groups[0]["params"]
    assert [id(p) for p in group] == [id(p) for p in pts.pt_train.values()]
    for k, p in pts.pt_train.items():
        st = pts.opt_pts.state[p]
        assert p.requires_grad and p.is_leaf
        assert float(st["step"]) == int(jadam.count) == 7
        np.testing.assert_array_equal(st["exp_avg"].numpy(), mu[k])
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(), nu[k])
    assert pts.step == int(jts.step)


def test_probe_render_matches_jax():
    """prob=True: the uncompacted render's probe statistics."""
    opt, ts, spec_j, grid_j, batch = _lego_like(use_fused_trunk=0)
    want = jtr.eval_step(ts, grid_j, batch, opt, spec_j, prob=True)
    agg, pts = tckpt.from_jax_params(
        _np_tree(ts.agg_params),
        {k: (None if v is None else np.asarray(v))
         for k, v in jtr.point_state_of(ts).items()}, device="cpu")
    st = ttr.ServeState(agg, pts)
    spec_t, grid_t = tcommon.make_spec_and_grid(opt, pts)
    tb = {k: (torch.tensor(np.asarray(v)) if hasattr(v, "shape") else v)
          for k, v in batch.items()}
    got = ttr.eval_step(st, grid_t, tb, opt, spec_t, prob=True)
    np.testing.assert_array_equal(got["ray_mask"].numpy(),
                                  np.asarray(want["ray_mask"]))
    assert int(got["sr_overflow"]) == int(want["sr_overflow"]) == 0
    for k in tcommon.PROBE_KEYS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)
    assert float(np.asarray(want["ray_max_shading_opacity"]).max()) > 0


def _holed_jax_state(opt, ds):
    """The JAX point init of the fixture scene with a disk of points
    pruned, so rays through it miss."""
    state = jcommon.init_point_state_from_dataset(opt, ds,
                                                  jax.random.PRNGKey(0))
    xyz = np.asarray(state["xyz"])
    conf = np.asarray(state["conf"]).copy()
    conf[(xyz[:, 0] - 0.05) ** 2 + (xyz[:, 1] - 0.05) ** 2 < 0.3 ** 2] = 0.0
    return jnpc.prune(dict(state, conf=jnp.asarray(conf)), 0.01)


def test_probe_hole_candidates_match_jax(scene_root, tmp_path):
    jopt = tiny_train_opt(scene_root, str(tmp_path), prob_thresh=-1.0)
    jds = jcreate(jopt, split="train")
    jts = jtr.create_train_state(jopt, jax.random.PRNGKey(1),
                                 _holed_jax_state(jopt, jds))
    opt = _port(jopt)
    pts = tckpt.from_jax_train_state(_np_tree(jts), opt, device="cpu")
    spec, grid = jcommon.make_spec_and_grid(jopt, jtr.point_state_of(jts))
    frames = np.array([0, 3])
    want = jdriver.probe_hole(jts, grid, jopt, spec, jds, frames,
                              JVisualizer(jopt), 120)
    got = tdriver.probe_hole(pts, opt, create_dataset(opt, "train"), frames,
                             Visualizer(opt), 120)
    assert len(want["xyz"]) > 10
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


def _render(opt, ts_or_pair, item, jax_side):
    if jax_side:
        spec, grid = jcommon.make_spec_and_grid(opt, jtr.point_state_of(
            ts_or_pair))
        return jcommon.render_image(ts_or_pair, grid, opt, spec, item)
    spec, grid = tcommon.make_spec_and_grid(opt, ts_or_pair.points)
    return tcommon.render_image(ts_or_pair, grid, opt, spec, item)


@pytest.mark.parametrize("packed", [1, 0])
def test_checkpoints_load_both_ways(packed, tmp_path):
    """The port's checkpoint loads in JAX's load_checkpoint (packed or
    per-buffer template) and import_reference_dict and renders JAX's image;
    a JAX checkpoint loads in the port's load_checkpoint and renders it
    too. States, moments and counters equal exactly."""
    from test_torch_port_render import _image_item
    opt, state = _scene_opt(packed_point_adam=packed, random_sample_size=4)
    jts = _jax_ts_with_moments(opt, state, count=5)
    popt = _port(opt)
    pts = tckpt.from_jax_train_state(_np_tree(jts), popt, device="cpu")
    item = _image_item()
    want = _render(opt, jts, item, True)

    # port → JAX
    d1 = os.path.join(tmp_path, "port")
    tckpt.save_checkpoint(d1, 5, pts, popt, best_psnr=3.5, best_iter=2,
                          extra_counters={"lr": 0.01, "plr": 0.02})
    template = jtr.create_train_state(opt, jax.random.PRNGKey(9), state)
    loaded, counters = jckpt.load_checkpoint(d1, template)
    for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(jts)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert counters["total_steps"] == 5 and counters["best_iter"] == 2
    got = _render(opt, loaded, item, True)
    np.testing.assert_array_equal(got["coarse_raycolor"],
                                  want["coarse_raycolor"])
    agg, pts_np = jckpt.import_reference_dict(
        dict(np.load(os.path.join(d1, "5_net_ray_marching.npz"))), opt)
    served = jts._replace(agg_params=agg, pt_train={}, pt_static=dict(
        jnpc.create_point_cloud(pts_np["xyz"], pts_np["embedding"],
                                pts_np["color"], pts_np["dir"],
                                pts_np["conf"])))
    np.testing.assert_allclose(_render(opt, served, item, True)[
        "coarse_raycolor"], want["coarse_raycolor"], **TOL)

    # JAX → port
    d2 = os.path.join(tmp_path, "jax")
    jckpt.save_checkpoint(d2, 5, jts, opt, 3.5, 2)
    assert tckpt.latest_step(d2) == 5
    back, counters = tckpt.load_checkpoint(d2, popt, device="cpu")
    assert counters["total_steps"] == 5 and back.step == 5
    flat, ref = tckpt.train_state_arrays(back), tckpt.train_state_arrays(pts)
    assert sorted(flat) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(flat[k], ref[k], err_msg=k)
    np.testing.assert_allclose(_render(popt, back, item, False)[
        "coarse_raycolor"], want["coarse_raycolor"], **TOL)
    with pytest.raises(ValueError, match="aggregator"):
        tckpt.load_checkpoint(d2, popt.replace(shading_feature_num=16),
                              device="cpu")


def test_point_init_matches_jax(scene_root, tmp_path):
    rng = np.random.RandomState(0)
    xyz = rng.uniform(-1, 1, (5000, 3))
    for vox in (8, 33):
        a = tcommon.construct_vox_points_closest(xyz, vox)
        b = jcommon.construct_vox_points_closest(xyz, vox)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    for space in (None, (xyz.min(0) - 0.1, xyz.max(0) + 0.2)):
        a = tcommon._vox_partition(xyz, 17, *(space or ()))
        b = jcommon._vox_partition(xyz, 17, *(space or ()))
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
    jopt = tiny_train_opt(scene_root, str(tmp_path))
    want = jcommon.init_point_state_from_dataset(
        jopt, jcreate(jopt, split="train"), jax.random.PRNGKey(0))
    opt = _port(jopt)
    got = tcommon.init_point_state_from_dataset(
        opt, create_dataset(opt, "train"), device="cpu")
    _assert_state_equal(got, want)
    with pytest.raises(NotImplementedError):
        tcommon.init_point_state_from_dataset(opt.replace(load_points=2),
                                              None, device="cpu")


def test_dataset_items_match_jax(scene_root, tmp_path):
    jopt = tiny_train_opt(scene_root, str(tmp_path))
    opt = _port(jopt)
    for split in ("train", "test"):
        jds, tds = jcreate(jopt, split=split), create_dataset(opt, split)
        assert len(jds) == len(tds)
        a = jds.get_item(2, rng=np.random.RandomState(5))
        b = tds.get_item(2, rng=np.random.RandomState(5))
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]),
                                          err_msg=k)
    np.testing.assert_array_equal(tds.get_campos_ray()[1],
                                  jds.get_campos_ray()[1])


def test_metrics_and_plateau_match_jax():
    rng = np.random.RandomState(0)
    gt = rng.rand(30, 34, 3).astype(np.float32)
    img = np.clip(gt + rng.normal(0, 0.05, gt.shape), 0, 1).astype(np.float32)
    for fn in ("psnr", "ssim", "rmse"):
        np.testing.assert_allclose(getattr(tmetrics, fn)(gt, img),
                                   getattr(jmetrics, fn)(gt, img),
                                   rtol=1e-12, err_msg=fn)
    a, b = PlateauTracker(mode="max", patience=2), JPlateau(mode="max",
                                                            patience=2)
    for v in (20.0, 20.1, 20.05, 20.1, 20.2, 22.0, 21.0, 21.5, 21.9):
        assert a.update(v) == b.update(v)
    assert a.state_dict() == b.state_dict()


def test_cli_and_test_helpers_match_jax():
    argv = ["--preset", "nerf_synth:lego", "--random_sample_size", "12",
            "--vsize", "0.01", "0.01", "0.01", "--maximum_step", "5"]
    assert tcommon.options_from_cli(argv) == _port(
        jcommon.options_from_cli(argv))
    opt = Options(visual_items=("coarse_raycolor", "gt_image",
                                "ray_masked_coarse_raycolor"))
    rng = np.random.RandomState(0)
    img, gt = rng.rand(4, 4, 3), rng.rand(4, 4, 3)
    rm = (rng.rand(4, 4, 1) > 0.5).astype(np.float32)
    maps = {"coarse_raycolor": img, "ray_mask": rm}
    assert tdriver._test_loss_items(opt, img, gt, rm) == \
        jdriver._test_loss_items(JOptions(), img, gt, rm)
    a = tdriver._visual_maps(opt, maps, gt)
    b = jdriver._visual_maps(JOptions(visual_items=opt.visual_items), maps,
                             gt)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    m = rng.rand(20, 20) < 0.1
    np.testing.assert_array_equal(tdriver.bloat_mask(m, 2),
                                  jdriver.bloat_mask(m, 2))


def _png_with_filter(img: np.ndarray, kind: int) -> bytes:
    """An 8-bit RGBA PNG whose every scanline uses filter `kind`."""
    H, W, C = img.shape
    x = img.reshape(H, W * C).astype(np.int64)
    prior = np.zeros_like(x)
    prior[1:] = x[:-1]
    left = np.zeros_like(x)
    left[:, C:] = x[:, :-C]
    up_left = np.zeros_like(x)
    up_left[1:, C:] = x[:-1, :-C]
    if kind == 0:
        f = x
    elif kind == 1:
        f = x - left
    elif kind == 2:
        f = x - prior
    elif kind == 3:
        f = x - (left + prior) // 2
    else:
        p = left + prior - up_left
        pa, pb, pc = abs(p - left), abs(p - prior), abs(p - up_left)
        f = x - np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, prior, up_left))
    raw = np.concatenate([np.full((H, 1), kind), f % 256], 1).astype(np.uint8)

    def chunk(t, d):
        return struct.pack(">I", len(d)) + t + d + struct.pack(
            ">I", zlib.crc32(t + d) & 0xFFFFFFFF)
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 6, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + chunk(b"IEND", b""))


def test_png_codec_matches_imageio(tmp_path):
    """The port's reader on PIL-written RGB/RGBA/gray files and on files
    using each of the five filters; its writer read back by imageio."""
    import imageio.v2 as imageio
    from PIL import Image
    rng = np.random.RandomState(0)
    ramp = np.linspace(0, 255, 37 * 23 * 4).reshape(37, 23, 4)
    img = np.clip(ramp + rng.normal(0, 20, ramp.shape), 0, 255).astype(
        np.uint8)
    for mode, arr in (("RGBA", img), ("RGB", img[..., :3]),
                      ("L", img[..., 0])):
        p = os.path.join(tmp_path, f"pil_{mode}.png")
        Image.fromarray(arr, mode).save(p)
        np.testing.assert_array_equal(png.read_png(p), imageio.imread(p))
    for kind in range(5):
        p = os.path.join(tmp_path, f"f{kind}.png")
        with open(p, "wb") as f:
            f.write(_png_with_filter(img, kind))
        np.testing.assert_array_equal(png.read_png(p), img)
        np.testing.assert_array_equal(imageio.imread(p), img)
    for arr in (img, img[..., :3], img[..., 0]):
        p = os.path.join(tmp_path, "ours.png")
        png.write_png(p, arr)
        np.testing.assert_array_equal(imageio.imread(p), arr)


def test_driver_trains_like_the_jax_driver(scene_root, tmp_path):
    """The whole driver on the fixture scene with tiny_train_opt (260 steps,
    two prunes, probes every 120 steps, checkpoints): PSNR > 16, the files
    on disk, a resume that stops at once, and the final PSNR within 1.5 dB
    of the JAX driver's on the same scene and options."""
    jopt = tiny_train_opt(scene_root, os.path.join(tmp_path, "jax"))
    want = jdriver.main(jopt)
    opt = _port(tiny_train_opt(scene_root, os.path.join(tmp_path, "port")))
    res = tdriver.main(opt, device="cpu")
    assert res["total_steps"] == 260 and res["timing"]["steps"] == 260
    assert [p[0] for p in res["timing"]["prune"]] == [100, 200]
    assert res["final_psnr"] > 16.0, res["final_psnr"]
    assert abs(res["final_psnr"] - want["final_psnr"]) < 1.5, \
        (res["final_psnr"], want["final_psnr"])
    exp = os.path.join(tmp_path, "port", "plate_e2e")
    for f in ("log.txt", "opt.json", "260_net_ray_marching.npz",
              "260_full.npz", "260_states.npz", "130_full.npz"):
        assert os.path.exists(os.path.join(exp, f)), f
    assert res["scores"]["psnr"] > 16.0
    again = tdriver.main(opt, device="cpu")
    assert again["total_steps"] == 260 and again["timing"]["steps"] == 0
    with pytest.raises(NotImplementedError):
        tdriver.main(opt.replace(n_devices=2), device="cpu")


def test_cli_runs_the_driver_on_the_cpu(scene_root, tmp_path):
    """python -m pointnerf_tpu_torch.run.train_ft --device cpu --config ..."""
    opt = _port(tiny_train_opt(scene_root, str(tmp_path), maximum_step=3,
                               prune_iter=0, prob_freq=0, test_num=1))
    path = os.path.join(tmp_path, "opt.json")
    with open(path, "w") as f:
        f.write(opt.to_json())
    res = tdriver.cli(["--device", "cpu", "--config", path,
                       "--experiment", "cli"])
    assert res["total_steps"] == 3 and res["state"].points["xyz"].is_cpu
    assert os.path.exists(os.path.join(tmp_path, "cli", "3_full.npz"))
