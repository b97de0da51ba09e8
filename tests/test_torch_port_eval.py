"""The evaluation and serving drivers against the JAX package's: LPIPS
(`utils/lpips.py`), `report_metrics`, `run/evaluate.py`, the NeRF-Synthetic
render split, `run/test_ft.py` on a grown JAX checkpoint, `run/render_vid.py`
with the GIF codec (`utils/gif.py`), and `train_ft` with gen_vid.

Inputs are made with numpy from seeds. LPIPS weights are random state
dicts in the lpips package's layout (the real files are drop-in
replacements with the same keys), at 64×80. Tolerances:

- LPIPS rtol 1e-4 against `lpips_jax.lpips_distance` (both float32; they
  sat 2e-7 apart when this was written, so no float64 referee is needed);
  the parameters both loaders read are equal.
- psnr, ssim and rmse of one folder equal to 1e-12 (the same float64
  numpy); LPIPS in `report_metrics` and `evaluate` at the bar above.
- Dataset poses and items within 1e-6 (the same numpy code).
- test_ft and render_vid: each float image within 1e-5 of JAX's (float32,
  another summation order), the mean PSNR within 1e-3 dB; the scores of
  the 8-bit PNGs within 1e-3 (a 1e-6 difference can cross a rounding edge
  of to8b).
- A GIF frame within `utils.gif.QUANT_BOUND` levels of its PNG per channel
  (decoded with Pillow and with the port's reader, which must agree).
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from pointnerf_tpu.data import create_dataset as jcreate
from pointnerf_tpu.run import common as jcommon
from pointnerf_tpu.run import evaluate as jevaluate
from pointnerf_tpu.run import render_vid as jrender_vid
from pointnerf_tpu.run import test_ft as jtest_ft
from pointnerf_tpu.run import train_ft as jdriver
from pointnerf_tpu.train import trainer as jtr
from pointnerf_tpu.utils import checkpoint as jckpt
from pointnerf_tpu.utils import lpips_jax
from pointnerf_tpu.utils import metrics as jmetrics
from pointnerf_tpu.utils.visualizer import Visualizer as JVisualizer
from pointnerf_tpu_torch.config import Options
from pointnerf_tpu_torch.data import create_dataset
from pointnerf_tpu_torch.data.nerf_synth360_ft import NerfSynth360FtDataset
from pointnerf_tpu_torch.run import evaluate, render_vid, test_ft, train_ft
from pointnerf_tpu_torch.utils import gif, lpips, metrics
from pointnerf_tpu_torch.utils.png import read_png, write_png
from pointnerf_tpu_torch.utils.visualizer import Visualizer

from fixtures import make_nerf_synth_scene
from test_train_ft_driver import tiny_train_opt

LPIPS_RTOL = 1e-4
IMG_TOL = dict(rtol=1e-5, atol=1e-5)
# lpips/pretrained_networks.py: conv keys at torchvision's feature indices
CONVS = {
    "alex": [("net.slice1.0", 64, 3, 11), ("net.slice2.3", 192, 64, 5),
             ("net.slice3.6", 384, 192, 3), ("net.slice4.8", 256, 384, 3),
             ("net.slice5.10", 256, 256, 3)],
    "vgg": [(f"net.slice{s}.{i}", co, ci, 3) for s, i, co, ci in (
        (1, 0, 64, 3), (1, 2, 64, 64), (2, 5, 128, 64), (2, 7, 128, 128),
        (3, 10, 256, 128), (3, 12, 256, 256), (3, 14, 256, 256),
        (4, 17, 512, 256), (4, 19, 512, 512), (4, 21, 512, 512),
        (5, 24, 512, 512), (5, 26, 512, 512), (5, 28, 512, 512))],
}


def lpips_state_dict(net, seed=0):
    """Random weights in lpips.LPIPS(net=net).state_dict()'s layout."""
    rng = np.random.RandomState(seed)
    t = lambda a: torch.tensor(np.asarray(a, np.float32))
    sd = {"scaling_layer.shift": t([-.030, -.088, -.188]).view(1, 3, 1, 1),
          "scaling_layer.scale": t([.458, .448, .450]).view(1, 3, 1, 1)}
    for name, co, ci, k in CONVS[net]:
        sd[name + ".weight"] = t(rng.randn(co, ci, k, k)
                                 * np.sqrt(2.0 / (ci * k * k)))
        sd[name + ".bias"] = t(rng.randn(co) * 0.05)
    taps = (64, 192, 384, 256, 256) if net == "alex" else \
        (64, 128, 256, 512, 512)
    for i, c in enumerate(taps):
        sd[f"lin{i}.model.1.weight"] = t(np.abs(rng.randn(1, c, 1, 1)) * 0.1)
    return sd


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    d = tmp_path_factory.mktemp("lpips")
    out = {}
    for net in ("alex", "vgg"):
        out[net] = str(d / f"lpips_{net}_full.pth")
        torch.save(lpips_state_dict(net, seed=len(net)), out[net])
    return out


def _pair(seed, H=64, W=80):
    rng = np.random.RandomState(seed)
    a = rng.rand(H, W, 3).astype(np.float32)
    return a, np.clip(a + rng.randn(H, W, 3).astype(np.float32) * 0.1, 0, 1)


@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_lpips_matches_jax(weights, net):
    params = lpips_jax.load_lpips_params(weights[net])
    model = lpips.load_lpips(weights[net], device="cpu")
    assert model.net_name == params["cfg"] == net
    convs = [m for m in model.net.modules()
             if isinstance(m, torch.nn.Conv2d)]
    assert len(convs) == len(params["convs"])
    for m, (w, b) in zip(convs, params["convs"]):
        np.testing.assert_array_equal(m.weight.numpy(), w)
        np.testing.assert_array_equal(m.bias.numpy(), b)
    for i, lin in enumerate(params["lins"]):
        np.testing.assert_array_equal(
            getattr(model, f"lin{i}").model[1].weight.numpy().reshape(-1),
            lin)
    np.testing.assert_array_equal(
        model.scaling_layer.shift.numpy().reshape(3), params["shift"])
    np.testing.assert_array_equal(
        model.scaling_layer.scale.numpy().reshape(3), params["scale"])
    for seed in (0, 1):
        a, b = _pair(seed)
        want = float(lpips_jax.lpips_distance(params, jnp.asarray(a),
                                              jnp.asarray(b)))
        got = float(model.distance(a, b))
        assert got > 0
        np.testing.assert_allclose(got, want, rtol=LPIPS_RTOL)
        assert float(model.distance(a, a)) < 1e-8
    fn = metrics.lpips_fn(weights[net], device="cpu")
    np.testing.assert_allclose(fn(a, b), want, rtol=LPIPS_RTOL)


def test_lpips_files_that_do_not_load_raise(tmp_path, weights):
    """No file: the metric is skipped (None). A missing file or one that is
    no lpips state dict raises, where the JAX package skips the metric."""
    assert metrics.lpips_fn(None, device="cpu") is None
    assert metrics.lpips_fn("", device="cpu") is None
    with pytest.raises(FileNotFoundError):
        metrics.lpips_fn(str(tmp_path / "missing.pth"), device="cpu")
    bad = tmp_path / "bad.pth"
    bad.write_bytes(b"not a torch file")
    assert lpips_jax.lpips_fn_jax(str(bad)) is None
    with pytest.raises(ValueError, match="does not load"):
        metrics.lpips_fn(str(bad), device="cpu")
    sd = lpips_state_dict("alex")
    del sd["lin2.model.1.weight"]
    torch.save(sd, tmp_path / "partial.pth")
    with pytest.raises(ValueError, match="lin2"):
        lpips.load_lpips(str(tmp_path / "partial.pth"), device="cpu")
    # the lpips package's lins.{i} aliases of the heads load
    sd = lpips_state_dict("alex")
    torch.save(sd, tmp_path / "plain.pth")
    sd.update({f"lins.{i}.model.1.weight": sd[f"lin{i}.model.1.weight"]
               for i in range(5)})
    torch.save(sd, tmp_path / "aliased.pth")
    a, b = _pair(2)
    dist = lambda f: float(lpips.load_lpips(str(tmp_path / f),
                                            "cpu").distance(a, b))
    assert dist("aliased.pth") == dist("plain.pth")


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("imgs"))
    for i in range(3):
        gt, img = _pair(10 + i, 48, 56)
        write_png(os.path.join(d, f"step-{i:04d}-gt_image.png"),
                  (gt * 255).astype(np.uint8))
        write_png(os.path.join(d, f"step-{i:04d}-coarse_raycolor.png"),
                  (img * 255).astype(np.uint8))
    return d


def _same_scores(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        rtol = LPIPS_RTOL if "lpips" in k else 1e-12
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)


def test_report_metrics_matches_jax(tmp_path, image_dir, weights):
    names = ("psnr", "ssim", "rmse", "lpips", "vgglpips")
    lw = {"lpips": weights["alex"], "vgglpips": weights["vgg"]}
    want = jmetrics.report_metrics(image_dir, image_dir, str(tmp_path / "j"),
                                   names, lpips_weights=lw)
    got = metrics.report_metrics(image_dir, image_dir, str(tmp_path / "t"),
                                 names, lpips_weights=lw, device="cpu")
    _same_scores(got, want)
    for k in names:
        np.testing.assert_allclose(np.loadtxt(tmp_path / "t" / f"{k}.txt"),
                                   np.loadtxt(tmp_path / "j" / f"{k}.txt"),
                                   rtol=LPIPS_RTOL if "lpips" in k else 1e-12)
    # no weights: LPIPS is skipped and recorded, as in the JAX package
    want = jmetrics.report_metrics(image_dir, image_dir, str(tmp_path / "j2"),
                                   ("psnr", "lpips", "vgglpips"))
    got = metrics.report_metrics(image_dir, image_dir, str(tmp_path / "t2"),
                                 ("psnr", "lpips", "vgglpips"), device="cpu")
    _same_scores(got, want)
    assert sorted(got) == ["psnr"]
    for d in ("j2", "t2"):
        text = (tmp_path / d / "scores.txt").read_text()
        assert "lpips: SKIPPED" in text and "vgglpips: SKIPPED" in text


def test_evaluate_cli_matches_jax(tmp_path, image_dir, weights, capsys):
    args = ["-i", image_dir, "-o", str(tmp_path / "j"), "-m", "psnr", "ssim",
            "rmse", "lpips", "vgglpips", "--lpips_alex_weights",
            weights["alex"], "--lpips_vgg_weights", weights["vgg"],
            "-l", "0", "2"]
    want = jevaluate.main(args)
    jout = capsys.readouterr().out
    args[3] = str(tmp_path / "t")
    got = evaluate.main(args + ["--device", "cpu"])
    tout = capsys.readouterr().out
    _same_scores(got, want)
    assert [ln.split(":")[0] for ln in tout.splitlines()] == \
        [ln.split(":")[0] for ln in jout.splitlines()]
    assert [ln for ln in tout.splitlines() if "lpips" not in ln] == \
        [ln for ln in jout.splitlines() if "lpips" not in ln]


@pytest.fixture(scope="module")
def scene_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scene"))
    make_nerf_synth_scene(root, wh=(40, 40))
    return root


def test_nerf_synth_render_split_matches_jax(scene_root, tmp_path):
    jopt = tiny_train_opt(scene_root, str(tmp_path))
    opt = Options.from_json(jopt.to_json())
    jds, tds = jcreate(jopt, split="render"), create_dataset(opt, "render")
    assert len(tds) == len(jds) == 20
    np.testing.assert_allclose(tds.render_poses, jds.render_poses,
                               rtol=1e-6, atol=1e-6)
    for i in (0, 7, 19):
        a = jds.get_dummyrot_item(i, np.random.RandomState(i))
        b = tds.get_dummyrot_item(i, np.random.RandomState(i))
        assert sorted(a) == sorted(b) and "gt_image" not in b
        for k in a:
            np.testing.assert_allclose(np.asarray(b[k], np.float64),
                                       np.asarray(a[k], np.float64),
                                       rtol=1e-6, atol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def grown_ckpt(scene_root, tmp_path_factory):
    """A JAX checkpoint whose point capacity differs from a fresh state's:
    the fixture's cloud (capacity 4096) grown by 3,500 candidates on the
    plate (the JAX driver's grow_from_candidates expands it to 8192), then
    three JAX train steps, saved by the JAX package at step 3."""
    out = str(tmp_path_factory.mktemp("ckpt"))
    jopt = tiny_train_opt(scene_root, out, test_num=2)
    key = jax.random.PRNGKey(jopt.seed)
    ds = jcreate(jopt, split="train")
    ts = jtr.create_train_state(
        jopt, key, jcommon.init_point_state_from_dataset(jopt, ds, key))
    cap0 = int(jtr.point_state_of(ts)["mask"].shape[0])
    rng = np.random.RandomState(4)
    n = 3500
    xyz = np.concatenate([rng.uniform(-0.4, 0.4, (n, 2)),
                          rng.normal(0, 0.01, (n, 1))], -1)
    dirs = rng.normal(size=(n, 3))
    cand = {"xyz": xyz, "embedding": rng.uniform(-0.5, 0.5, (n, 16)),
            "color": rng.rand(n, 3),
            "dir": dirs / np.linalg.norm(dirs, axis=-1, keepdims=True),
            "conf": np.full((n, 1), 0.4)}
    ts, dropped = jdriver.grow_from_candidates(
        ts, jopt, {k: v.astype(np.float32) for k, v in cand.items()})
    cap = int(jtr.point_state_of(ts)["mask"].shape[0])
    assert dropped == 0 and cap > cap0
    spec, grid = jcommon.make_spec_and_grid(jopt, jtr.point_state_of(ts))
    keys = ("raydir", "campos", "camrotc2w", "near", "far", "bg_color",
            "gt_image")
    brng = np.random.RandomState(9)
    for step in range(3):
        item = ds.get_item(step, rng=brng)
        ts, _ = jtr.train_step(ts, grid, {k: jnp.asarray(item[k])
                                          for k in keys}, key, jopt, spec)
    ckpt = os.path.join(out, jopt.experiment)
    jckpt.save_checkpoint(ckpt, 3, ts, jopt)
    return jopt.replace(resume_dir=ckpt), cap


class _Captured:
    """Records the float maps each Visualizer class is handed, keyed by
    (subdir, step), and saves them as before."""

    def __init__(self, monkeypatch, cls):
        self.maps = {}
        orig = cls.display_current_results

        def record(vis, visuals, step, subdir=""):
            self.maps[(subdir, step)] = {k: np.asarray(v)
                                         for k, v in visuals.items()}
            return orig(vis, visuals, step, subdir=subdir)
        monkeypatch.setattr(cls, "display_current_results", record)


def _same_maps(got, want, key="coarse_raycolor"):
    assert sorted(got) == sorted(want) and want
    for k in want:
        np.testing.assert_allclose(got[k][key], want[k][key], **IMG_TOL,
                                   err_msg=str(k))


def test_test_ft_reads_a_grown_jax_checkpoint(grown_ckpt, weights, tmp_path,
                                              monkeypatch):
    """Both test_ft.mains load the grown checkpoint (JAX through its
    expand_capacity retry, the port from the file's shapes) and score the
    test split with LPIPS alex and vgg."""
    jopt, cap = grown_ckpt
    jopt = jopt.replace(lpips_alex_path=weights["alex"],
                        lpips_vgg_path=weights["vgg"])
    jcap, tcap = _Captured(monkeypatch, JVisualizer), \
        _Captured(monkeypatch, Visualizer)
    want = jtest_ft.main(jopt.replace(checkpoints_dir=str(tmp_path / "j")))
    opt = Options.from_json(jopt.replace(
        checkpoints_dir=str(tmp_path / "t")).to_json())
    got = test_ft.main(opt, device="cpu")
    assert got["step"] == want["step"] == 3
    _same_maps(tcap.maps, jcap.maps)
    assert abs(got["psnr"] - want["psnr"]) < 1e-3
    assert sorted(got["scores"]) == sorted(want["scores"]) == \
        ["lpips", "psnr", "rmse", "ssim", "vgglpips"]
    for k, v in want["scores"].items():
        np.testing.assert_allclose(got["scores"][k], v, rtol=1e-3, err_msg=k)
    assert os.path.exists(tmp_path / "t" / opt.experiment / "images" /
                          "test_3" / "scores.txt")
    from pointnerf_tpu_torch.utils.checkpoint import load_checkpoint
    ts, _ = load_checkpoint(opt.resume_dir, opt, device="cpu")
    assert ts.points["mask"].shape[0] == cap


def test_render_vid_matches_jax(grown_ckpt, tmp_path, monkeypatch):
    """The port's frames equal JAX's before 8-bit; its GIF holds the 20
    frames within the palette bound of their PNGs."""
    jopt, _ = grown_ckpt
    jcap, tcap = _Captured(monkeypatch, JVisualizer), \
        _Captured(monkeypatch, Visualizer)
    want = jrender_vid.main(jopt.replace(checkpoints_dir=str(tmp_path / "j")))
    opt = Options.from_json(jopt.replace(
        checkpoints_dir=str(tmp_path / "t")).to_json())
    got = render_vid.main(opt, device="cpu")
    assert got["n_frames"] == want["n_frames"] == 20
    _same_maps(tcap.maps, jcap.maps)
    assert got["video"].endswith(".gif") and \
        os.path.getsize(got["video"]) > 1000
    frame_dir = os.path.join(str(tmp_path / "t"), opt.experiment, "images",
                             "vid_3")
    mine = gif.read_gif(got["video"])
    with Image.open(got["video"]) as im:
        assert im.n_frames == len(mine) == 20
        for i in range(20):
            im.seek(i)
            pil = np.asarray(im.convert("RGB"))
            np.testing.assert_array_equal(mine[i], pil)
            png = read_png(os.path.join(frame_dir,
                                        f"step-{i:04d}-coarse_raycolor.png"))
            assert np.abs(pil.astype(int) - png.astype(int)).max() \
                <= gif.QUANT_BOUND


def test_gif_codec_round_trip(tmp_path):
    """Frames of at most 256 colors come back exactly; a frame of many
    colors within QUANT_BOUND; the LZW coder across table resets."""
    rng = np.random.RandomState(0)
    few = rng.randint(0, 256, (40, 3))[rng.randint(0, 40, (30, 50))]
    many = rng.randint(0, 256, (30, 50, 3))
    frames = [few.astype(np.uint8), many.astype(np.uint8)]
    gif.write_gif(str(tmp_path / "a.gif"), frames, fps=10)
    back = gif.read_gif(str(tmp_path / "a.gif"))
    np.testing.assert_array_equal(back[0], frames[0])
    err = np.abs(back[1].astype(int) - frames[1].astype(int)).max()
    assert 0 < err <= gif.QUANT_BOUND
    with Image.open(tmp_path / "a.gif") as im:
        assert im.n_frames == 2 and im.info["loop"] == 0
        assert im.info["duration"] == 100
    data = rng.randint(0, 256, 20000).astype(np.uint8).tobytes()
    assert gif.lzw_decode(gif.lzw_encode(data)) == data
    with pytest.raises(ValueError):
        gif.write_gif(str(tmp_path / "b.gif"), [frames[0].astype(np.float32)])


def test_train_ft_gen_vid(scene_root, tmp_path, monkeypatch):
    """train_ft with gen_vid 1 ends with the render path's GIF (and the
    nonstop alias is the same driver); a dataset with no render split skips
    it with a line in the log."""
    from pointnerf_tpu_torch.run import train_ft_nonstop
    assert train_ft_nonstop.main is train_ft.main
    opt = Options.from_json(tiny_train_opt(
        scene_root, str(tmp_path), maximum_step=2, prune_iter=0, prob_freq=0,
        save_iter_freq=100, save_point_freq=0, test_num=1,
        gen_vid=1).to_json())
    res = train_ft.main(opt, device="cpu")
    assert len(gif.read_gif(res["video"])) == 20
    monkeypatch.delattr(NerfSynth360FtDataset, "get_dummyrot_item")
    res = train_ft.main(opt.replace(experiment="no_render", maximum_step=1),
                        device="cpu")
    assert res["video"] is None
    log = open(os.path.join(str(tmp_path), "no_render", "log.txt")).read()
    assert "gen_vid skipped" in log
