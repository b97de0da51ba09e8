"""The headless viewer (`run/visualize.py`) against the JAX package's: the
checkpoint and dump readers, the PLY's bytes, the splat (duplicate pixels
and depth ties among them) pixel for pixel, the turntable and growth
frames, and `main` with --ply, the turntable and --grow, on the CPU.
Everything exactly: the splat's products are float32 ops whose rounding
both packages share on these inputs.
"""

import os

import numpy as np
import pytest

from pointnerf_tpu.run import visualize as jvz
from pointnerf_tpu_torch.run import visualize as tvz
from pointnerf_tpu_torch.utils.png import read_png


def _cloud(seed=2):
    rng = np.random.RandomState(seed)
    n = 400
    xyz = rng.randn(n, 3).astype(np.float32) * 0.5
    rgb = rng.rand(n, 3).astype(np.float32)
    # duplicates: copies of the first 40 points in other colours (the same
    # pixels, depth ties), and 40 more on a single pixel's ray at two depths
    xyz[40:80] = xyz[:40]
    xyz[80:120] = xyz[120] * np.where(np.arange(40) % 2, 1.0, 1.5)[:, None]
    return xyz.astype(np.float32), rgb


def _save(path, xyz, rgb, conf):
    np.savez(path, **{"neural_points.xyz": xyz[None],
                      "neural_points.points_color": rgb[None],
                      "neural_points.points_conf": conf[None, :, None]})


def test_readers_and_ply_match_jax(tmp_path):
    xyz, rgb = (a[:50] for a in _cloud())
    conf = np.random.RandomState(3).rand(50).astype(np.float32)
    _save(tmp_path / "7_net_ray_marching.npz", xyz, rgb * 1.3, conf)
    _save(tmp_path / "3_net_ray_marching.npz", xyz, rgb, conf * 0)
    for args in ((str(tmp_path),), (str(tmp_path), 3),
                 (str(tmp_path / "7_net_ray_marching.npz"), None, 0.5)):
        for a, b in zip(tvz.load_point_cloud(*args),
                        jvz.load_point_cloud(*args)):
            np.testing.assert_array_equal(a, b)
    txt = str(tmp_path / "10.txt")
    np.savetxt(txt, np.concatenate([xyz, rgb * 255, conf[:, None]], -1),
               fmt="%.6f")
    for a, b in zip(tvz.load_points_txt(txt), jvz.load_points_txt(txt)):
        np.testing.assert_array_equal(a, b)
    tvz.write_ply(str(tmp_path / "t.ply"), xyz, rgb)
    jvz.write_ply(str(tmp_path / "j.ply"), xyz, rgb)
    assert (tmp_path / "t.ply").read_bytes() == \
        (tmp_path / "j.ply").read_bytes()


@pytest.mark.parametrize("point_size", [1, 2, 3])
def test_splat_matches_jax(point_size):
    """Pixel for pixel at several poses, with duplicate pixels (points
    sharing a window, copies at equal depth) and the background kept."""
    xyz, rgb = _cloud()
    center, radius = jvz.frame_cloud(xyz)
    for az in (0.0, 1.1, 4.0):
        c2w = jvz.orbit_pose(center, radius, az)
        np.testing.assert_array_equal(tvz.orbit_pose(center, radius, az), c2w)
        want = jvz.splat_render(xyz, rgb, c2w, 48, 40, 45.0, point_size)
        got = tvz.splat_render(xyz, rgb, c2w, 48, 40, 45.0, point_size,
                               device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)
        assert (want == 1.0).all(-1).any() and (want != 1.0).any()
    # culling and occlusion (JAX's own case): the near green point wins
    c2w = np.eye(4, dtype=np.float32)
    pts = np.array([[0, 0, -2.0], [0, 0, -1.0], [0, 0, 1.0]], np.float32)
    cols = np.eye(3, dtype=np.float32)
    got = tvz.splat_render(pts, cols, c2w, 33, 33, 30.0, 1, device="cpu")
    np.testing.assert_array_equal(got.numpy(), jvz.splat_render(
        pts, cols, c2w, 33, 33, 30.0, 1))
    np.testing.assert_array_equal(got.numpy()[16, 16], [0, 1, 0])


def test_turntable_and_grow_frames_match_jax(tmp_path):
    """render_turntable's PNG frames equal JAX's, pixel for pixel; the
    growth frames equal JAX's splats of each dump at its pose; the GIFs
    exist."""
    xyz, rgb = _cloud()
    vid = tvz.render_turntable(xyz, rgb, str(tmp_path / "t"), n_frames=4,
                               size=32, device="cpu")
    jvz.render_turntable(xyz, rgb, str(tmp_path / "j"), n_frames=4, size=32)
    assert vid.endswith("turntable.gif") and os.path.exists(vid)
    for i in range(4):
        name = f"frame-{i:04d}.png"
        np.testing.assert_array_equal(read_png(str(tmp_path / "t" / name)),
                                      read_png(str(tmp_path / "j" / name)))
    pts = tmp_path / "points"
    pts.mkdir()
    for k, s in enumerate((5, 50, 100)):
        n = 100 * (k + 1)
        np.savetxt(pts / f"{s}.txt", np.concatenate(
            [xyz[:n], rgb[:n] * 255], -1), fmt="%.6f")
    vid = tvz.render_grow(str(pts), str(tmp_path / "g"), size=32,
                          device="cpu")
    assert vid.endswith("grow.gif") and os.path.exists(vid)
    center, radius = jvz.frame_cloud(jvz.load_points_txt(
        str(pts / "100.txt"))[0])
    focal = 32 / (2.0 * np.tan(np.deg2rad(50.0) / 2.0))
    for i, s in enumerate((5, 50, 100)):
        x, c = jvz.load_points_txt(str(pts / f"{s}.txt"))
        want = jvz.splat_render(x, c, jvz.orbit_pose(center, radius,
                                                     np.pi * i / 3),
                                32, 32, focal, 2)
        np.testing.assert_array_equal(
            read_png(str(tmp_path / "g" / f"grow-{i:04d}.png")),
            (np.clip(want, 0, 1) * 255).astype(np.uint8))
    assert tvz.render_grow(str(tmp_path / "t"), str(tmp_path / "x"),
                           device="cpu") is None


def test_main_ply_turntable_grow(tmp_path):
    xyz, rgb = (a[:200] for a in _cloud())
    conf = np.linspace(0, 1, 200).astype(np.float32)
    _save(tmp_path / "5_net_ray_marching.npz", xyz, rgb, conf)
    pts = tmp_path / "points"
    pts.mkdir()
    np.savetxt(pts / "1.txt", np.concatenate([xyz, rgb * 255], -1),
               fmt="%.6f")
    ply = str(tmp_path / "c.ply")
    out = tvz.main(["--checkpoint", str(tmp_path), "--ply", ply,
                    "--out", str(tmp_path / "vis"), "--n_frames", "3",
                    "--size", "24", "--grow", str(pts), "--device", "cpu"])
    assert out["n_points"] == int((conf > 0.1).sum())
    jvz.write_ply(str(tmp_path / "j.ply"),
                  *jvz.load_point_cloud(str(tmp_path))[:2])
    assert open(ply, "rb").read() == (tmp_path / "j.ply").read_bytes()
    for key in ("turntable", "grow"):
        assert os.path.exists(out[key]), key
    assert os.path.exists(tmp_path / "vis" / "frame-0002.png")
    with pytest.raises(SystemExit):
        tvz.main(["--device", "cpu"])
