"""The finetune driver with the MVS point init (load_points 0) against the
JAX driver: the cloud each `main` starts from, and the failure both share
when the init's embeddings are not point_features_dim wide.

The JAX driver draws its MVS weights from PRNGKey(seed) (split once, as
its gen_points_filter_embeddings does); the port's main is handed the same
weights where it calls gen_points_filter_embeddings. Each `main`'s starting cloud is caught where it
meets `trainer.create_train_state`, and the cloud before the voxel
downsample where it meets `construct_vox_points_closest`. Tolerances: the
count before the downsample exactly; xyz, embedding, color, dir and conf
rtol = atol = 1e-4 (conv stacks in another summation order, as
tests/test_torch_port_mvs.py states). Named ties of the downsample, which
keeps the point nearest each voxel's centroid: a point within those
differences of a voxel face may land in the next voxel (the voxels it
touches are left out of the final comparison), and two points whose
distances to a centroid differ by less than those differences can move
them may swap as the winner (in a voxel of two points both are equally
near, so rounding alone picks one).
"""

import functools

import numpy as np
import jax
import pytest

from pointnerf_tpu.models.mvs import points_model as jpm
from pointnerf_tpu.run import common as jcommon
from pointnerf_tpu.run import train_ft as jdriver
from pointnerf_tpu.train import trainer as jtr
from pointnerf_tpu_torch.config import Options
from pointnerf_tpu_torch.run import common as tcommon
from pointnerf_tpu_torch.run import train_ft as tdriver
from pointnerf_tpu_torch.train import trainer as ttr
from pointnerf_tpu_torch.utils.checkpoint import from_jax_mvs_params

from fixtures import make_nerf_synth_scene
from test_train_ft_driver import tiny_train_opt

NET_TOL = dict(rtol=1e-4, atol=1e-4)
STEPS = 30


class _Stop(Exception):
    pass


@pytest.fixture(scope="module")
def scene64(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scene64"))
    make_nerf_synth_scene(root, wh=(64, 64), n_train=6, n_test=2)
    return root


def mvs_opt(root, out, **kw):
    """tiny_train_opt on 64×64 views with the MVS init (MVSNet over 24
    depth planes, the 63 → 16 premlp, no conf threshold: random weights
    never reach the preset's 0.8), STEPS steps, no prune or probe."""
    return tiny_train_opt(
        root, out, load_points=0, img_wh=(64, 64), depth_grid=24,
        depth_conf_thresh=0.0,
        shading_feature_mlp_layer0=1, maximum_step=STEPS, prune_iter=0,
        prob_freq=0, save_iter_freq=STEPS, save_point_freq=0,
        test_num=1).replace(**kw)


def jax_mvs_params(jopt):
    _, sub = jax.random.split(jax.random.PRNGKey(jopt.seed))
    return jax.tree.map(np.asarray, jpm.init_mvs_points_params(sub, jopt))


def use_jax_weights(jopt, opt, monkeypatch):
    """The port's main runs its MVS init with JAX's weights."""
    mvs = from_jax_mvs_params(jax_mvs_params(jopt), opt, device="cpu")
    monkeypatch.setattr(tdriver, "gen_points_filter_embeddings",
                        functools.partial(tcommon.gen_points_filter_embeddings,
                                          mvs=mvs))


def _vox_spy(module, caught, name, monkeypatch):
    real = module.construct_vox_points_closest

    def spy(xyz, vox_res, ranges=None):
        out = real(xyz, vox_res, ranges)
        caught[name] = (np.array(xyz), out[1])
        return out

    monkeypatch.setattr(module, "construct_vox_points_closest", spy)


def _voxels(xyz, vox_res):
    """construct_vox_points_closest's voxel of each point."""
    xyz = np.asarray(xyz, np.float64)
    mn = xyz.min(0)
    vsize = np.maximum(xyz.max(0) - mn, 1e-9).max() / vox_res
    return np.floor((xyz - mn) / vsize).astype(np.int64)


def test_driver_starts_from_the_jax_mvs_cloud(scene64, tmp_path,
                                              monkeypatch):
    """Both mains start from the same MVS cloud (up to the named tie); the
    port's then trains STEPS steps and its loss falls."""
    jopt = mvs_opt(scene64, str(tmp_path / "jax"))
    caught = {}

    def jax_spy(opt, key, point_state):
        caught["jax"] = jax.tree.map(np.asarray, point_state)
        raise _Stop

    monkeypatch.setattr(jtr, "create_train_state", jax_spy)
    _vox_spy(jcommon, caught, "jax_vox", monkeypatch)
    _vox_spy(tcommon, caught, "port_vox", monkeypatch)
    with pytest.raises(_Stop):
        jdriver.main(jopt)

    opt = Options.from_json(mvs_opt(scene64, str(tmp_path / "port"))
                            .to_json())
    create, step = ttr.create_train_state, ttr.train_step
    losses = []

    def port_spy(opt_, point_state, gen):
        caught["port"] = {k: v.numpy().copy() for k, v in point_state.items()
                          if v is not None}
        return create(opt_, point_state, gen)

    def step_spy(*a, **kw):
        ts, items = step(*a, **kw)
        losses.append(float(items["loss_total"]))
        return ts, items

    monkeypatch.setattr(ttr, "create_train_state", port_spy)
    monkeypatch.setattr(ttr, "train_step", step_spy)
    use_jax_weights(jopt, opt, monkeypatch)
    res = tdriver.main(opt, device="cpu")

    # the hull's output: the same rows, at tolerance
    (jxyz, jidx), (txyz, tidx) = caught["jax_vox"], caught["port_vox"]
    assert len(txyz) == len(jxyz) > 500
    np.testing.assert_allclose(txyz, jxyz, **NET_TOL)
    # the downsample: JAX's on the port's input picks the port's points
    np.testing.assert_array_equal(
        jcommon.construct_vox_points_closest(txyz, jopt.vox_res)[1], tidx)
    # the final clouds, voxel by voxel, but for the named ties
    jv, tv = _voxels(jxyz, jopt.vox_res), _voxels(txyz, jopt.vox_res)
    face = np.any(jv != tv, axis=-1)
    touched = {tuple(v) for v in np.concatenate([jv[face], tv[face]])}
    jwin = {tuple(jv[i]): i for i in jidx if tuple(jv[i]) not in touched}
    twin = {tuple(tv[i]): i for i in tidx if tuple(tv[i]) not in touched}
    assert set(jwin) == set(twin)
    flips = [v for v in jwin if jwin[v] != twin[v]]
    # a distance tie: the two winners' distances to the voxel's centroid
    # differ by less than the inputs' differences can move them (each
    # point and the centroid by at most eps per axis)
    eps = float(np.abs(txyz - jxyz).max())
    for v in flips:
        members = jxyz[np.all(jv == v, axis=-1)].astype(np.float64)
        c = members.mean(0)
        dj, dt = (np.linalg.norm(jxyz[i] - c) for i in (jwin[v], twin[v]))
        assert abs(dj - dt) <= 4 * np.sqrt(3) * eps, (v, dj, dt, eps)
    same = [v for v in jwin if jwin[v] == twin[v]]
    assert len(same) > 0.8 * len(jidx), (len(same), len(jidx))
    want, got = caught["jax"], caught["port"]
    assert got["mask"].sum() == len(tidx) and want["mask"].sum() == len(jidx)
    jrows = np.searchsorted(jidx, [jwin[v] for v in same])
    trows = np.searchsorted(tidx, [twin[v] for v in same])
    for k in ("xyz", "embedding", "color", "dir", "conf"):
        np.testing.assert_allclose(got[k][trows], want[k][jrows], err_msg=k,
                                   **NET_TOL)
    assert res["total_steps"] == STEPS and len(losses) == STEPS
    assert np.mean(losses[-10:]) < 0.8 * np.mean(losses[:10]), losses
    assert int(res["state"].points["mask"].sum()) == len(tidx)


def test_mvs_init_without_premlp_fails_in_both(scene64, tmp_path,
                                              monkeypatch):
    """shading_feature_mlp_layer0 0: the embeddings are the raw 56 FPN
    channels, not point_features_dim (16). JAX fails in its first train
    step with a TypeError; the port refuses the cloud with a ValueError
    that names the option."""
    jopt = mvs_opt(scene64, str(tmp_path / "jax"),
                   shading_feature_mlp_layer0=0, maximum_step=1)
    with pytest.raises(TypeError, match="dot_general"):
        jdriver.main(jopt)
    opt = Options.from_json(mvs_opt(scene64, str(tmp_path / "port"),
                                    shading_feature_mlp_layer0=0).to_json())
    with pytest.raises(ValueError, match="56-wide"):
        tdriver.main(opt, device="cpu")
    use_jax_weights(jopt, opt, monkeypatch)
    with pytest.raises(ValueError, match="shading_feature_mlp_layer0"):
        tdriver.main(opt, device="cpu")
