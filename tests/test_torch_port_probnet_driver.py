"""The drivers with the ProbNet point init (manual_depth_view -1) against
the JAX package's: the finetune driver from a ProbNet cloud (load_points
0); dtu_gen and dtu_inf, which fail in both packages (dtu's bundles hold
4 views, ProbNet takes 3); `{steps}_gen.npz` carrying ProbNet's
parameters and Adam moments both ways (the shapes of
test_torch_port_probnet.py: 64x64, depth_grid 16).

Tolerances: the finetune's final PSNR within 1.5 dB of JAX's (the two
clouds come from different draws), as the other driver tests; checkpoint
leaves exactly.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pointnerf_tpu.data import create_dataset as jcreate
from pointnerf_tpu.run import train as jtrain
from pointnerf_tpu.run import train_ft as jdriver
from pointnerf_tpu.utils.checkpoint import load_pytree_npz, save_pytree_npz
from pointnerf_tpu_torch.config import Options
from pointnerf_tpu_torch.run import common as tcommon
from pointnerf_tpu_torch.run import train as ttrain
from pointnerf_tpu_torch.run import train_ft as tdriver
from pointnerf_tpu_torch.utils.checkpoint import (from_jax_mvs_params,
                                                  load_gen_npz, save_gen_npz)

from fixtures import make_dtu_scene, make_nerf_synth_scene
from test_generalizable import gen_opt
from test_torch_port_generalizable import _item, _jbatch, _states, _tbatch
from test_torch_port_mvs_driver import jax_mvs_params
from test_train_ft_driver import tiny_train_opt

STEPS = 30
PROBNET = dict(manual_depth_view=-1, depth_grid=16, pad=8, num_neighbor=3)


@pytest.fixture(scope="module")
def dtu_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dtu_probnet"))
    make_dtu_scene(root, n_views=6, wh=(64, 64))
    return root


def test_finetune_from_probnet_matches_jax(tmp_path_factory, monkeypatch):
    """train_ft.main with load_points 0 and manual_depth_view -1 in both
    packages (the port with JAX's weights; the depth range cut to the
    plate's, 2.5-3.5, as for random MVS weights): both train STEPS steps
    from a ProbNet cloud, and the port's final PSNR is within 1.5 dB of
    JAX's."""
    root = str(tmp_path_factory.mktemp("probnet_ft"))
    make_nerf_synth_scene(root, wh=(64, 64), n_train=6, n_test=2)
    out = str(tmp_path_factory.mktemp("probnet_ft_out"))
    jopt = tiny_train_opt(
        root, out, load_points=0, img_wh=(64, 64), dprob_thresh=0.15,
        near_plane=2.5, far_plane=3.5, shading_feature_mlp_layer0=1,
        maximum_step=STEPS, prune_iter=0, prob_freq=0, save_iter_freq=STEPS,
        save_point_freq=0, test_num=1, experiment="probnet_jax", **PROBNET)
    want = jdriver.main(jopt)
    opt = Options.from_json(jopt.replace(experiment="probnet_port")
                            .to_json())
    mvs = from_jax_mvs_params(jax_mvs_params(jopt), opt, device="cpu")
    assert mvs.probnet is not None
    monkeypatch.setattr(tdriver, "gen_points_filter_embeddings",
                        functools.partial(tcommon.gen_points_filter_embeddings,
                                          mvs=mvs))
    got = tdriver.main(opt, device="cpu")
    assert got["total_steps"] == STEPS
    assert int(got["state"].points["mask"].sum()) > 20
    assert abs(got["final_psnr"] - want["final_psnr"]) < 1.5, \
        (got["final_psnr"], want["final_psnr"])


def test_dtu_gen_and_inference_with_probnet_fail_in_both(dtu_root):
    """dtu's feed-forward bundles hold 3 source views and the target, 4
    views: ProbNet's cost volume has 44 channels where its U-Net takes 41.
    JAX's gen_train_step and gen_eval_step fail in the conv; the port's
    gen_train_step, infer_item and main raise ValueError naming
    manual_depth_view."""
    jopt = gen_opt(dtu_root, dprob_thresh=0.15, **PROBNET)
    st, ts, topt = _states(jopt)
    assert "probnet" in st.mvs_train and ts.mvs.probnet is not None
    item, sample = _item(jopt)
    assert sample["mvs_images"].shape[0] == 4
    jds = jcreate(jopt, split="train")
    spec_j = jtrain.make_render_spec(jopt, jds, 64 * 64)
    spec_t = ttrain.make_render_spec(topt, jds, 64 * 64)
    with pytest.raises(ValueError, match="44 // 1 != 41"):
        jtrain.gen_train_step(st, jtrain.sample_to_device(sample),
                              _jbatch(item), jax.random.PRNGKey(7), jopt,
                              spec_j)
    with pytest.raises(ValueError, match="44 // 1 != 41"):
        jtrain.gen_eval_step(st, jtrain.sample_to_device(sample),
                             _jbatch(item), jax.random.PRNGKey(7), jopt,
                             spec_j)
    with pytest.raises(ValueError, match="manual_depth_view -1"):
        ttrain.gen_train_step(ts, sample, _tbatch(item), topt, spec_t)
    test_item, test_sample = _item(jopt, split="test", full_img=True)
    with pytest.raises(ValueError, match="manual_depth_view -1"):
        ttrain.infer_item(ts, topt, spec_t,
                          dict(test_item, mvs_sample=test_sample))
    with pytest.raises(ValueError, match="manual_depth_view -1"):
        ttrain.main(topt.replace(maximum_step=1), device="cpu")


def test_gen_npz_with_probnet_both_ways(dtu_root, tmp_path):
    """A JAX GenTrainState with ProbNet, its MVS chain's moments random
    (the BatchNorm statistics', which take no gradient, stay 0) and its
    count 3 (no JAX step runs with ProbNet on dtu's bundles):
    JAX's save_pytree_npz → the port's load_gen_npz → save_gen_npz →
    JAX's load_pytree_npz gives every leaf back, ProbNet's parameters,
    statistics and moments included."""
    jopt = gen_opt(dtu_root, dprob_thresh=0.15, **PROBNET)
    st, _, topt = _states(jopt)
    rng = np.random.RandomState(4)

    def rand_like(path, x):
        x = np.asarray(x)
        if x.dtype == np.int32:
            return jnp.asarray(np.int32(3))
        if jax.tree_util.keystr(path).endswith(("['mean']", "['var']")):
            return jnp.asarray(x)        # statistics take no gradient
        return jnp.asarray(rng.rand(*x.shape).astype(x.dtype))

    st = st._replace(opt_state_mvs=jax.tree_util.tree_map_with_path(
        rand_like, st.opt_state_mvs), step=jnp.asarray(1, jnp.int32))
    p1, p2 = str(tmp_path / "1_gen.npz"), str(tmp_path / "2_gen.npz")
    save_pytree_npz(p1, st)
    ts = load_gen_npz(p1, topt, device="cpu")
    assert ts.mvs.probnet is not None and ts.step == 1
    save_gen_npz(p2, ts)
    back = load_pytree_npz(p2, st)
    a, b = jax.tree_util.tree_leaves_with_path(st), \
        jax.tree_util.tree_leaves_with_path(back)
    assert len(a) == len(b)
    n_probnet = 0
    for (path, x), (_, y) in zip(a, b):
        name = jax.tree_util.keystr(path)
        n_probnet += "probnet" in name
        np.testing.assert_array_equal(np.asarray(y), np.asarray(x),
                                      err_msg=name)
    assert n_probnet > 3 * 11 * 3    # parameters, statistics, two moments
