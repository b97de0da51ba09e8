"""Train steps, checkpoints and the finetune driver under the aggregator's
other shading envelopes, against the JAX package.

`compute_grads` at distance mode 30, `sh_intrp`, `gau_intrp`, order 0,
`block2` and bfloat16 with the compaction and K-tiering on (loss items
rtol 1e-5, gradients rtol 2e-4 / atol 2e-5; bfloat16 at BF16_REL of the
largest entry, test_torch_port_envelopes.py); `block2` and order-0 states
through the checkpoint files both ways; the driver (`run/train_ft.py`) at
mode 30 (the fused trunk's 4-wide distances) and `sh_intrp` for a few
dozen steps on the fixture's plate scene, final test PSNR within the 1.5
dB the other driver tests allow (the two drivers draw their batches and
jitter from different random streams).
"""

import os

import numpy as np
import jax
import pytest
import torch

from pointnerf_tpu.models import neural_points as jnpc
from pointnerf_tpu.ops.grid import build_grid, make_grid_spec
from pointnerf_tpu.run import train_ft as jdriver
from pointnerf_tpu.train import trainer as jtr
from pointnerf_tpu.utils import checkpoint as jckpt
from pointnerf_tpu_torch.config import Options
from pointnerf_tpu_torch.ops import kernels
from pointnerf_tpu_torch.run import train_ft as tdriver
from pointnerf_tpu_torch.train import trainer as ttr
from pointnerf_tpu_torch.utils import checkpoint as tckpt
from pointnerf_tpu_torch.utils.checkpoint import _net_tensors

from fixtures import make_nerf_synth_scene
from test_end_to_end import make_gt
from test_k_tier import sparse_setup
from test_torch_port_envelopes import BF16_REL, WIDE, _rel_err
from test_torch_port_train import (GRAD_TOL, LOSS_TOL, _close_grads,
                                   _close_items, _np_tree, _port, _uniform)
from test_train_ft_driver import tiny_train_opt


def _scene(**kw):
    """test_k_tier's sparse plate (neighbor counts 0..K, so the K-tier split
    is live) at WIDE point channels, with the auto budget that drops rows,
    K-tiering on and some confs outside the clamp."""
    opt, state, _, _, batch, xyz = sparse_setup(R_side=10)
    opt = opt.replace(**dict(dict(
        superset_P=16, SR_budget=-1, k_tier=-1, K=8,
        shading_feature_mlp_layer1=2, shading_feature_mlp_layer3=2,
        point_features_dim=WIDE, occ_segments=-1, use_fused_trunk=1), **kw))
    n = len(xyz)
    rng = np.random.RandomState(4)
    conf = np.asarray(state["conf"])[:n].copy()
    conf[::7] = 1.3
    conf[3::11] = 5e-5
    state = jnpc.create_point_cloud(
        xyz, rng.uniform(-0.5, 0.5, (n, WIDE)).astype(np.float32),
        np.asarray(state["color"])[:n], np.asarray(state["dir"])[:n], conf)
    spec = make_grid_spec(opt, points_min=xyz.min(0), points_max=xyz.max(0),
                          max_points=n)
    grid = build_grid(state["xyz"], state["mask"], spec)
    ts = jtr.create_train_state(opt, jax.random.PRNGKey(2), state)
    gt, _ = make_gt(batch)
    return opt, ts, spec, grid, dict(batch, gt_image=gt)


TRAIN_CASES = {
    "pers30": dict(agg_dist_pers=30),
    "sh_intrp": dict(agg_distance_kernel="sh_intrp", use_fused_trunk=0),
    "gau_intrp": dict(agg_distance_kernel="gau_intrp", use_fused_trunk=0),
    "order0": dict(agg_intrp_order=0, point_color_mode="0",
                   point_dir_mode="0", use_fused_trunk=0),
    "block2": dict(shading_feature_mlp_layer2=1, num_feat_freqs=0,
                   use_fused_trunk=0),
}


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_train_step_matches_jax(case):
    """compute_grads with the compaction and K-tiering on: loss items at
    1e-5, every gradient at the bars; the rows past the auto budget drop
    alike."""
    opt, ts, spec, grid, batch = _scene(**TRAIN_CASES[case])
    key = jax.random.PRNGKey(5)
    want, jn, jp = jtr.compute_grads(ts, grid, batch, key, opt, spec)
    st, spec_t, grid_t, tb = _port(opt, ts, batch)
    B, R = batch["raydir"].shape[:2]
    u = torch.tensor(_uniform(key, B, R, opt.z_depth_dim))
    items, g_net, g_pts = ttr.compute_grads(st, grid_t, tb, opt, spec_t, u)
    assert float(want["sr_overflow"]) > 0
    assert float(items["sr_overflow"]) == float(want["sr_overflow"])
    _close_items(items, want, **LOSS_TOL)
    _close_grads(g_net, g_pts, jn, jp, **GRAD_TOL)


def test_bf16_train_step_matches_jax():
    """The bfloat16 train step (K-tiering and the compaction on): loss
    items and gradients at BF16_REL of their largest entry."""
    opt, ts, spec, grid, batch = _scene(compute_dtype="bfloat16")
    key = jax.random.PRNGKey(5)
    want, jn, jp = jtr.compute_grads(ts, grid, batch, key, opt, spec)
    st, spec_t, grid_t, tb = _port(opt, ts, batch)
    B, R = batch["raydir"].shape[:2]
    u = torch.tensor(_uniform(key, B, R, opt.z_depth_dim))
    items, g_net, g_pts = ttr.compute_grads(st, grid_t, tb, opt, spec_t, u)
    for k, v in want.items():
        assert _rel_err(float(items[k].detach()), float(v)) < BF16_REL, k
    for k, v in _net_tensors(_np_tree(jn)).items():
        assert _rel_err(g_net[k].numpy(), v) < BF16_REL, k
    for k, v in jp.items():
        assert _rel_err(g_pts[k].numpy(), v) < BF16_REL, k
    assert not any(k.launches for k in kernels.KERNELS)


@pytest.mark.parametrize("case", ["block2", "order0"])
def test_checkpoints_carry_block2_and_order0(case, tmp_path):
    """JAX state → port → {iter}_full.npz and the reference export → JAX,
    equal leaf for leaf; and JAX's checkpoint back into the port."""
    opt, ts, _, _, _ = _scene(**TRAIN_CASES[case])
    popt = Options.from_json(opt.to_json())
    st = tckpt.from_jax_train_state(_np_tree(ts), popt, device="cpu")
    assert st.aggregator.has("block2") == (case == "block2")
    d = str(tmp_path / "port")
    tckpt.save_checkpoint(d, 3, st, popt)
    template = jtr.create_train_state(opt, jax.random.PRNGKey(9),
                                      jtr.point_state_of(ts))
    loaded, _ = jckpt.load_checkpoint(d, template)
    for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(ts)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    agg, _ = jckpt.import_reference_dict(
        dict(np.load(f"{d}/3_net_ray_marching.npz")), opt)
    for a, b in zip(jax.tree.leaves(agg), jax.tree.leaves(ts.agg_params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    d2 = str(tmp_path / "jax")
    jckpt.save_checkpoint(d2, 3, ts, opt, 0.0, 0)
    back, _ = tckpt.load_checkpoint(d2, popt, device="cpu")
    flat, ref = tckpt.train_state_arrays(back), tckpt.train_state_arrays(st)
    assert sorted(flat) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(flat[k], ref[k], err_msg=k)


@pytest.fixture(scope="module")
def scene_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("env_scene"))
    make_nerf_synth_scene(root)
    return root


@pytest.mark.parametrize("case", ["pers30", "sh_intrp"])
def test_driver_under_envelope_matches_jax(case, scene_root, tmp_path):
    kw = {"pers30": dict(agg_dist_pers=30),
          "sh_intrp": dict(agg_distance_kernel="sh_intrp", sh_degree=3)}[case]
    jopt = tiny_train_opt(scene_root, os.path.join(tmp_path, "j"),
                          maximum_step=60, prune_iter=0, prob_freq=0,
                          save_iter_freq=60, save_point_freq=0, test_num=1,
                          **kw)
    want = jdriver.main(jopt)
    got = tdriver.main(Options.from_json(jopt.replace(
        checkpoints_dir=os.path.join(tmp_path, "t")).to_json()),
        device="cpu")
    assert got["total_steps"] == want["total_steps"] == 60
    assert np.isfinite(got["final_psnr"]) and got["final_psnr"] > 10.0
    assert abs(got["final_psnr"] - want["final_psnr"]) < 1.5, \
        (got["final_psnr"], want["final_psnr"])
