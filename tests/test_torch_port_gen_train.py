"""Generalizable training parity (split from
test_torch_port_generalizable.py, whose helpers it shares): the FPN on
batch statistics and its weight gradients against float64, gen_train_step
against the JAX package's over three steps, `{steps}_gen.npz` both ways,
and the port's driver training the FPN and not MVSNet, on
tests/fixtures.py::make_dtu_scene at 64x64.

Tolerances: loss items rtol = atol = 1e-5; gradients and updated
parameters rtol 2e-4 / atol 2e-5. On the plate's uniform background JAX's
float32 FPN is further off the float64 FPN than the 1e-5 bar, so the FPN's
own features and weight gradients are held to the float64 FPN: no further
off than twice JAX's distance (`test_fpn_batch_statistics_matches_jax`).
Named ties: FPN weights whose gradient lies within rounding of 0, where
Adam's first step lr·g/(|g| + eps) takes either sign
(`test_gen_train_steps_match_jax`). Both FPN tests run torch at
FPN_THREADS: the CPU convolution's weight gradient moves with the thread
count (ROADMAP §3).
"""

import os

import numpy as np
import jax
import pytest
import torch

from pointnerf_tpu.data import create_dataset as jcreate
from pointnerf_tpu.run import train as jtrain
from pointnerf_tpu.utils.checkpoint import load_pytree_npz, save_pytree_npz
from pointnerf_tpu_torch.config import Options
from pointnerf_tpu_torch.run import train as ttrain
from pointnerf_tpu_torch.utils.checkpoint import (_conv_keys, load_gen_npz,
                                                  save_gen_npz)

from fixtures import make_dtu_scene
from test_generalizable import gen_opt
from test_torch_port_generalizable import (TOL, _check_params, _draws,
                                           _fpn_errors, _Grads, _item,
                                           _jax_features, _jax_fpn,
                                           _jax_fpn_grads, _jax_grads,
                                           _jbatch, _n, _np, _states,
                                           _tbatch)
from test_torch_port_threads import torch_threads

GTOL = dict(rtol=2e-4, atol=2e-5)
TIE_REL, TIE_ABS = 1e-4, 1e-6   # FPN weights with a gradient this near 0
                                # (see test_gen_train_steps_match_jax)
FPN_THREADS = 4    # torch's pool in the FPN gradient tests: oneDNN's CPU
                   # conv sums the weight gradient over the image in one
                   # partial sum per thread, so conv0.1's gradient against
                   # float64 on the textured views moves with the count
                   # (2.23e-5 at 1 thread, 1.33e-5 at 2, 2.9e-6 at 4 and 8)


@pytest.fixture(scope="module")
def dtu_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dtu_gen_train"))
    make_dtu_scene(root, n_views=6, wh=(64, 64))
    return root


@pytest.fixture
def fpn_threads():
    """The FPN's float32 weight gradients at FPN_THREADS threads, whatever
    the worker's count."""
    with torch_threads(FPN_THREADS):
        yield


@pytest.mark.parametrize("textured", [False, True])
def test_fpn_batch_statistics_matches_jax(dtu_root, textured, fpn_threads):
    """The FPN on batch statistics (behavior 1): features and the weight
    gradients of a random cotangent, the port's and JAX's, each against
    the float64 FPN. On the plate's images (a uniform white background)
    normalising near-constant channels amplifies rounding: JAX's float32
    run is further off than 1e-5 of the largest value, and the port must
    be no further off than twice JAX's distance. On textured images (noise
    added to the same views) the port stays within 1e-5 of float64."""
    jopt = gen_opt(dtu_root)
    st, ts, _ = _states(jopt)
    imgs = _item(jopt)[1]["mvs_images"]
    if textured:
        noise = np.random.RandomState(5).rand(*imgs.shape)
        imgs = np.clip(imgs + 0.2 * noise, 0, 1).astype(np.float32)
    rng = np.random.RandomState(6)
    feats = _jax_fpn(st, {"mvs_images": imgs})
    cot = [None] + [rng.normal(size=f.shape).astype(np.float32)
                    for f in feats[1:]]
    jfeats, jgrads = _jax_fpn_grads(st.mvs_train["featurenet"], imgs, cot)
    net = ts.mvs.featurenet
    outs = net(torch.as_tensor(imgs), batch_stats=True)
    names, params = zip(*net.named_parameters())
    loss = sum((o * torch.as_tensor(c)).sum() for o, c in zip(outs[1:],
                                                               cot[1:]))
    tgrads = dict(zip(names, (_n(g) for g in torch.autograd.grad(loss,
                                                                 params))))
    port = _fpn_errors(net, imgs, cot, ([_n(o) for o in outs], tgrads))
    theirs = _fpn_errors(net, imgs, cot, (jfeats, jgrads))
    for k in port:
        assert port[k] <= 2 * theirs[k] + 1e-6, (k, port[k], theirs[k])
        if textured:
            assert port[k] <= 1e-5, (k, port[k])
    if not textured:
        assert max(theirs.values()) > 1e-5


@pytest.mark.parametrize("alter_step", [0, 2])
def test_gen_train_steps_match_jax(dtu_root, alter_step, fpn_threads):
    """One step's loss items and gradients of the aggregator, the FPN and
    the premlp; then three gen_train_steps (alter_step 2: two render-net
    steps, then an MVS one) with JAX's draws: the parameters after each
    Adam update, and MVSNet untouched."""
    jopt = gen_opt(dtu_root, alter_step=alter_step, mvs_lr=0.002)
    st, ts, topt = _states(jopt)
    item, sample = _item(jopt)
    jb, tb = _jbatch(item), _tbatch(item)
    jds = jcreate(jopt, split="train")
    spec_j = jtrain.make_render_spec(jopt, jds, 64 * 64)
    spec_t = ttrain.make_render_spec(topt, jds, 64 * 64)
    key = jax.random.PRNGKey(7)
    items, grads, k_render = _jax_grads(st, sample, jb, key, jopt, spec_j)
    u = _draws(jopt, k_render, 64)
    cot = []
    with _jax_features(ts, lambda: _jax_fpn(st, sample), cot):
        t_items, g_net, g_mvs = ttrain.gen_compute_grads(ts, sample, tb,
                                                         topt, spec_t, u)
    for k, v in items.items():
        np.testing.assert_allclose(float(t_items[k]), float(v), err_msg=k,
                                   **TOL)
    # the FPN's weight gradients: as close to the float64 FPN's (for the
    # cotangents its outputs received) as JAX's are
    imgs = sample["mvs_images"]
    feats = _jax_fpn(st, sample)
    fp = {k[len("featurenet."):]: _n(g) for k, g in g_mvs.items()
          if k.startswith("featurenet.")}
    port_err = _fpn_errors(ts.mvs.featurenet, imgs, cot[0], (feats, fp))
    jflat = {}
    _conv_keys(_np(grads[1]["featurenet"]), "", jflat)
    jax_err = _fpn_errors(ts.mvs.featurenet, imgs, cot[0], (feats, jflat))

    def fpn_tol(name, got, want):
        k = name[len("featurenet."):]
        assert port_err[k] <= 2 * jax_err[k] + 1e-5, (k, port_err[k],
                                                      jax_err[k])
    _check_params(_Grads(g_net, g_mvs), grads, GTOL, fpn_tol)
    assert any(float(g.abs().max()) > 0 for g in g_mvs.values())

    # then three steps: the aggregator and the premlp after every Adam
    # update. The FPN's weights after the MVS chain's first update only:
    # that update is lr·g/(|g| + 1e-8), equal to JAX's but where g lies
    # within its rounding of 0 (a named tie: |g| under TIE_REL of the
    # weight's largest or under TIE_ABS, at most 2% of the elements; Adam's
    # eps makes the update there a fraction of lr); later updates
    # divide moments element by element, so an element's float32 gradient
    # error (JAX's own is held above) becomes an
    # error of that share of lr, past the parameter bar
    mvsnet0 = {k: v.clone() for k, v in ts.mvs.mvsnet.state_dict().items()}
    mvs_updates = 0
    for i in range(3):
        key, sub = jax.random.split(key)
        feats = _jax_fpn(st, sample)
        fpn_tol = lambda name, got, want: None
        phase = (i // alter_step) % 2 if alter_step else 1
        if phase == 1 and mvs_updates == 0:
            _, g, _ = _jax_grads(st, sample, jb, sub, jopt, spec_j)
            ties = {}
            _conv_keys(_np(g[1]["featurenet"]), "featurenet.", ties)
            ties = {k: np.abs(v) < max(TIE_REL * np.abs(v).max(), TIE_ABS)
                    for k, v in ties.items()}
            n_ties = sum(int(t.sum()) for t in ties.values())
            assert n_ties <= 2e-2 * sum(t.size for t in ties.values())

            def fpn_tol(name, got, want):
                ok = ~ties[name]
                np.testing.assert_allclose(got[ok], want[ok], err_msg=name,
                                           **GTOL)
        mvs_updates += phase == 1
        st, _ = jtrain.gen_train_step(st, jtrain.sample_to_device(sample),
                                      jb, sub, jopt, spec_j)
        _, k_render = jax.random.split(sub)
        with _jax_features(ts, feats):
            ts, _ = ttrain.gen_train_step(ts, sample, tb, topt, spec_t,
                                          _draws(jopt, k_render, 64))
        _check_params(ts, (st.agg_params, st.mvs_train), GTOL, fpn_tol)
    assert ts.step == int(st.step) == 3 and mvs_updates >= 1
    for k, v in ts.mvs.mvsnet.state_dict().items():
        assert torch.equal(v, mvsnet0[k]), k


def test_gen_npz_loads_both_ways(dtu_root, tmp_path):
    """After a JAX step (nonzero moments): JAX's save_pytree_npz → the
    port's load_gen_npz → save_gen_npz → JAX's load_pytree_npz gives every
    leaf back, BatchNorm statistics and both Adam states included."""
    jopt = gen_opt(dtu_root)
    st, _, topt = _states(jopt)
    item, sample = _item(jopt)
    spec = jtrain.make_render_spec(jopt, jcreate(jopt, split="train"),
                                   64 * 64)
    st, _ = jtrain.gen_train_step(st, jtrain.sample_to_device(sample),
                                  _jbatch(item), jax.random.PRNGKey(3), jopt,
                                  spec)
    p1, p2 = str(tmp_path / "1_gen.npz"), str(tmp_path / "2_gen.npz")
    save_pytree_npz(p1, st)
    ts = load_gen_npz(p1, topt, device="cpu")
    assert ts.step == 1
    save_gen_npz(p2, ts)
    back = load_pytree_npz(p2, st)
    a, b = jax.tree_util.tree_leaves_with_path(st), \
        jax.tree_util.tree_leaves_with_path(back)
    assert len(a) == len(b)
    for (path, x), (_, y) in zip(a, b):
        np.testing.assert_array_equal(np.asarray(y), np.asarray(x),
                                      err_msg=jax.tree_util.keystr(path))
    with pytest.raises(ValueError, match="aggregator"):
        load_gen_npz(p2, topt.replace(shading_feature_num=16), device="cpu")


def test_gen_driver_trains_the_fpn_not_mvsnet(dtu_root, tmp_path):
    """The port's main on the CPU: 4 steps, a finite loss, a 4_gen.npz;
    the FPN and premlp moved, MVSNet did not."""
    topt = Options.from_json(gen_opt(dtu_root, out=str(tmp_path),
                                     maximum_step=4, save_iter_freq=4)
                             .to_json())
    res = ttrain.main(topt, device="cpu")
    assert res["total_steps"] == 4
    assert np.isfinite(res["last_items"]["loss_total"])
    assert os.path.exists(os.path.join(str(tmp_path), topt.experiment,
                                       "4_gen.npz"))
    fresh = ttrain.create_gen_state(topt, device="cpu")
    st = res["state"]
    for k, v in st.mvs.mvsnet.state_dict().items():
        assert torch.equal(v, fresh.mvs.mvsnet.state_dict()[k]), k
    moved = [float((p - fresh.mvs_params()[k]).abs().max())
             for k, p in st.mvs_params().items()]
    assert max(moved) > 0
