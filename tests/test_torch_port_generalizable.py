"""Generalizable (feed-forward) driver parity: the port's `run/train.py`
against the JAX package's, on tests/fixtures.py::make_dtu_scene at 64x64
with the options of tests/test_generalizable.py (MVSNet BatchNorm
statistics randomised).

The JAX state is carried across with `utils/checkpoint.from_jax_gen_state`;
the render draws (the depth jitter, the shpnt_jitter) are JAX's, injected.
Tolerances: forward outputs rtol = atol = 1e-5, gradients and updated
parameters rtol 2e-4 / atol 2e-5, masks and counters exactly.

The FPN on batch statistics: on the plate's uniform background JAX's
float32 FPN is further off the float64 FPN than the 1e-5 bar, so
the tests of what follows it feed JAX's feature values into the port's FPN
(`_jax_features`: the port's backward stays its own), and hold the FPN's
own features and weight gradients to the float64 FPN: no further off than
twice JAX's distance (test_torch_port_gen_train.py, which holds the
training tests and shares this file's helpers). Named ties: the MVS
tests' rows of image-border pixels (their projection into their own view
is in or out of bounds by rounding).
"""

import contextlib
import copy
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointnerf_tpu.data import create_dataset as jcreate
from pointnerf_tpu.models.losses import compute_losses as jlosses
from pointnerf_tpu.models.mvs import nets as jnets
from pointnerf_tpu.models.renderer import render_forward as jrender
from pointnerf_tpu.ops.grid import build_grid as jbuild_grid
from pointnerf_tpu.run import train as jtrain
from pointnerf_tpu.utils.checkpoint import save_pytree_npz
from pointnerf_tpu_torch.config import Options
from pointnerf_tpu_torch.run import train as ttrain
from pointnerf_tpu_torch.utils.checkpoint import (_conv_keys,
                                                  _mvs_torch_tensors,
                                                  from_jax_gen_state,
                                                  load_gen_npz)

from fixtures import make_dtu_scene
from test_generalizable import gen_opt
from test_torch_port_mvs import _border_rows, randomize_bn

TOL = dict(rtol=1e-5, atol=1e-5)
FRUSTUM = dict(wcoord_query=0, z_depth_dim=16, vscale=(2, 2, 1), P=16,
               radius_limit_scale=0.0, depth_limit_scale=0.0,
               shpnt_jitter="uniform")


@pytest.fixture(scope="module")
def dtu_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dtu_gen"))
    make_dtu_scene(root, n_views=6, wh=(64, 64))
    return root


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _states(jopt, seed=0):
    """A JAX GenTrainState with random MVSNet BatchNorm statistics, and the
    port's copy of it."""
    st = jtrain.create_gen_state(jopt, jax.random.PRNGKey(seed))
    frozen = randomize_bn(_np(st.mvs_frozen), np.random.RandomState(seed))
    st = st._replace(mvs_frozen=jax.tree.map(jnp.asarray, frozen))
    topt = Options.from_json(jopt.to_json())
    return st, from_jax_gen_state(_np(st), topt, device="cpu"), topt


def _item(jopt, split="train", idx=0, **kw):
    ds = jcreate(jopt, split=split)
    item = ds.get_item(idx, rng=np.random.RandomState(idx), **kw)
    return item, item.pop("mvs_sample")


def _jbatch(item):
    return {k: jnp.asarray(v) for k, v in item.items()
            if k in ("raydir", "campos", "camrotc2w", "near", "far",
                     "bg_color", "gt_image")}


def _tbatch(item):
    return ttrain.batch_of(item, "cpu")


def _jax_grads(st, sample, batch, key, opt, spec):
    """JAX's gen_train_step loss and gradients (its loss_fn, as
    gen_train_step_impl differentiates it)."""
    k_pts, k_render = jax.random.split(key)
    sample = jtrain.sample_to_device(sample)

    def loss_fn(agg, mvs_train):
        ps = jtrain.feedforward_point_state(dict(mvs_train, **st.mvs_frozen),
                                            opt, sample, k_pts)
        grid = None if opt.wcoord_query == 0 else \
            jbuild_grid(ps["xyz"], ps["mask"], spec)
        out = jrender(agg, ps, grid, spec, opt, batch, k_render,
                      is_train=True)
        return jlosses(opt, out, batch["gt_image"])

    (_, items), grads = jax.value_and_grad(loss_fn, argnums=(0, 1),
                                           has_aux=True)(st.agg_params,
                                                         st.mvs_train)
    return items, grads, k_render


def _draws(opt, k_render, R):
    if opt.wcoord_query == 0:
        return torch.as_tensor(np.asarray(
            jax.random.uniform(k_render, (1, R, opt.SR))))
    return torch.as_tensor(np.asarray(
        jax.random.uniform(k_render, (1, R, opt.z_depth_dim))))


def _check_params(tstate, jstate, tol, fpn_tol=None):
    """The port's aggregator and trainable MVS parameters against a JAX
    GenTrainState's (or gradient trees, by name); `fpn_tol(name, got,
    want)`, if given, checks the FPN's in place of `tol`."""
    agg, mvs = jstate
    for name, p in tstate.aggregator.named_parameters():
        b, pos, kind = name.split(".")
        want = np.asarray(agg[b][int(pos) // 2]["w" if kind == "weight"
                                                else "b"])
        want = want.T if kind == "weight" else want
        np.testing.assert_allclose(_n(p), want, err_msg=name, **tol)
    flat = _mvs_torch_tensors(_np(mvs))
    for name, p in tstate.mvs_params().items():
        if name.startswith("featurenet.") and fpn_tol is not None:
            fpn_tol(name, _n(p), flat[name])
        else:
            np.testing.assert_allclose(_n(p), flat[name], err_msg=name,
                                       **tol)


def _n(t):
    return t.detach().cpu().numpy()


def _jax_fpn(st, sample):
    return [np.asarray(a) for a in jnets.fpn_featurenet(
        st.mvs_train["featurenet"], jnp.asarray(sample["mvs_images"]), True)]


@contextlib.contextmanager
def _jax_features(ts, feats, cotangents=None):
    """The port's FPN returns JAX's feature values (`feats`, a list per
    call, or a callable giving it) while its backward stays the port's:
    each output o becomes o + (jax − o).detach(). JAX's float32 FPN is
    further off the float64 FPN than the 1e-5 bar the rows after it are
    held to (test_fpn_batch_statistics_matches_jax). The
    cotangents reaching the outputs are appended to `cotangents`."""
    net = ts.mvs.featurenet
    plain = type(net).forward

    def forward(imgs, batch_stats=False):
        want = feats() if callable(feats) else feats
        outs = [o + (torch.as_tensor(w) - o).detach()
                for o, w in zip(plain(net, imgs, batch_stats), want)]
        if cotangents is not None and torch.is_grad_enabled():
            grads = [None] * len(outs)
            cotangents.append(grads)
            for i, o in enumerate(outs[1:], 1):
                o.register_hook(lambda g, i=i: grads.__setitem__(i, g))
        return outs

    net.forward = forward
    try:
        yield
    finally:
        del net.forward


def _fpn_errors(net, imgs, cot, want):
    """Max-norm errors against the float64 FPN (the port's, in double) of
    a float32 run `want` = (features, {param: grad}) for the output
    cotangents `cot` (None entries skip an output): each relative to the
    float64 value's largest magnitude."""
    f64 = copy.deepcopy(net).double()
    outs = f64(torch.as_tensor(imgs, dtype=torch.float64), batch_stats=True)
    pairs = [(o, torch.as_tensor(c).double())
             for o, c in zip(outs[1:], cot[1:]) if c is not None]
    loss = sum((o * c).sum() for o, c in pairs)
    names, params = zip(*f64.named_parameters())
    grads = torch.autograd.grad(loss, params)
    feats, g32 = want
    err = {f"x{i}": float(np.abs(_n(o) - np.asarray(w)).max()
                          / np.abs(_n(o)).max())
           for i, (o, w) in enumerate(zip(outs[1:], feats[1:]), 1)}
    for k, g in zip(names, grads):
        err[k] = float(np.abs(_n(g) - np.asarray(g32[k])).max()
                       / max(np.abs(_n(g)).max(), 1e-30))
    return err


def _jax_fpn_grads(p, imgs, cot):
    """JAX's FPN features and its parameter gradients (torch names) for the
    output cotangents `cot`."""
    def f(p):
        outs = jnets.fpn_featurenet(p, jnp.asarray(imgs), True)
        return sum(jnp.sum(o * jnp.asarray(np.asarray(c)))
                   for o, c in zip(outs[1:], cot[1:]) if c is not None), outs
    (_, outs), g = jax.value_and_grad(f, has_aux=True)(p)
    flat = {}
    _conv_keys(_np(g), "", flat)
    return [np.asarray(o) for o in outs], flat


class _Grads:
    """Gradient dicts by name, shaped like a GenTrainState's parameters."""

    def __init__(self, g_net, g_mvs):
        self.aggregator = type("A", (), {"named_parameters":
                                         lambda s: g_net.items()})()
        self._mvs = g_mvs

    def mvs_params(self):
        return self._mvs


@pytest.mark.parametrize("kw", [pytest.param({}, id="world"),
                                pytest.param(FRUSTUM, id="frustum")])
def test_feedforward_point_state_matches_jax(dtu_root, kw):
    """gen_points with the FPN on batch statistics (behavior 1) → the point
    state: mask exactly, the rest at 1e-5 on the kept rows off the image
    border."""
    jopt = gen_opt(dtu_root, **kw)
    st, ts, topt = _states(jopt)
    _, sample = _item(jopt)
    want = _np(jtrain.feedforward_point_state(
        dict(st.mvs_train, **st.mvs_frozen), jopt,
        jtrain.sample_to_device(sample), jax.random.PRNGKey(1)))
    with torch.no_grad(), _jax_features(ts, _jax_fpn(st, sample)):
        got = ttrain.feedforward_point_state(ts.mvs, topt, sample)
    np.testing.assert_array_equal(_n(got["mask"]), want["mask"])
    rows = want["mask"] & ~_border_rows(len(want["mask"]), 64, 64)
    assert rows.sum() > 1000
    for k in ("xyz", "embedding", "color", "dir", "conf"):
        np.testing.assert_allclose(_n(got[k])[rows], want[k][rows],
                                   err_msg=k, **TOL)
    np.testing.assert_array_equal(_n(got["xyz"])[~want["mask"]],
                                  want["xyz"][~want["mask"]])


@pytest.mark.parametrize("kw", [pytest.param({}, id="world"),
                                pytest.param(FRUSTUM, id="frustum"),
                                pytest.param(dict(FRUSTUM, SR_budget=1792,
                                                  k_tier=0),
                                             id="frustum-budget")])
def test_feedforward_inference_image_matches_jax(dtu_root, kw):
    """Behavior 2: JAX's inference loop (gen_eval_step per chunk, the points
    and the frustum grid rebuilt for each) against the port's infer_item
    (points once per item, the grid once per image, render_image): the
    same image within 1e-5. With a budget, one that no chunk of JAX's
    overflows: JAX drops the rows past it, where render_image renders
    them again up its ladder."""
    jopt = gen_opt(dtu_root, maximum_step=0, random_sample_size=16, **kw)
    st, ts, topt = _states(jopt)
    item, sample = _item(jopt, split="test", idx=1, full_img=True)
    jds = jcreate(jopt, split="test")
    spec_j = jtrain.make_render_spec(jopt, jds, 64 * 64)
    spec_t = ttrain.make_render_spec(topt, jds, 64 * 64)
    want = np.zeros((64, 64, 3), np.float32)
    pix = item["pixel_idx"][0].astype(np.int64)
    chunk = 16 ** 2
    jsample = jtrain.sample_to_device(sample)
    for s in range(0, 64 * 64, chunk):
        sub = dict(item, raydir=item["raydir"][:, s:s + chunk])
        out = jtrain.gen_eval_step(st, jsample, _jbatch(sub),
                                   jax.random.PRNGKey(0), jopt, spec_j)
        assert int(out["sr_overflow"]) == 0
        want[pix[s:s + chunk, 1], pix[s:s + chunk, 0]] = np.asarray(
            out["coarse_raycolor"][0])
    stats = {}
    got = ttrain.infer_item(ts, topt, spec_t, dict(item, mvs_sample=sample),
                            stats=stats)
    np.testing.assert_allclose(got, want, **TOL)
    assert stats["n_points"] > 1000 and stats["sr_overflow"] == 0
    assert (got != 0).any()


def test_inference_reads_jax_checkpoint(dtu_root, tmp_path):
    """main with maximum_step 0 in both packages from one JAX-written
    {steps}_gen.npz: the same PSNR per item; manual_std_depth > 0
    raises."""
    jopt = gen_opt(dtu_root, out=str(tmp_path), maximum_step=0,
                   random_sample_size=32, **FRUSTUM)
    st, _, topt = _states(jopt)
    ckpt = os.path.join(str(tmp_path), jopt.experiment)
    os.makedirs(ckpt)
    save_pytree_npz(os.path.join(ckpt, "5_gen.npz"), st)
    want = jtrain.inference(jopt, max_images=2)
    got = ttrain.main(topt.replace(experiment=jopt.experiment), device="cpu")
    assert got["n"] == 6 and want["n"] == 2
    np.testing.assert_allclose(np.mean(got["psnrs"][:2]), want["psnr"],
                               rtol=1e-4)
    with pytest.raises(ValueError, match="manual_std_depth"):
        ttrain.inference(topt.replace(manual_std_depth=0.1), device="cpu")


def test_dtu_gen_default_ranges_refuse_the_grid(dtu_root):
    """dtu_gen's ±100 ranges make a 50,005³-voxel world grid (neither
    package can build its tables): the port raises naming `ranges`, and
    the spec equals JAX's."""
    from pointnerf_tpu.config import dtu_gen_preset as jpreset
    from pointnerf_tpu_torch.config import dtu_gen_preset
    from pointnerf_tpu_torch.ops.grid import build_grid
    topt = dtu_gen_preset().replace(data_root=dtu_root, img_wh=(64, 64))
    ds = ttrain.create_dataset(topt, "train")
    spec = ttrain.make_render_spec(topt, ds, ttrain.point_slots(topt))
    want = jtrain.make_render_spec(jpreset().replace(data_root=dtu_root,
                                                     img_wh=(64, 64)),
                                   ds, ttrain.point_slots(topt))
    assert spec.__dict__ == want.__dict__
    assert spec.vdim == (50005, 50005, 50005)
    with pytest.raises(ValueError, match="ranges"):
        build_grid(torch.zeros(4, 3), torch.ones(4, dtype=torch.bool), spec)


def test_gen_entry_points_default_to_the_card(dtu_root):
    """The feed-forward entry points place their state on the card unless
    told otherwise; without one the default raises, with no fallback."""
    import inspect
    for fn in (ttrain.create_gen_state, ttrain.inference, ttrain.main,
               load_gen_npz, from_jax_gen_state):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present, so the default does not raise")
    with pytest.raises((AssertionError, RuntimeError)):
        ttrain.create_gen_state(Options.from_json(gen_opt(dtu_root)
                                                  .to_json()))
