"""The fused trunk's bfloat16 form (`--trunk_dtype bfloat16`): K1b's and
K2b's plain versions against the JAX Pallas kernels compiled with
bf16=True, run in interpret mode; the rule that decides where the form
runs; and the lego train step under it against JAX's.

Every product of the bf16 form rounds its operands to bfloat16 and sums in
float32. Two float32 sums taken in another order differ by an ulp, and an
ulp ahead of a bfloat16 rounding flips that operand by one bfloat16 ulp
(2^-8 of it), so a handful of entries sit far further apart than the rest:
the port is held by quantiles of |port - JAX| / max|JAX| over each output
instead of an elementwise allclose. Measured on this file's cases on a
CPU: forward median 0, p99 <= 1.4e-7, max 1.3e-6; gradients median <=
2.4e-8, p99 <= 2.2e-7, max 1.0e-6; the train step's gradients median <=
2e-7, max 5.7e-7, its loss items 1.1e-7 apart (JAX's own float32 step:
gradient medians up to 1.8e-3, loss 1.3e-4). With more rows the tail
grows: a 4-layer chain at 4,096 rows reached a max of 2e-3. Bars: forward
median 1e-6, p99 1e-4, max 5e-3; gradients median 1e-5 (p99 and max as
forward); loss items rtol 1e-5. A plain version with the float32
products, or with the PE projections rounded as well, sits at medians of
1.8e-4 to 7.4e-3 (the negative controls), so the median bar pins the
rounding sites; the p99 and max bars hold the tail.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointnerf_tpu.ops import pallas_trunk as jt
from pointnerf_tpu.train import trainer as jtr
from pointnerf_tpu_torch.config import Options
from pointnerf_tpu_torch.models import aggregator as tagg
from pointnerf_tpu_torch.ops import kernels
from pointnerf_tpu_torch.ops import pe as tpe
from pointnerf_tpu_torch.ops import trunk as tt
from pointnerf_tpu_torch.train import trainer as ttr
from pointnerf_tpu_torch.utils.checkpoint import _net_tensors

from test_torch_port_envelopes import ORDER, _inputs, _opt, _pair
from test_torch_port_train import _np_tree, _port, _scene, _uniform
from test_torch_port_trunk import INPUTS, _cotangents, _setup

FWD_BARS = dict(median=1e-6, p99=1e-4, max=5e-3)
GRAD_BARS = dict(median=1e-5, p99=1e-4, max=5e-3)

# (K, L1, L3, order, act_super): both orders, L1 and L3 in {1, 2}, both
# alpha activations (order 2 only: order 1's alpha head runs outside)
CASES = [(8, 2, 2, 2, True), (8, 1, 2, 2, False), (1, 2, 1, 2, True),
         (8, 1, 1, 1, True), (1, 2, 2, 1, False)]
_JAX = {}


def _quantiles(got, want):
    """(median, p99, max) of |got - want| / max |want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    r = np.abs(got - want).ravel() / (np.abs(want).max() + 1e-30)
    return dict(median=float(np.median(r)), p99=float(np.quantile(r, 0.99)),
                max=float(r.max()))


def _misses(got, want, bars):
    """The bars the quantiles of got against want exceed."""
    q = _quantiles(got, want)
    return {k: q[k] for k in bars if not q[k] <= bars[k]}


def _jax_bf16(case):
    """JAX's bf16 kernels in interpret mode: (feat, alpha, the gradients of
    <feat, cf> + <alpha, ca> with respect to the row inputs and every
    operand), once per case."""
    if case not in _JAX:
        K, L1, L3, order, act = case
        _, params, _, ins = _setup(L1, L3, order, K)
        order1 = order == 1
        cf, ca = _cotangents(K, ins["emb"].shape[0], order1)
        run = lambda *a: jt.fused_trunk(L1, L3, 2, 3, K, act, 16 * K, True,
                                        True, order1, *a)

        def f(emb, d, ex3, w, ops):
            feat, alpha = run(emb, d, ex3, w, ops)
            loss = jnp.sum(feat * cf)
            return loss if order1 else loss + jnp.sum(alpha * ca)
        ops = jt.pack_trunk_params(params, 8, 6, 2, 3, with_alpha=not order1)
        xs = [jnp.asarray(ins[k]) for k in INPUTS]
        out = run(*xs, ops)
        g = jax.grad(f, argnums=(0, 1, 2, 3, 4))(*xs, ops)
        _JAX[case] = (out, list(g[:4]) + list(g[4]))
    return _JAX[case]


def _port_bf16(case, bf16=True):
    """The port's fused_trunk (plain versions) on the case's inputs: (feat,
    alpha, gradients in JAX's order)."""
    K, L1, L3, order, act = case
    _, _, agg, ins = _setup(L1, L3, order, K)
    order1 = order == 1
    cf, ca = _cotangents(K, ins["emb"].shape[0], order1)
    xs = [torch.tensor(ins[k], requires_grad=True) for k in INPUTS]
    ops = tt.pack_trunk_params(agg, 8, 6, 2, 3, with_alpha=not order1)
    feat, alpha = tt.fused_trunk(L1, L3, 2, 3, K, act, order1, *xs, ops,
                                 bf16=bf16)
    loss = torch.sum(feat * torch.tensor(cf))
    if not order1:
        loss = loss + torch.sum(alpha * torch.tensor(ca))
    grads = torch.autograd.grad(loss, xs + ops)
    return (feat.detach(), None if alpha is None else alpha.detach()), grads


def _all_misses(case, bf16=True):
    """{output: missed bars} of the port's plain versions against JAX's
    bf16 kernels; empty when every output is within its bars."""
    (want, gwant), (got, ggot) = _jax_bf16(case), _port_bf16(case, bf16)
    out = {}
    for i, (a, b) in enumerate(zip(got, want)):
        assert (a is None) == (b is None)
        if a is not None and _misses(a, b, FWD_BARS):
            out[f"out{i}"] = _misses(a, b, FWD_BARS)
    assert len(ggot) == len(gwant)
    for i, (a, b) in enumerate(zip(ggot, gwant)):
        if _misses(a, b, GRAD_BARS):
            out[f"grad{i}"] = _misses(a, b, GRAD_BARS)
    return out


@pytest.mark.parametrize("case", CASES, ids=lambda c: "K{}-L{}{}-o{}-{}".format(
    *c[:4], "softplus" if c[4] else "relu"))
def test_plain_bf16_matches_pallas_bf16_interpret(case):
    """fused_trunk_reference and fused_trunk_bwd_reference with bf16
    against the Pallas kernels with bf16=True: forward and every gradient
    within the quantile bars; no kernel launches on CPU tensors."""
    assert _all_misses(case) == {}
    assert kernels.TRUNK_FWD_BF16.launches == kernels.TRUNK_BWD_BF16.launches \
        == 0


@pytest.mark.parametrize("control", ["float32", "pe_rounded"])
def test_negative_controls_break_the_median_bar(control, monkeypatch):
    """The float32 products, and the bf16 form with the PE projections'
    input rounded too, each miss a median bar against JAX's bf16 kernel:
    the bars tell the rounding sites apart."""
    case = CASES[0]
    if control == "pe_rounded":
        plain = tpe.pe_args
        monkeypatch.setattr(tt, "pe_args",
                            lambda x, f: plain(x.bfloat16().float(), f))
    misses = _all_misses(case, bf16=control == "pe_rounded")
    assert any("median" in m for m in misses.values()), misses


def _route_opt(**kw):
    """A lego-envelope aggregator (fused_trunk_ok and fused_shade_ok) at
    small widths, the fused trunk on unless kw says otherwise."""
    return Options.from_json(_opt(**dict(dict(use_fused_trunk=-1),
                                         **kw)).to_json())


def _record(monkeypatch, forms):
    """Append the bf16 flag of every fused_trunk_reference call to forms."""
    plain = tt.fused_trunk_reference

    def reference(*a, **k):
        forms.append(bool(k.get("bf16", a[12] if len(a) > 12 else False)))
        return plain(*a, **k)
    monkeypatch.setattr(tt, "fused_trunk_reference", reference)


def _aggregate(opt, per_point=False):
    _, agg = _pair(_opt())
    ins = _inputs(_opt())
    if per_point:
        B, R, SR, K = ins["mask"].shape
        rot = np.linalg.qr(np.random.RandomState(4).normal(size=(3, 3)))[0]
        ins["rw2c"] = np.broadcast_to(rot.astype(np.float32),
                                      (B, R, SR, K, 3, 3)).copy()
    with torch.no_grad():
        return tagg.aggregator_forward(
            agg, opt, *(torch.tensor(ins[k]) for k in ORDER),
            vsize=(0.004, 0.004, 0.004))


ROUTES = {   # case: (options, per-point Rw2c, bf16 form runs)
    "auto": (dict(), False, True),
    "forced": (dict(use_fused_trunk=1), False, True),
    "fused_shade_1": (dict(fused_shade=1), False, False),
    "fused_shade_auto": (dict(fused_shade=-1), False, False),
    "fused_trunk_off": (dict(use_fused_trunk=0), False, False),
    "per_point_rw2c": (dict(), True, False),
    "compute_bfloat16": (dict(compute_dtype="bfloat16"), False, False),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_trunk_dtype_takes_effect_where_jax_runs_bf16(route, monkeypatch):
    """trunk_dtype bfloat16 changes the aggregator's output exactly where
    JAX's accelerator runs its bf16 kernel (the fused trunk on, float32
    products, one Rw2c, no fused_shade route), on the CPU as K1b's plain
    version; elsewhere the output is bit for bit trunk_dtype float32's."""
    kw, per_point, runs = ROUTES[route]
    forms = []
    _record(monkeypatch, forms)
    f32 = _aggregate(_route_opt(**kw), per_point)
    calls = len(forms)
    bf = _aggregate(_route_opt(trunk_dtype="bfloat16", **kw), per_point)
    assert not any(forms[:calls])
    assert any(forms[calls:]) == runs
    same = all(torch.equal(a, b) for a, b in zip(f32, bf))
    assert same != runs
    # bf16 against float32: within JAX's own forward bar for the pair
    # (tests/test_pallas_trunk.py, 2e-2 of scale)
    scale = float(f32[0].abs().max())
    assert float((bf[0] - f32[0]).abs().max()) <= 2e-2 * scale


def _bf16_trunk(orig):
    """JAX's fused_trunk with bf16 forced on: the JAX aggregator turns it
    off on the CPU (interpret mode) to keep its own parity tests exact."""
    def trunk(L1, L3, nf, nd, K, act_super, tile, interpret, bf16, order1,
              *rest):
        return orig(L1, L3, nf, nd, K, act_super, tile, interpret, True,
                    order1, *rest)
    return trunk


def test_train_step_bf16_matches_jax(monkeypatch):
    """The lego-envelope train step under trunk_dtype bfloat16: the port's
    compute_grads (K1b's and K2b's plain versions) against JAX's with its
    Pallas trunk in interpret mode and bf16 forced on. Loss items within
    rtol 1e-5; every gradient within the quantile bars."""
    opt, ts, spec, grid, batch = _scene("tiny", use_fused_trunk=1,
                                        trunk_dtype="bfloat16")
    key = jax.random.PRNGKey(5)
    jax.clear_caches()
    try:
        monkeypatch.setattr(jt, "fused_trunk", _bf16_trunk(jt.fused_trunk))
        want, jn, jp = jtr.compute_grads(ts, grid, batch, key, opt, spec)
        monkeypatch.undo()
    finally:
        jax.clear_caches()
    forms = []
    _record(monkeypatch, forms)
    st, spec_t, grid_t, tb = _port(opt, ts, batch)
    B, R = batch["raydir"].shape[:2]
    u = torch.tensor(_uniform(key, B, R, opt.z_depth_dim))
    items, g_net, g_pts = ttr.compute_grads(st, grid_t, tb, opt, spec_t, u)
    assert forms and all(forms)
    assert set(items) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(items[k].detach()), float(v),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    jnet = _net_tensors(_np_tree(jn))
    assert set(g_net) == set(jnet) and set(g_pts) == set(jp)
    misses = {k: _misses(g_net[k].numpy(), v, GRAD_BARS)
              for k, v in jnet.items()}
    misses.update({k: _misses(g_pts[k].numpy(), np.asarray(v), GRAD_BARS)
                   for k, v in jp.items()})
    assert not any(misses.values()), misses
    assert not any(k.launches for k in kernels.KERNELS)
