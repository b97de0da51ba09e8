"""K6's plain version and the point-gradient scatter it serves, against the
JAX package.

`scatter_add_rows_reference` must equal np.add.at and the JAX script's
`base` (`jnp.zeros(...).at[i].add(u)`, scripts/scatter_pallas.py:109) on
the script's index draw, with duplicates and skipped negative indices; the
port's packed point gather must give JAX's gradient (missing neighbors read
row 0, so their cotangent lands there). Tolerance rtol = atol = 1e-5
(float32, duplicates summed in another order); the CPU wrapper launches no
kernel.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointnerf_tpu.models import neural_points as jnpc
from pointnerf_tpu_torch.models import neural_points as tnpc
from pointnerf_tpu_torch.ops import kernels
from pointnerf_tpu_torch.ops.scatter import (scatter_add_rows,
                                             scatter_add_rows_reference)
from pointnerf_tpu_torch.scripts import scatter_pallas

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("C,dup", [(42, 6.0), (42, 4.0), (7, 6.0)])
def test_plain_scatter_matches_add_at_and_jax_base(C, dup):
    idx, upd = scatter_pallas.script_inputs(S=6000, cap=1600, C=C, dup=dup)
    want = np.zeros((1600, C), np.float32)
    np.add.at(want, idx, upd)
    base = jnp.zeros((1600, C), jnp.float32).at[jnp.asarray(idx)].add(
        jnp.asarray(upd))
    got = scatter_add_rows(torch.as_tensor(idx), torch.as_tensor(upd), 1600)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(base), **TOL)
    assert kernels.SCATTER_ROWS.launches == 0


def test_plain_scatter_skips_negative_indices():
    rng = np.random.RandomState(3)
    idx = rng.randint(0, 50, 900).astype(np.int32)
    idx[rng.rand(900) < 0.4] = -1
    upd = rng.uniform(-1, 1, (900, 42)).astype(np.float32)
    keep = idx >= 0
    want = np.zeros((50, 42), np.float32)
    np.add.at(want, idx[keep], upd[keep])
    got = scatter_add_rows_reference(torch.as_tensor(idx),
                                     torch.as_tensor(upd), 50)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("C", [42, 7])
def test_plain_scatter_takes_int64_indices(C):
    """int64 indices, as the point gather's backward passes them (the
    kernel takes them unconverted), with duplicates and skipped negative
    ones: equal to np.add.at and to JAX's base over the kept entries."""
    idx, upd = scatter_pallas.script_inputs(S=6000, cap=1600, C=C, dup=6.0)
    idx = idx.astype(np.int64)
    idx[np.random.RandomState(5).rand(idx.shape[0]) < 0.68] = -1
    keep = idx >= 0
    want = np.zeros((1600, C), np.float32)
    np.add.at(want, idx[keep], upd[keep])
    base = jnp.zeros((1600, C), jnp.float32).at[jnp.asarray(idx[keep])].add(
        jnp.asarray(upd[keep]))
    got = scatter_add_rows(torch.as_tensor(idx), torch.as_tensor(upd), 1600)
    assert torch.as_tensor(idx).dtype == torch.int64
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(base), **TOL)
    assert kernels.SCATTER_ROWS.launches == 0


def test_plain_scatter_rejects_an_index_past_the_table():
    """An index at or past n_rows raises (the kernel traps on the card)."""
    idx = torch.tensor([0, 3, 50, -1], dtype=torch.int32)
    with pytest.raises((IndexError, RuntimeError)):
        scatter_add_rows(idx, torch.ones(4, 42), 50)


def test_packed_gather_gradient_matches_jax():
    """gather_neighbors' point gradients (the backward that runs K6 on the
    card) equal jax.vjp of the JAX package's gather_neighbors."""
    rng = np.random.RandomState(0)
    n, cap = 40, 64
    xyz = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    emb = rng.uniform(-1, 1, (n, 8)).astype(np.float32)
    color, dirs = rng.rand(n, 3).astype(np.float32), \
        rng.rand(n, 3).astype(np.float32)
    conf = rng.rand(n, 1).astype(np.float32)
    pidx = rng.randint(0, n, (1, 6, 5, 4)).astype(np.int32)
    pidx[rng.rand(*pidx.shape) < 0.5] = -1
    campos = np.array([[0.1, -0.2, -3.0]], np.float32)
    rot = np.eye(3, dtype=np.float32)[None]
    cts = {k: rng.normal(size=(1, 6, 5, 4, w)).astype(np.float32)
           for k, w in (("sampled_xyz", 3), ("sampled_embedding", 8),
                        ("sampled_color", 3), ("sampled_dir", 3),
                        ("sampled_conf", 1))}
    js = jnpc.create_point_cloud(xyz, emb, color, dirs, conf, capacity=cap)
    train = ("embedding", "color", "dir", "conf", "xyz")

    def jf(*bufs):
        st = dict(js, **dict(zip(train, bufs)))
        out = jnpc.gather_neighbors(st, jnp.asarray(pidx), jnp.asarray(rot),
                                    jnp.asarray(campos))
        return sum(jnp.sum(out[k] * cts[k]) for k in cts)
    want = jax.grad(jf, argnums=tuple(range(5)))(*(js[k] for k in train))

    ts = tnpc.create_point_cloud(xyz, emb, color, dirs, conf, capacity=cap,
                                 device="cpu")
    leaves = {k: ts[k].clone().requires_grad_(True) for k in train}
    out = tnpc.gather_neighbors(dict(ts, **leaves), torch.as_tensor(pidx),
                                torch.as_tensor(rot), torch.as_tensor(campos))
    total = sum((out[k] * torch.as_tensor(cts[k])).sum() for k in cts)
    total.backward()
    for k, w in zip(train, want):
        np.testing.assert_allclose(leaves[k].grad.numpy(), np.asarray(w),
                                   err_msg=k, **TOL)


def test_micro_benchmark_runs_on_the_cpu(capsys):
    """The scatter_pallas counterpart checks every variant against
    np.add.at and prints the JAX script's keys."""
    out = scatter_pallas.main(["--device", "cpu", "--S", "3000", "--cap",
                               "1000", "--reps", "1"])
    for name in ("kernel", "plain", "base", "banks"):
        assert out[f"{name}_maxerr"] < 1e-5 and out[f"{name}_ms"] > 0
    assert '"banks_ms"' in capsys.readouterr().out
