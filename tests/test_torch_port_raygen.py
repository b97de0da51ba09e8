"""The ray generators, `sample_pdf` and the refine generators against the
JAX package (`pointnerf_tpu/ops/raygen.py`).

JAX draws its random numbers from a key; the port takes the same draws as
`u` tensors (`jax.random.uniform(key, shape)` here), so both sample the
same depths. The JAX functions run under `jax.jit` with the depth range
traced, as the renderer and trainer run them (XLA contracts FMAs and blocks
cumulative sums only inside jit, and folds constants it can see). Depths
and positions are held at rtol = atol = 1e-6; the depths, segments and
validity bit for bit where the port follows XLA's linspace, FMA, sum and
cumsum order: the registry's generators without draws, `sample_pdf` and
the refine passes.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointnerf_tpu.ops import raygen as jr
from pointnerf_tpu_torch.ops import raygen as tr

TOL = dict(rtol=1e-6, atol=1e-6)
B, R = 2, 5


def _rays(seed=0):
    rng = np.random.RandomState(seed)
    campos = rng.uniform(-1, 1, (B, 3)).astype(np.float32)
    rd = rng.normal(size=(B, R, 3)).astype(np.float32)
    rd[0] /= np.linalg.norm(rd[0], axis=-1, keepdims=True)    # unit and not
    return campos, rd


def _close(got, want, exact=False):
    """(raypos, seg, valid, ts) against JAX's; raypos at TOL always (XLA
    fuses campos + raydir·t its own way; the renderer reads ts only, as
    test_torch_port_query.py::test_ray_generation_matches_jax notes)."""
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.detach().numpy(), np.asarray(w)
        assert g.shape == w.shape
        if exact and i > 0:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, **TOL)


GENERATORS = ("near_far_linear", "near_far_disparity_linear",
              "near_middle_far", "nerf_near_far_linear",
              "nerf_near_far_disparity_linear")


def _draw_count(name, S, split=0.6):
    if name == "near_middle_far":
        return int(S * split) + int(S * (1 - split)) + 2
    return S


@pytest.mark.parametrize("S", [7, 40])
@pytest.mark.parametrize("jitter", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("name", GENERATORS)
def test_generators_match_jax(name, jitter, S):
    """Each registry entry with and without draws; the near_middle_far
    draws cover all its segments before the first S are kept."""
    campos, rd = _rays()
    kw = dict(near=2.0, far=6.0, jitter=jitter)
    if name == "near_middle_far":
        kw.update(middle=3.5, middle_split=0.6)
    key = jax.random.PRNGKey(3)
    gen = jr.find_ray_generation_method(name)
    depths = {k: v for k, v in kw.items() if k in ("near", "far", "middle")}
    fixed = {k: v for k, v in kw.items() if k not in depths}
    want = jax.jit(lambda c, r, d, k: gen(c, r, S, key=k, **d, **fixed))(
        jnp.asarray(campos), jnp.asarray(rd), depths,
        key if jitter > 0 else None)
    u = np.asarray(jax.random.uniform(key, (B, R, _draw_count(name, S)),
                                      dtype=jnp.float32))
    got = tr.find_ray_generation_method(name)(
        torch.tensor(campos), torch.tensor(rd), S,
        u=torch.tensor(u) if jitter > 0 else None, **kw)
    _close(got, want, exact=jitter == 0)
    assert got[3].shape == (B, R, S)


def test_registry_and_draw_shapes():
    with pytest.raises(RuntimeError, match="No such ray generation"):
        tr.find_ray_generation_method("bogus")
    assert set(tr._GENERATORS) == set(jr._GENERATORS)
    for name in ("cube", "nerf", "nerf_x", "default", ""):
        assert tr.find_refined_ray_generation_method(name).__name__ \
            == jr.find_refined_ray_generation_method(name).__name__
    campos, rd = _rays()
    with pytest.raises(ValueError, match=r"draws u must be \[2, 5, 8\]"):
        tr.nerf_near_far_linear_ray_generation(
            torch.tensor(campos), torch.tensor(rd), 8, jitter=1.0,
            u=torch.zeros(2, 5, 7))


def _coarse(S=16, seed=1, kind="random"):
    rng = np.random.RandomState(seed)
    ts = np.sort(rng.uniform(2, 6, (B, R, S)), axis=-1).astype(np.float32)
    if kind == "random":
        w = rng.uniform(0, 1, (B, R, S))
    elif kind == "zero":
        w = np.zeros((B, R, S))
    else:           # one dominant bin: the CDF after it ties in float32
        w = np.full((B, R, S), 1e-9)
        w[..., S // 3] = 1e4
    return ts, w.astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "zero", "peak"])
@pytest.mark.parametrize("det", [True, False])
def test_sample_pdf_matches_jax(det, kind):
    """Evenly spaced or drawn u, on random weights, all-zero weights (a
    uniform pdf) and one dominant bin, whose CDF holds runs of tied values
    (the right-side searchsorted picks the last of a run)."""
    ts, w = _coarse(kind=kind)
    n = 24
    key = jax.random.PRNGKey(9)
    want = jax.jit(jr.sample_pdf, static_argnums=2,
                   static_argnames="det")(jnp.asarray(ts), jnp.asarray(w), n,
                                          key=None if det else key, det=det)
    u = np.asarray(jax.random.uniform(key, (B, R, n), dtype=jnp.float32))
    got = tr.sample_pdf(torch.tensor(ts), torch.tensor(w), n,
                        u=None if det else torch.tensor(u), det=det)
    assert got.shape == (B, R, n + ts.shape[-1])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if kind == "peak":
        cdf = np.cumsum(w[..., 1:-1] + 1e-5, axis=-1, dtype=np.float32)
        assert (np.diff(cdf / cdf[..., -1:], axis=-1) == 0).any()


@pytest.mark.parametrize("name", ["default", "nerf", "cube"])
@pytest.mark.parametrize("jitter", [0.0, 1.0])
def test_refine_generators_match_jax(name, jitter):
    """The refine passes at point_count 12 from a 16-sample coarse pass;
    the cube variant's validity with a domain the rays leave."""
    campos, rd = _rays(2)
    ts, w = _coarse(seed=4)
    key = jax.random.PRNGKey(6)
    kw = dict(domain_size=2.5, jitter=jitter)
    fn = jax.jit(jr.find_refined_ray_generation_method(name),
                 static_argnums=2, static_argnames=tuple(kw))
    want = fn(jnp.asarray(campos), jnp.asarray(rd), 12, jnp.asarray(ts),
              jnp.asarray(w), key=key if jitter > 0 else None, **kw)
    u = np.asarray(jax.random.uniform(key, (B, R, 13), dtype=jnp.float32))
    got = tr.find_refined_ray_generation_method(name)(
        torch.tensor(campos), torch.tensor(rd), 12, torch.tensor(ts),
        torch.tensor(w), u=torch.tensor(u) if jitter > 0 else None, **kw)
    _close(got, want, exact=True)
    assert got[3].shape == (B, R, 12 + 16)
    if name == "cube":
        valid = got[2].numpy()
        assert valid.min() == 0 and valid.max() == 1
