"""Grid build parity: pointnerf_tpu_torch.ops.grid against pointnerf_tpu.ops.grid.

The build is a deterministic sort, so every table must be bit-equal.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pointnerf_tpu.config import Options
from pointnerf_tpu.ops import grid as jgrid
from pointnerf_tpu_torch.ops import grid as tgrid


def _opt(**kw):
    base = dict(vsize=(0.05, 0.05, 0.05), vscale=(1, 1, 1),
                kernel_size=(3, 3, 3), query_size=(3, 3, 3),
                ranges=(-0.5, -0.5, -0.5, 0.5, 0.5, 0.5),
                max_o=512, P=6, radius_limit_scale=4.0)
    base.update(kw)
    return Options(**base)


def _cloud(n, seed, cap):
    """Clustered cloud (dense voxels overflow P) with padded dead slots."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-0.35, 0.35, (12, 3))
    xyz = (centers[rng.randint(0, 12, n)]
           + rng.normal(0, 0.04, (n, 3))).astype(np.float32)
    full = np.full((cap, 3), 1.0e6, np.float32)
    full[:n] = xyz
    mask = np.arange(cap) < n
    mask[rng.rand(cap) < 0.05] = False       # a few pruned slots
    return xyz, full, mask


@pytest.mark.parametrize("superset_P,query_size,max_o", [
    (0, (3, 3, 3), 512),
    (16, (3, 3, 3), 512),
    (64, (3, 3, 3), 200),       # max_o below the occupied count: capped
    (16, (2, 4, 3), 512),       # even window: asymmetric dilation
])
def test_build_grid_tables_bit_equal(superset_P, query_size, max_o):
    xyz, full, mask = _cloud(700, 5, 768)
    opt = _opt(superset_P=superset_P, query_size=query_size, max_o=max_o)
    spec_j = jgrid.make_grid_spec(opt, xyz.min(0), xyz.max(0), len(xyz))
    spec_t = tgrid.make_grid_spec(opt, xyz.min(0), xyz.max(0), len(xyz))
    assert spec_t.__dict__ == spec_j.__dict__
    want = jgrid.build_grid(jnp.asarray(full), jnp.asarray(mask), spec_j)
    got = tgrid.build_grid(torch.as_tensor(full), torch.as_tensor(mask),
                           spec_t)
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        g = got[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)
