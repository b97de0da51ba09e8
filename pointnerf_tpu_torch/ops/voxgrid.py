"""Regular-lattice point construction and the 8-corner vox-grid query
(NN < 0); port of `pointnerf_tpu/ops/voxgrid.py`.

With `--NN -1` the neural point cloud is a regular lattice covering every
occupied construct-voxel of the input cloud (reference neural_points.py:
488-515 `construct_grid_points`), and each shading sample's K = 8
"neighbors" are the corners of the lattice cell around it, read from a
dense corner → point table (reference :571-573, :580-592). The aggregator's
`trilinear` kernel pairs with it (models/aggregator.py).

`construct_grid_points` and `derive_lattice` are host numpy, copied. The
table and the query are torch on the points' device and equal the JAX
package's int32 outputs exactly, for two reasons:

* the JAX package runs both inside `jax.jit`, where XLA:CPU compiles
  ``(x - mn) / spec.vox_gvs`` as a multiply by the float32 reciprocal of
  the pitch (the same rewrite as `ops/grid.voxel_coords`); the port
  multiplies by that reciprocal, taken on the host;
* where two points round to one corner, XLA:CPU's scatter keeps the last
  (highest) index; the port takes the maximum index per corner
  (`scatter_reduce` amax), the same on the CPU and the card.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# the 8 cell corners, in the reference's order (neural_points.py:583-584)
CORNER_SHIFT = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1),
                (1, 0, 1), (0, 1, 1), (1, 1, 0), (1, 1, 1))


def construct_grid_points(xyz: np.ndarray, construct_res: int, grid_res: int):
    """Snap a cloud onto a regular lattice (reference neural_points.py:
    488-515): the cloud's bounding cube (1.1 x its largest extent, centred)
    is split into construct_res³ construct-voxels, and every occupied one
    contributes its (cg+1)³ lattice corners at pitch space_edge / grid_res
    (cg = grid_res // construct_res), deduplicated. Returns (grid_xyz [M,3]
    float32, grid_vox_sz)."""
    if construct_res <= 0 or grid_res < construct_res:
        raise ValueError(
            f"construct_res={construct_res} grid_res={grid_res}: need "
            "0 < construct_res <= grid_res (reference --construct_res/"
            "--grid_res)")
    xyz = np.asarray(xyz, np.float64)
    mn, mx = xyz.min(0), xyz.max(0)
    space_edge = np.max(mx - mn) * 1.1
    mid = (mx + mn) / 2
    space_min = mid - space_edge / 2
    construct_vox_sz = space_edge / construct_res
    grid_vox_sz = space_edge / grid_res

    cvox = np.unique(
        np.floor((xyz - space_min) / construct_vox_sz).astype(np.int64), axis=0)
    cg = int(grid_res / construct_res)
    g = np.arange(cg + 1, dtype=np.int64)
    gx, gy, gz = np.meshgrid(g, g, g, indexing="ij")
    corners = np.stack([gx, gy, gz], -1).reshape(1, -1, 3)
    sparse = np.unique((cvox[:, None, :] * cg + corners).reshape(-1, 3), axis=0)
    grid_xyz = (space_min + sparse * grid_vox_sz).astype(np.float32)
    return grid_xyz, float(grid_vox_sz)


def derive_lattice(xyz: np.ndarray) -> Tuple[np.ndarray, float, np.ndarray]:
    """(origin corner, pitch, dims) of a lattice-snapped cloud: every
    construct-voxel gives at least two consecutive corners per axis, so the
    smallest positive coordinate step along any axis is the pitch."""
    xyz = np.asarray(xyz, np.float64)
    mn = xyz.min(0)
    pitch = np.inf
    for a in range(3):
        u = np.unique(xyz[:, a])
        if len(u) > 1:
            pitch = min(pitch, float(np.min(np.diff(u))))
    if not np.isfinite(pitch):
        raise ValueError("cannot derive lattice pitch from a degenerate cloud")
    dims = np.round((xyz.max(0) - mn) / pitch).astype(np.int64) + 1
    return mn, pitch, dims


def check_vox_volume(spec) -> int:
    """The corner table's size; ValueError where its linear index would
    pass 32 bits."""
    vol = int(spec.vox_dim[0]) * int(spec.vox_dim[1]) * int(spec.vox_dim[2])
    if vol >= 2 ** 31:
        raise ValueError(
            f"the vox-grid corner table {tuple(spec.vox_dim)} has {vol} "
            f"corners, past a 32-bit index: lower grid_res")
    return vol


def _lattice_consts(spec, device):
    from .grid import host_const     # grid imports this module
    mn = host_const(spec.vox_space_min, torch.float32, device)
    inv = float(np.float32(1.0) / np.float32(spec.vox_gvs))
    dims = host_const(spec.vox_dim, torch.int32, device)
    return mn, inv, dims


def _linear(c: torch.Tensor, spec) -> torch.Tensor:
    d1, d2 = int(spec.vox_dim[1]), int(spec.vox_dim[2])
    return (c[..., 0] * d1 + c[..., 1]) * d2 + c[..., 2]


def build_vox_table(xyz: torch.Tensor, point_mask: torch.Tensor, spec
                    ) -> torch.Tensor:
    """Dense corner → point-index table over the lattice's box: [prod(
    vox_dim)] int32, -1 where no point sits (reference neural_points.py:
    511-513, sized to the occupied box). Where points share a corner, the
    highest index holds it, as the JAX package's scatter leaves it."""
    vol = check_vox_volume(spec)
    mn, inv, dims = _lattice_consts(spec, xyz.device)
    coords = torch.round((xyz - mn) * inv).to(torch.int32)
    inb = torch.all((coords >= 0) & (coords < dims), dim=-1) & point_mask
    lin = torch.where(inb, _linear(coords, spec), vol).long()
    table = torch.full((vol + 1,), -1, dtype=torch.int32, device=xyz.device)
    idx = torch.arange(xyz.shape[0], dtype=torch.int32, device=xyz.device)
    table.scatter_reduce_(0, lin, idx, "amax")
    return table[:vol]


def query_vox_grid(sample_loc_w: torch.Tensor, vox_table: torch.Tensor,
                   spec) -> torch.Tensor:
    """Shading location → its cell's 8 corner point indices, [B,R,SR,3] →
    [B,R,SR,8] int32 (reference neural_points.py:580-592): a sample whose
    cell has any corner empty or out of the box gets -1 in all 8."""
    from .grid import host_const
    mn, inv, dims = _lattice_consts(spec, sample_loc_w.device)
    cell = torch.floor((sample_loc_w - mn) * inv).to(torch.int32)
    shift = host_const(CORNER_SHIFT, torch.int32, sample_loc_w.device)
    corner = cell[..., None, :] + shift                        # [B,R,SR,8,3]
    oob = torch.any((corner < 0) | (corner >= dims), dim=-1)
    corner = torch.minimum(torch.clamp(corner, min=0), dims - 1)
    inds = vox_table[_linear(corner, spec).long()]
    inds = torch.where(oob, -1, inds)
    return torch.where(torch.any(inds < 0, dim=-1, keepdim=True), -1, inds)
