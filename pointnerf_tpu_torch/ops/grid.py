"""Deterministic voxel-grid construction over a neural point cloud.

PyTorch port of `pointnerf_tpu/ops/grid.py`. The build is a pure function of
(xyz, mask): points are sorted by voxel id and bucketed in sorted order, so
every table equals the JAX build bit for bit. Two numeric details keep it so:

* XLA compiles ``x / c`` for a constant ``c`` as ``x * (1/c)``, and contracts
  ``a * b + c`` into one fused multiply-add. The port computes the same
  expressions the same way: `voxel_coords` multiplies by the float32
  reciprocal, and `fma` rounds ``a * b + c`` once (the exact float64 value,
  rounded to float32).
* `torch.topk` does not promise `lax.top_k`'s lower-index-first tie order;
  a stable ascending sort does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .voxgrid import build_vox_table

LW = 128          # lanes per row of the dilated-occupancy table
_SUPER_BLOCK = 4096  # occupied slots per superset block (bounds the
                     # [blk, kernel³·P, 4] candidate intermediate)


@dataclass(frozen=True)
class GridSpec:
    """Static grid geometry (numpy-only copy of the JAX package's GridSpec)."""
    ranges_min: Tuple[float, float, float]
    scaled_vsize: Tuple[float, float, float]
    vdim: Tuple[int, int, int]
    max_o: int
    P: int
    kernel_size: Tuple[int, int, int]
    query_size: Tuple[int, int, int]
    radius_limit: float
    vsize: Tuple[float, float, float]
    query_max_voxels: int = 0
    superset_P: int = 0
    depth_limit: float = 0.0
    pers_metric: bool = False
    inv_z: bool = False
    vox_dim: Tuple[int, int, int] = (0, 0, 0)
    vox_space_min: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    vox_gvs: float = 0.0
    superset_pad: Tuple[int, int, int] = (0, 0, 0)

    @property
    def grid_size_vol(self) -> int:
        return int(self.vdim[0]) * int(self.vdim[1]) * int(self.vdim[2])


def make_grid_spec(opt, points_min=None, points_max=None,
                   max_points: int = 0) -> GridSpec:
    """Host-side grid hyperparameters (reference: point_query.py:47-71)."""
    vsize = np.asarray(opt.vsize, dtype=np.float64)
    vscale = np.asarray(opt.vscale, dtype=np.float64)
    scaled_vsize = vsize * vscale
    kernel = np.asarray(opt.kernel_size, dtype=np.int32)
    ranges = np.asarray(opt.ranges, dtype=np.float64)
    mn, mx = ranges[:3], ranges[3:]
    if points_min is not None:
        mn = np.maximum(np.asarray(points_min, dtype=np.float64), mn)
    if points_max is not None:
        mx = np.minimum(np.asarray(points_max, dtype=np.float64), mx)
    mn = mn - scaled_vsize * kernel / 2.0
    mx = mx + scaled_vsize * kernel / 2.0
    vdim = np.ceil((mx - mn) / vsize / vscale).astype(np.int32)
    max_o = opt.max_o
    if max_o is None or max_o <= 0:
        max_o = int(max(1, max_points))
    return GridSpec(
        ranges_min=tuple(float(v) for v in mn),
        scaled_vsize=tuple(float(v) for v in scaled_vsize),
        vdim=tuple(int(v) for v in vdim),
        max_o=int(max_o),
        P=int(opt.P),
        kernel_size=tuple(int(k) for k in opt.kernel_size),
        query_size=tuple(int(q) for q in opt.effective_query_size),
        radius_limit=float(opt.radius_limit),
        vsize=tuple(float(v) for v in vsize),
        query_max_voxels=int(getattr(opt, "query_max_voxels", 0)),
        superset_P=int(getattr(opt, "superset_P", 0)),
    )


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as XLA's contracted FMA computes it.

    The product of two float32 values is exact in float64, so the float64
    sum carries one rounding before the cast (a second rounding can differ
    from a true FMA only when the float64 sum lands on a float32 tie)."""
    a64 = a.double()
    b64 = b.double() if torch.is_tensor(b) else b
    c64 = c.double() if torch.is_tensor(c) else c
    return (a64 * b64 + c64).float()


def true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as one rounded division on every device. On CUDA torch divides
    by a Python number as a multiply by its reciprocal, at times an ulp
    off; by a 0-dim tensor on x's device it divides, as the CPU and XLA
    do."""
    return x / x.new_full((), c)


_CONSTS: Dict[tuple, torch.Tensor] = {}


def host_const(values, dtype, device) -> torch.Tensor:
    """A small constant tensor on `device`; callers never write into it.
    On a CUDA device it is made once per value and device, copied from
    pinned memory without blocking (a plain copy from pageable memory waits
    for every kernel queued before it), and kept: later calls return the
    same tensor, so a train step captured in a CUDA graph (`train.graph`)
    reads constants that outlive the capture. Making one inside a capture
    raises: the step's eager run before the capture makes them all."""
    t = torch.as_tensor(values, dtype=dtype)
    dev = torch.device(device)
    if dev.type != "cuda":
        return t
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (t.dtype, dev.index, tuple(t.shape), t.numpy().tobytes())
    hit = _CONSTS.get(key)
    if hit is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("a constant made for the first time inside a "
                               "CUDA graph capture")
        hit = _CONSTS[key] = t.pin_memory().to(dev, non_blocking=True)
    return hit


def grid_consts(spec: GridSpec, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ranges_min, 1/scaled_vsize) as float32 tensors on `device`."""
    mn = host_const(spec.ranges_min, torch.float32, device)
    inv = 1.0 / host_const(spec.scaled_vsize, torch.float32, device)
    return mn, inv


def voxel_coords(xyz: torch.Tensor, spec: GridSpec
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """World position → int32 scaled-voxel coords + in-bounds mask.

    spec.inv_z (the frustum's inverse 1): the z axis buckets by disparity
    1/max(z, 1e-9); positions keep true z everywhere else."""
    if spec.inv_z:
        zt = 1.0 / torch.clamp(xyz[..., 2:3], min=1e-9)
        xyz = torch.cat([xyz[..., :2], zt], dim=-1)
    mn, inv = grid_consts(spec, xyz.device)
    coords = torch.floor((xyz - mn) * inv).to(torch.int32)
    vdim = host_const(spec.vdim, torch.int32, xyz.device)
    inb = torch.all((coords >= 0) & (coords < vdim), dim=-1)
    return coords, inb


def linearize(coords: torch.Tensor, spec: GridSpec) -> torch.Tensor:
    """[..., 3] int voxel coords → linear index (row-major)."""
    _, vy, vz = spec.vdim
    return coords[..., 0] * (vy * vz) + coords[..., 1] * vz + coords[..., 2]


def check_grid_volume(spec: GridSpec) -> None:
    """Raise ValueError where the grid's linear voxel index would pass 32
    bits: with opt.ranges left at ±100 a world grid has (200/scaled
    vsize)³ voxels, and its dense tables cannot be built (the JAX package
    computes the same spec and cannot build them either)."""
    if spec.grid_size_vol >= 2 ** 31:
        raise ValueError(
            f"the voxel grid {spec.vdim} has {spec.grid_size_vol} voxels, "
            f"past a 32-bit index: set opt.ranges to the scene's bounds")


def _shift3(a: torch.Tensor, off) -> torch.Tensor:
    """a [X,Y,Z] shifted so out[v] = a[v + off], -1 outside."""
    out = torch.full_like(a, -1)
    src, dst = [], []
    for ax in range(3):
        o, n = int(off[ax]), a.shape[ax]
        if o >= 0:
            src.append(slice(o, n))
            dst.append(slice(0, n - o))
        else:
            src.append(slice(0, n + o))
            dst.append(slice(-o, n))
    out[tuple(dst)] = a[tuple(src)]
    return out


def build_grid(xyz: torch.Tensor, point_mask: torch.Tensor, spec: GridSpec
               ) -> Dict[str, torch.Tensor]:
    """Build the voxel→bucket tables. Pure function of (xyz, point_mask).

    xyz [N,3] float32, point_mask [N] bool. Returns coor_2_occ [vol] int32,
    occ_2_xyz [max_o,P,4] float32, coor_occ_rows [vol/128,128] int8,
    num_occ [] int32, and with superset_P > 0 also super_xyz
    [max_o, 4·superset_P] float32 and coor_slot [vol] int32, and with a
    lattice in the spec (vox_dim, the NN < 0 vox-grid query) vox_table
    [prod(vox_dim)] int32 — the layouts and values of the JAX build.
    """
    check_grid_volume(spec)
    dev = xyz.device
    N = xyz.shape[0]
    vol = spec.grid_size_vol
    coords, inb = voxel_coords(xyz, spec)
    valid = inb & point_mask
    lin = torch.where(valid, linearize(coords, spec),
                      torch.full_like(coords[:, 0], vol))
    sorted_lin, order = torch.sort(lin, stable=True)
    sorted_valid = sorted_lin < vol
    head = torch.cat([sorted_valid[:1],
                      (sorted_lin[1:] != sorted_lin[:-1]) & sorted_valid[1:]])
    slot = torch.cumsum(head.to(torch.int32), 0, dtype=torch.int32) - 1
    num_occ = head.sum(dtype=torch.int32)
    idx = torch.arange(N, dtype=torch.int32, device=dev)
    seg_start = torch.cummax(torch.where(head, idx, 0), 0).values
    rank = idx - seg_start
    keep = sorted_valid & (slot < spec.max_o)
    kh = keep & head
    head_lin = sorted_lin[kh].long()
    head_slot = slot[kh]

    coor_2_occ = torch.full((vol,), -1, dtype=torch.int32, device=dev)
    coor_2_occ[head_lin] = head_slot

    # first P points per voxel in sorted order, as (x, y, z, point index)
    keep_p = keep & (rank < spec.P)
    flat = (slot * spec.P + rank)[keep_p].long()
    payload = torch.cat([xyz[order][keep_p],
                         order[keep_p].to(xyz.dtype)[:, None]], dim=-1)
    occ_2_xyz = torch.full((spec.max_o * spec.P, 4), 1.0e8,
                           dtype=xyz.dtype, device=dev)
    occ_2_xyz[flat] = payload
    occ_2_xyz = occ_2_xyz.reshape(spec.max_o, spec.P, 4)

    # dilated occupancy: v is marked if an occupied u has
    # u - v ∈ [-(q-1)//2, q//2] — a max-pool over an asymmetrically padded
    # copy (the JAX build's reduce_window)
    occ = torch.zeros(vol, dtype=torch.float32, device=dev)
    occ[head_lin] = 1.0
    q = spec.query_size
    pad = []
    for qq in reversed(q):
        pad += [(qq - 1) // 2, qq // 2]
    occ3 = F.pad(occ.reshape((1, 1) + tuple(spec.vdim)), pad)
    coor_occ = F.max_pool3d(occ3, kernel_size=tuple(q), stride=1)
    coor_occ = coor_occ.reshape(-1).to(torch.int8)
    volp = -(-vol // LW) * LW
    coor_occ_rows = F.pad(coor_occ, (0, volp - vol)).reshape(-1, LW)

    out = {"coor_2_occ": coor_2_occ, "occ_2_xyz": occ_2_xyz,
           "coor_occ_rows": coor_occ_rows, "num_occ": num_occ}
    if spec.vox_dim[0] > 0:
        out["vox_table"] = build_vox_table(xyz, point_mask, spec)
    if spec.superset_P > 0:
        out.update(_build_supersets(coords[order][kh], head_lin, head_slot,
                                    coor_2_occ, occ_2_xyz, spec))
    return out


def _build_supersets(head_coords, head_lin, head_slot, coor_2_occ, occ_2_xyz,
                     spec: GridSpec) -> Dict[str, torch.Tensor]:
    """Per occupied voxel: its superset_P nearest candidates from the
    kernel_size³ neighborhood (super_xyz, SoA rows [x·P2|y·P2|z·P2|idx·P2]),
    and every dilated voxel's nearest occupied slot (coor_slot).

    A slot past the occupied ones holds voxel (0, 0, 0), as in the JAX
    build, so all of them take one row: it is computed once and repeated,
    and the blocks run over the occupied slots only."""
    dev = coor_2_occ.device
    P2 = spec.superset_P
    occ_coords = torch.zeros((spec.max_o, 3), dtype=torch.int32, device=dev)
    occ_coords[head_slot.long()] = head_coords
    n_live = head_slot.shape[0]          # occupied slots kept: 0..n_live-1

    lx = (spec.kernel_size[0] + 1) // 2 - 1
    pads = spec.superset_pad
    ax = [np.arange(-lx - p, lx + p + 1) for p in pads]
    offs = torch.as_tensor(np.stack(np.meshgrid(*ax, indexing="ij"), axis=-1)
                           .reshape(-1, 3).astype(np.int32), device=dev)
    O = offs.shape[0]
    vdim = torch.tensor(spec.vdim, dtype=torch.int32, device=dev)
    mn = torch.tensor(spec.ranges_min, dtype=torch.float32, device=dev)
    vs = torch.tensor(spec.scaled_vsize, dtype=torch.float32, device=dev)
    half = (torch.tensor(pads, dtype=torch.float32, device=dev) + 0.5) * vs
    flat_tiles = occ_2_xyz.reshape(spec.max_o, spec.P * 4)
    k = min(P2, O * spec.P)

    def block(cc):
        BS = cc.shape[0]
        nb = cc[:, None, :] + offs                                # [BS,O,3]
        nb_in = torch.all((nb >= 0) & (nb < vdim), dim=-1)
        nb_lin = torch.where(nb_in, linearize(nb, spec), 0).long()
        nb_slot = torch.where(nb_in, coor_2_occ[nb_lin], -1)
        rows = flat_tiles[nb_slot.clamp(min=0).reshape(-1).long()]
        rows = rows.reshape(BS, O, spec.P, 4)
        center = fma(cc.float() + 0.5, vs, mn)
        # rank by distance to the voxel CUBE, center distance as tiebreak
        diff = torch.abs(rows[..., :3] - center[:, None, None, :])
        e = torch.clamp(diff - half, min=0.0)
        d2_cube = fma(e[..., 2], e[..., 2],
                      fma(e[..., 1], e[..., 1], e[..., 0] * e[..., 0]))
        d2_cent = fma(diff[..., 2], diff[..., 2],
                      fma(diff[..., 1], diff[..., 1],
                          diff[..., 0] * diff[..., 0]))
        d2 = fma(d2_cent, 1e-3, d2_cube)
        bad = (nb_slot[..., None] < 0) | (d2_cent > 1.0e15)
        d2 = torch.where(bad, 3.0e38, d2).reshape(BS, O * spec.P)
        rows = rows.reshape(BS, O * spec.P, 4)
        d2s, arg = torch.sort(d2, dim=1, stable=True)
        d2s, arg = d2s[:, :k], arg[:, :k]
        sel = torch.gather(rows, 1, arg[..., None].expand(BS, k, 4))
        sel = torch.where((d2s < 1.0e15)[..., None], sel, 1.0e8)
        if k < P2:
            sel = torch.cat([sel, torch.full((BS, P2 - k, 4), 1.0e8,
                                             device=dev)], dim=1)
        return torch.cat([sel[..., 0], sel[..., 1], sel[..., 2],
                          sel[..., 3]], dim=-1)

    blocks = [block(occ_coords[s0:min(s0 + _SUPER_BLOCK, n_live)])
              for s0 in range(0, n_live, _SUPER_BLOCK)]
    if n_live < spec.max_o:
        empty = block(occ_coords[n_live:n_live + 1])
        blocks.append(empty.expand(spec.max_o - n_live, -1))
    super_xyz = torch.cat(blocks, dim=0)

    # dilated voxel -> NEAREST occupied slot in the query_size window
    vol = spec.grid_size_vol
    slot_map = torch.full((vol,), -1, dtype=torch.int32, device=dev)
    slot_map[head_lin] = head_slot
    slot_map = slot_map.reshape(spec.vdim)
    q = spec.query_size
    qoffs = np.stack(np.meshgrid(
        *[np.arange(-((qq - 1) // 2), qq // 2 + 1) for qq in q],
        indexing="ij"), axis=-1).reshape(-1, 3)
    qoffs = qoffs[np.argsort(np.sum(qoffs.astype(np.float64) ** 2, -1),
                             kind="stable")]
    adopt = slot_map
    for off in qoffs[1:]:                    # (0,0,0) first = own slot
        adopt = torch.where(adopt >= 0, adopt, _shift3(slot_map, off))
    return {"super_xyz": super_xyz, "coor_slot": adopt.reshape(-1)}
