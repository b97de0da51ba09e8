"""The voxel grid over a point cloud, worked out again from the cloud.

A frozen copy of the plain path of `pointnerf_tpu_torch/ops/grid.py`
(`make_grid_spec`, `build_grid` with its per-voxel candidate supersets),
cut to the world-coordinate query: the same expressions in the same
order, so that the occupancy decisions and the neighbor candidates equal
the port's bit for bit. It imports nothing of the port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

SUPER_BLOCK = 4096   # occupied slots per candidate block


@dataclass(frozen=True)
class Spec:
    ranges_min: Tuple[float, float, float]
    scaled_vsize: Tuple[float, float, float]
    vdim: Tuple[int, int, int]
    max_o: int
    P: int
    kernel_size: Tuple[int, int, int]
    query_size: Tuple[int, int, int]
    radius_limit: float
    vsize: Tuple[float, float, float]
    superset_P: int

    @property
    def vol(self) -> int:
        return int(self.vdim[0]) * int(self.vdim[1]) * int(self.vdim[2])


def make_spec(o: Dict, xyz: torch.Tensor) -> Spec:
    """The grid's geometry from the options `o` and the live points' bounds
    (the port's `run.common.make_spec_and_grid`)."""
    host = xyz.detach().cpu().numpy()
    vsize = np.asarray(o["vsize"], np.float64)
    vscale = np.asarray(o["vscale"], np.float64)
    scaled = vsize * vscale
    kernel = np.asarray(o["kernel_size"], np.int32)
    ranges = np.asarray(o["ranges"], np.float64)
    mn = np.maximum(np.asarray(host.min(0), np.float64), ranges[:3])
    mx = np.minimum(np.asarray(host.max(0), np.float64), ranges[3:])
    mn = mn - scaled * kernel / 2.0
    mx = mx + scaled * kernel / 2.0
    vdim = np.ceil((mx - mn) / vsize / vscale).astype(np.int32)
    query = tuple(o["query_size"]) if o["query_size"][0] != 0 \
        else tuple(o["kernel_size"])
    return Spec(tuple(float(v) for v in mn), tuple(float(v) for v in scaled),
                tuple(int(v) for v in vdim), int(o["max_o"]), int(o["P"]),
                tuple(int(k) for k in o["kernel_size"]),
                tuple(int(q) for q in query),
                float(o["radius_limit_scale"] * max(o["vsize"][0],
                                                     o["vsize"][1])),
                tuple(float(v) for v in vsize), int(o["superset_P"]))


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a·b + c rounded once (through float64)."""
    a64 = a.double()
    b64 = b.double() if torch.is_tensor(b) else b
    c64 = c.double() if torch.is_tensor(c) else c
    return (a64 * b64 + c64).float()


def consts(spec: Spec, device):
    mn = torch.tensor(spec.ranges_min, dtype=torch.float32, device=device)
    inv = 1.0 / torch.tensor(spec.scaled_vsize, dtype=torch.float32,
                             device=device)
    return mn, inv


def voxel_coords(xyz: torch.Tensor, spec: Spec):
    mn, inv = consts(spec, xyz.device)
    coords = torch.floor((xyz - mn) * inv).to(torch.int32)
    vdim = torch.tensor(spec.vdim, dtype=torch.int32, device=xyz.device)
    return coords, torch.all((coords >= 0) & (coords < vdim), dim=-1)


def linearize(coords: torch.Tensor, spec: Spec) -> torch.Tensor:
    _, vy, vz = spec.vdim
    return coords[..., 0] * (vy * vz) + coords[..., 1] * vz + coords[..., 2]


def _shift3(a: torch.Tensor, off) -> torch.Tensor:
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


@torch.no_grad()
def build(xyz: torch.Tensor, mask: torch.Tensor, spec: Spec
          ) -> Dict[str, torch.Tensor]:
    """coor_occ (dilated occupancy per voxel, int8), coor_slot (each
    dilated voxel's nearest occupied slot) and super_xyz (each slot's
    superset_P nearest candidates, [x|y|z|index] blocks), num_occ."""
    if spec.vol >= 2 ** 31:
        raise ValueError(f"grid {spec.vdim} is past a 32-bit index")
    dev = xyz.device
    N, vol = xyz.shape[0], spec.vol
    coords, inb = voxel_coords(xyz, spec)
    valid = inb & mask
    lin = torch.where(valid, linearize(coords, spec),
                      torch.full_like(coords[:, 0], vol))
    sorted_lin, order = torch.sort(lin, stable=True)
    sorted_valid = sorted_lin < vol
    head = torch.cat([sorted_valid[:1],
                      (sorted_lin[1:] != sorted_lin[:-1]) & sorted_valid[1:]])
    slot = torch.cumsum(head.to(torch.int32), 0, dtype=torch.int32) - 1
    idx = torch.arange(N, dtype=torch.int32, device=dev)
    rank = idx - torch.cummax(torch.where(head, idx, 0), 0).values
    keep = sorted_valid & (slot < spec.max_o)
    kh = keep & head
    head_lin = sorted_lin[kh].long()
    head_slot = slot[kh]
    coor_2_occ = torch.full((vol,), -1, dtype=torch.int32, device=dev)
    coor_2_occ[head_lin] = head_slot

    keep_p = keep & (rank < spec.P)
    flat = (slot * spec.P + rank)[keep_p].long()
    payload = torch.cat([xyz[order][keep_p],
                         order[keep_p].to(xyz.dtype)[:, None]], dim=-1)
    occ_2_xyz = torch.full((spec.max_o * spec.P, 4), 1.0e8, dtype=xyz.dtype,
                           device=dev)
    occ_2_xyz[flat] = payload
    occ_2_xyz = occ_2_xyz.reshape(spec.max_o, spec.P, 4)

    occ = torch.zeros(vol, dtype=torch.float32, device=dev)
    occ[head_lin] = 1.0
    pad = []
    for q in reversed(spec.query_size):
        pad += [(q - 1) // 2, q // 2]
    occ3 = F.pad(occ.reshape((1, 1) + tuple(spec.vdim)), pad)
    coor_occ = F.max_pool3d(occ3, kernel_size=tuple(spec.query_size),
                            stride=1).reshape(-1).to(torch.int8)
    out = {"coor_occ": coor_occ, "num_occ": head.sum(dtype=torch.int32)}
    out.update(_supersets(coords[order][kh], head_lin, head_slot, coor_2_occ,
                          occ_2_xyz, spec))
    return out


def _supersets(head_coords, head_lin, head_slot, coor_2_occ, occ_2_xyz,
               spec: Spec) -> Dict[str, torch.Tensor]:
    dev = coor_2_occ.device
    P2 = spec.superset_P
    occ_coords = torch.zeros((spec.max_o, 3), dtype=torch.int32, device=dev)
    occ_coords[head_slot.long()] = head_coords
    n_live = head_slot.shape[0]
    lx = (spec.kernel_size[0] + 1) // 2 - 1
    ax = [np.arange(-lx, lx + 1)] * 3
    offs = torch.as_tensor(np.stack(np.meshgrid(*ax, indexing="ij"), axis=-1)
                           .reshape(-1, 3).astype(np.int32), device=dev)
    O = offs.shape[0]
    vdim = torch.tensor(spec.vdim, dtype=torch.int32, device=dev)
    mn = torch.tensor(spec.ranges_min, dtype=torch.float32, device=dev)
    vs = torch.tensor(spec.scaled_vsize, dtype=torch.float32, device=dev)
    half = torch.full((3,), 0.5, dtype=torch.float32, device=dev) * vs
    flat_tiles = occ_2_xyz.reshape(spec.max_o, spec.P * 4)
    k = min(P2, O * spec.P)

    def block(cc):
        BS = cc.shape[0]
        nb = cc[:, None, :] + offs
        nb_in = torch.all((nb >= 0) & (nb < vdim), dim=-1)
        nb_lin = torch.where(nb_in, linearize(nb, spec), 0).long()
        nb_slot = torch.where(nb_in, coor_2_occ[nb_lin], -1)
        rows = flat_tiles[nb_slot.clamp(min=0).reshape(-1).long()]
        rows = rows.reshape(BS, O, spec.P, 4)
        center = fma(cc.float() + 0.5, vs, mn)
        # rank by distance to the voxel cube, the centre distance breaking ties
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

    blocks = [block(occ_coords[s0:min(s0 + SUPER_BLOCK, n_live)])
              for s0 in range(0, n_live, SUPER_BLOCK)]
    if n_live < spec.max_o:
        blocks.append(block(occ_coords[n_live:n_live + 1])
                      .expand(spec.max_o - n_live, -1))
    super_xyz = torch.cat(blocks, dim=0)

    slot_map = torch.full((spec.vol,), -1, dtype=torch.int32, device=dev)
    slot_map[head_lin] = head_slot
    slot_map = slot_map.reshape(spec.vdim)
    qoffs = np.stack(np.meshgrid(
        *[np.arange(-((q - 1) // 2), q // 2 + 1) for q in spec.query_size],
        indexing="ij"), axis=-1).reshape(-1, 3)
    qoffs = qoffs[np.argsort(np.sum(qoffs.astype(np.float64) ** 2, -1),
                             kind="stable")]
    adopt = slot_map
    for off in qoffs[1:]:
        adopt = torch.where(adopt >= 0, adopt, _shift3(slot_map, off))
    return {"super_xyz": super_xyz, "coor_slot": adopt.reshape(-1)}
