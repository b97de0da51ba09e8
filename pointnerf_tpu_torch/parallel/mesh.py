"""Rank layout, batch placement and collectives (port of
`pointnerf_tpu/parallel/mesh.py`).

The JAX package lays its devices out as a ("batch", "rays"[, "points"])
mesh and lets GSPMD place the data. Here each device is one process of a
`torch.distributed` group, and the same layout is written out: with n
ranks, `points` point shards and nr = n / points ray shards, b =
gcd(batch_size, nr) batch shards, a rank's place is (batch, rays, points)
in `arange(n).reshape(b, nr // b, points)`, so rank = ray_index · points
+ point_index, where ray_index = batch_index · (nr // b) + the rays
coordinate. The ranks that share a ray index hold the same rays and
different point shards (`points_group`); the ranks that share a point
index hold different rays (`plane_group`).

Every value that steers the program (loss items, counters, rendered
images, reduced gradients) is summed or gathered from the ranks of point
index 0 in ray order, after one all-gather over the whole group, so every
rank holds the same bits whatever the backend's reduction order.

The frustum and vox-grid queries compact each camera row into one budget
across its ray shards: `Mesh.shards` gives the renderer a rank's place
and `row_prefix`, the exclusive prefix of a per-row count over the ray
shards before it in the same camera rows (one all-gather of B int32s per
rank, in the same way), so a rank keeps the rows the whole batch keeps.

The collectives use the backend's own ops: NCCL on the card, gloo on the
CPU. CUDA tensors are staged through host memory only when the group's
backend is gloo (several ranks sharing one card, which NCCL refuses);
the choice is made by the backend's name.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

# batch keys with a ray axis at dim 1, [B, R, ...]; the per-camera keys
# [B, ...] split only over the batch; everything else is whole on every rank
RAY_AXIS_KEYS = frozenset({
    "raydir", "gt_image", "pixel_idx", "bg_ray", "gt_mask", "gt_depth",
})
PER_CAMERA_KEYS = frozenset({
    "campos", "camrotc2w", "intrinsic", "bg_color",
})


def layout(n_devices: int, batch_size: int = 1, points: int = 1
           ) -> np.ndarray:
    """The ranks arranged as JAX's mesh arranges its devices: [b, nr // b]
    with points == 1, else [b, nr // b, points]. ValueError if points does
    not divide n_devices."""
    if points < 1 or n_devices % points:
        raise ValueError(f"--mesh_points {points} must divide the "
                         f"{n_devices} devices")
    nr = n_devices // points
    b = math.gcd(int(batch_size), nr)
    ranks = np.arange(n_devices)
    if points > 1:
        return ranks.reshape(b, nr // b, points)
    return ranks.reshape(b, nr // b)


@dataclass
class Mesh:
    """This rank's place in the layout and the groups it reduces over."""
    shape: Dict[str, int]               # axis name → size, JAX's order
    rank: int
    device: torch.device
    backend: str
    plane_group: object = field(repr=False)    # same point index
    points_group: object = field(repr=False)   # same ray index

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    @property
    def points(self) -> int:
        return self.shape.get("points", 1)

    @property
    def rays(self) -> int:
        """Ray shards per batch shard (JAX's mesh.shape["rays"])."""
        return self.shape["rays"]

    @property
    def batch(self) -> int:
        return self.shape["batch"]

    @property
    def ray_index(self) -> int:
        return self.rank // self.points

    @property
    def point_index(self) -> int:
        return self.rank % self.points

    @property
    def plane(self) -> int:
        """Distinct ray shards: batch × rays."""
        return self.batch * self.rays

    @property
    def staged(self) -> bool:
        return self.backend == "gloo" and self.device.type == "cuda"

    # ----------------------------------------------------------- collectives
    def _gather(self, x: torch.Tensor, group, n: int) -> torch.Tensor:
        """[n, *x.shape]: x of every rank of `group`, in rank order (bool
        travels as uint8)."""
        src = x.reshape(-1)
        if src.dtype == torch.bool:
            src = src.to(torch.uint8)
        if self.staged:
            src = src.cpu()
        out = torch.empty(n * src.numel(), dtype=src.dtype,
                          device=src.device)
        dist.all_gather_into_tensor(out, src.contiguous(), group=group)
        return out.to(device=x.device, dtype=x.dtype).reshape(
            (n,) + tuple(x.shape))

    def gather_plane(self, x: torch.Tensor) -> torch.Tensor:
        """[plane, *x.shape]: x of the ranks of point index 0, in ray
        order (one all-gather over every rank)."""
        return self._gather(x, None, self.size)[::self.points]

    def plane_sum(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over the ray shards, in ray order; the same bits on
        every rank."""
        g = self.gather_plane(x)
        out = g[0].clone()
        for i in range(1, g.shape[0]):
            out += g[i]
        return out

    def row_prefix(self, counts: torch.Tensor, serving: bool = False
                   ) -> torch.Tensor:
        """counts [B] int32, one per camera row of this rank's piece,
        summed over the ray shards before it in the same camera rows (its
        batch shard's, or with `serving` every ray shard of the plane, one
        wide row); ranks that share a ray index get the same sums."""
        b, r = (1, self.plane) if serving else (self.batch, self.rays)
        g = self.gather_plane(counts).reshape((b, r) + tuple(counts.shape))
        bi, ri = divmod(self.ray_index, r)
        return g[bi, :ri].sum(dim=0, dtype=torch.int32)

    def shards(self, serving: bool = False):
        """This rank's place for the renderer (`ops.query.Shards`): the
        batch and ray shards, its ray coordinate and `row_prefix`. With
        `serving` the piece is one of the plane's ray shards of one wide
        camera row (mesh serving)."""
        from ..ops.query import Shards
        b, r = (1, self.plane) if serving else (self.batch, self.rays)
        return Shards(b, r, self.ray_index % r,
                      lambda c: self.row_prefix(c, serving))

    def gather_points(self, x: torch.Tensor) -> torch.Tensor:
        """The point shards of x along dim 0, joined over the ranks that
        share this rank's ray index."""
        if self.points == 1:
            return x
        g = self._gather(x, self.points_group, self.points)
        return g.reshape((-1,) + tuple(x.shape[1:]))

    def sum_rows(self, full: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        """This rank's point shard of each tensor of `full` (rows along dim
        0, columns joined for one gather) summed over the ranks that share
        its point index: the point gradients of the shard, from every ray
        shard's full-buffer gradients."""
        n = next(iter(full.values())).shape[0] // self.points
        rows = slice(self.point_index * n, (self.point_index + 1) * n)
        mine = torch.cat([v[rows].reshape(n, -1) for v in full.values()],
                         dim=1)
        g = self._gather(mine, self.plane_group, self.plane)
        out = g[0].clone()
        for i in range(1, g.shape[0]):
            out += g[i]
        res, off = {}, 0
        for k, v in full.items():
            w = v[rows].reshape(n, -1).shape[1]
            res[k] = out[:, off:off + w].reshape((n,) + tuple(v.shape[1:]))
            off += w
        return res

    def broadcast_object(self, obj=None):
        """rank 0's picklable `obj` on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, src=0,
                                   device=None if self.staged
                                   or self.device.type != "cuda"
                                   else self.device)
        return box[0]

    def broadcast_arrays(self, flat: Optional[Dict[str, np.ndarray]]
                         ) -> Dict[str, np.ndarray]:
        """rank 0's dict of numpy arrays on every rank: the layout as one
        object, the bytes as one broadcast."""
        meta = None
        if self.rank == 0:
            meta = [(k, v.dtype.str, v.shape) for k, v in flat.items()]
        meta = self.broadcast_object(meta)
        sizes = [int(np.prod(s)) * np.dtype(d).itemsize for _, d, s in meta]
        dev = torch.device("cpu") if self.staged else self.device
        if self.rank == 0:
            buf = torch.from_numpy(np.concatenate(
                [np.ascontiguousarray(flat[k]).reshape(-1).view(np.uint8)
                 for k, _, _ in meta] or [np.zeros(0, np.uint8)])).to(dev)
        else:
            buf = torch.empty(sum(sizes), dtype=torch.uint8, device=dev)
        dist.broadcast(buf, src=0)
        host = buf.cpu().numpy()
        out, off = {}, 0
        for (k, d, s), n in zip(meta, sizes):
            out[k] = host[off:off + n].view(np.dtype(d)).reshape(s).copy()
            off += n
        return out


def make_mesh(n_devices: Optional[int] = None, batch_size: int = 1,
              points: int = 1, device=None) -> Mesh:
    """The mesh of the initialized process group, for this rank.

    Every rank calls it, in the same order (it makes the subgroups).
    n_devices must be the group's size; device is this rank's device (the
    card of its local rank on CUDA, unless given)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized torch.distributed "
                           "process group (parallel.driver.launch)")
    n = dist.get_world_size()
    if n_devices is not None and int(n_devices) != n:
        raise ValueError(f"a mesh of {n_devices} devices over a group of {n}")
    arr = layout(n, batch_size, points)
    names = ("batch", "rays", "points") if points > 1 else ("batch", "rays")
    shape = dict(zip(names, arr.shape))
    rank = dist.get_rank()
    flat = arr.reshape(-1, points)              # [ray shards, points]
    plane_group = points_group = None
    for p in range(points):                     # same point index
        g = dist.new_group([int(r) for r in flat[:, p]]) if n > 1 else None
        if rank in flat[:, p]:
            plane_group = g
    for i in range(flat.shape[0]):              # same ray index
        g = dist.new_group([int(r) for r in flat[i]]) if n > 1 else None
        if rank in flat[i]:
            points_group = g
    if device is None:
        device = torch.device("cpu") if dist.get_backend() == "gloo" \
            else torch.device("cuda", torch.cuda.current_device())
    return Mesh(shape=shape, rank=rank, device=torch.device(device),
                backend=dist.get_backend(), plane_group=plane_group,
                points_group=points_group)


def _slices(mesh: Mesh, B: int, R: int):
    """This rank's (batch rows, rays) of a [B, R] batch."""
    nb, nr = mesh.batch, mesh.rays
    if B % nb or R % nr:
        raise ValueError(f"a batch of {B} x {R} rays does not split over "
                         f"{nb} batch x {nr} ray shards")
    bi, ri = divmod(mesh.ray_index, nr)
    return (slice(bi * B // nb, (bi + 1) * B // nb),
            slice(ri * R // nr, (ri + 1) * R // nr))


def shard_batch(batch: Dict, mesh: Mesh) -> Dict:
    """This rank's piece of a batch (JAX's `batch_pspec` placement): its
    ray slice of the ray keys, its batch rows of the per-camera keys, the
    rest (near, far, scalars) whole."""
    B, R = batch["raydir"].shape[:2]
    bs, rs = _slices(mesh, B, R)
    out = {}
    for k, v in batch.items():
        nd = getattr(v, "ndim", 0)
        if k in RAY_AXIS_KEYS and nd >= 2:
            out[k] = v[bs, rs]
        elif k in PER_CAMERA_KEYS and nd >= 1:
            out[k] = v[bs]
        else:
            out[k] = v
    return out


def shard_rays(u: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's [B, R, ...] slice of per-ray draws."""
    bs, rs = _slices(mesh, u.shape[0], u.shape[1])
    return u[bs, rs]


def unshard_rays(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole batch's [B, R, ...] tensor from every rank's piece."""
    g = mesh.gather_plane(x)                    # [plane, Bl, Rl, ...]
    g = g.reshape((mesh.batch, mesh.rays) + tuple(x.shape))
    g = g.transpose(1, 2)                       # [b, Bl, nr, Rl, ...]
    return g.reshape((mesh.batch * x.shape[0], mesh.rays * x.shape[1])
                     + tuple(x.shape[2:]))


def replicate(tree: Optional[Dict[str, torch.Tensor]], mesh: Mesh
              ) -> Dict[str, torch.Tensor]:
    """rank 0's dict of tensors (None elsewhere) on every rank's device."""
    flat = None
    if mesh.rank == 0:
        flat = {k: v.detach().cpu().numpy() for k, v in tree.items()}
    flat = mesh.broadcast_arrays(flat)
    return {k: torch.from_numpy(v).to(mesh.device) for k, v in flat.items()}
