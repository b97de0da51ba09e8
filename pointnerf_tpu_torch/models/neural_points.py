"""Neural point cloud state: fixed-capacity buffers with an active-slot mask.

PyTorch port of `pointnerf_tpu/models/neural_points.py`: building the
padded state, gathering neighbor attributes, and the masked prune and grow.
Padded slots sit at SENTINEL, far outside every grid range, with conf 0.
Prune and grow write the buffers in place (under no_grad), so an optimizer
that holds them as parameters keeps them; the JAX package returns new
arrays instead.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.scatter import scatter_add_rows

SENTINEL = 1.0e6  # parked position for inactive slots (outside any scene range)


def round_capacity(n: int, multiple: int = 4096) -> int:
    return int(max(multiple, -(-n // multiple) * multiple))


def create_point_cloud(xyz: np.ndarray,
                       embedding: np.ndarray,
                       color: Optional[np.ndarray] = None,
                       direction: Optional[np.ndarray] = None,
                       conf: Optional[np.ndarray] = None,
                       Rw2c: Optional[np.ndarray] = None,
                       capacity: Optional[int] = None,
                       device="cuda") -> Dict[str, Optional[torch.Tensor]]:
    """Build the padded state dict from host arrays: xyz [N,3], embedding
    [N,C], color/direction [N,3], conf [N,1], Rw2c [3,3] (identity if
    None) or per point [N,3,3] (scene editing; the padding slots take the
    identity), on `device` (the card unless the caller names another)."""
    n = xyz.shape[0]
    cap = capacity or round_capacity(n)
    if cap < n:
        raise ValueError(f"capacity {cap} < {n} points")

    def pad(a, fill=0.0):
        out = np.full((cap,) + a.shape[1:], fill, dtype=np.float32)
        out[:n] = a
        return torch.as_tensor(out, device=device)

    def opt_pad(a):
        return None if a is None else pad(np.asarray(a, np.float32))

    if Rw2c is None:
        Rw2c = np.eye(3, dtype=np.float32)
    Rw2c = np.asarray(Rw2c, np.float32)
    if Rw2c.ndim == 3:
        if Rw2c.shape[0] != n:
            raise ValueError(f"per-point Rw2c has {Rw2c.shape[0]} rows for "
                             f"{n} points")
        out = np.tile(np.eye(3, dtype=np.float32), (cap, 1, 1))
        out[:n] = Rw2c
        Rw2c = out
    return {
        "xyz": pad(np.asarray(xyz, np.float32), SENTINEL),
        "embedding": pad(np.asarray(embedding, np.float32)),
        "mask": torch.as_tensor(np.arange(cap) < n, device=device),
        "color": opt_pad(color),
        "dir": opt_pad(direction),
        "conf": opt_pad(conf),
        "Rw2c": torch.as_tensor(Rw2c, device=device),
    }


def num_active(state: Dict) -> torch.Tensor:
    return state["mask"].sum(dtype=torch.int32)


@torch.no_grad()
def prune(state: Dict, thresh: float) -> Dict:
    """Deactivate the slots whose conf is below `thresh` and park them at
    SENTINEL (reference: neural_points.py:347-370), in place; returns
    `state`."""
    keep = state["mask"] & (state["conf"][:, 0] >= thresh)
    state["mask"].copy_(keep)
    state["xyz"][~keep] = SENTINEL
    return state


@torch.no_grad()
def grow(state: Dict, add_xyz, add_embedding, add_color, add_dir, add_conf,
         add_mask) -> Tuple[Dict, int]:
    """Write candidates into free slots (reference: neural_points.py:373-
    399), in place. add_* [M, ...] tensors, add_mask [M] marks the real
    ones. The k-th real candidate goes to the k-th free slot in index order
    (the JAX package's cumsum ranking); those past the free slots are
    dropped and counted. Returns (state, n_dropped). A reused slot's other
    buffers (and any optimizer moments) keep what the pruned point left."""
    mask = state["mask"]
    free_slots = torch.nonzero(~mask).reshape(-1)
    add_mask = add_mask.to(device=mask.device, dtype=torch.bool)
    cand_rank = torch.cumsum(add_mask.to(torch.int64), 0) - 1
    ok = add_mask & (cand_rank < free_slots.shape[0])
    target = free_slots[cand_rank[ok]]
    for k, add in (("xyz", add_xyz), ("embedding", add_embedding),
                   ("color", add_color), ("dir", add_dir), ("conf", add_conf)):
        if state.get(k) is not None:
            buf = state[k]
            buf[target] = add.to(device=buf.device, dtype=buf.dtype)[ok]
    mask[target] = True
    return state, int(add_mask.sum()) - int(ok.sum())


class _GatherRows(torch.autograd.Function):
    """rows = table[idx] whose backward is one row scatter-add into the
    [N, C] table (`ops.scatter.scatter_add_rows`: K6 on the card, an
    accumulating index_put_ on the CPU). Missing neighbors read row 0, so
    most of idx can be 0, and a run of one index serializes (index_put_ on
    the card) or contends (K6's atomics): the missing rows' gradients are
    summed apart, one column sum added to row 0, and their slots are passed
    to the scatter as -1, which it skips."""

    @staticmethod
    def forward(ctx, table, idx, present):
        ctx.save_for_backward(idx, present)
        ctx.n_rows = table.shape[0]
        return table[idx]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, ct):
        idx, present = ctx.saved_tensors
        d = scatter_add_rows(torch.where(present, idx, -1), ct, ctx.n_rows)
        keep = present[:, None].to(ct.dtype)
        d[0] += torch.sum(ct * (1.0 - keep), dim=0)
        return d, None, None


def gather_neighbors(state: Dict, sample_pidx: torch.Tensor,
                     camrotc2w: torch.Tensor, campos: torch.Tensor):
    """Gather per-neighbor attributes for the aggregator.

    sample_pidx: [B,R,SR,K] int32 (-1 = missing). All point attributes are
    packed into one [N, C] row table and gathered once (differentiable in
    the trainable buffers; see _GatherRows); the perspective coordinates are
    computed for the gathered points only. A per-point Rw2c [N,3,3] (scene
    editing) is gathered per neighbor, [B,R,SR,K,3,3]; a missing neighbor
    reads point 0's, as it reads its other attributes.
    """
    B = sample_pidx.shape[0]
    shape = tuple(sample_pidx.shape)
    if campos.shape[0] != B:
        # the compacted leading dim is B·G: tile the poses over the groups
        rep = B // campos.shape[0]
        campos = campos.repeat_interleave(rep, dim=0)
        camrotc2w = camrotc2w.repeat_interleave(rep, dim=0)
    safe = sample_pidx.clamp(min=0).reshape(-1).long()
    pnt_mask = sample_pidx >= 0

    parts = [("xyz", 3), ("embedding", state["embedding"].shape[1])]
    for k in ("color", "dir", "conf"):
        if state[k] is not None:
            parts.append((k, state[k].shape[1]))
    packed = torch.cat([state[k] for k, _ in parts], dim=1)
    if torch.is_grad_enabled() and packed.requires_grad:
        rows = _GatherRows.apply(packed, safe, pnt_mask.reshape(-1))
    else:
        rows = packed[safe]
    rows = rows.reshape(shape + (packed.shape[1],))
    split, off = {}, 0
    for k, w in parts:
        split[k] = rows[..., off:off + w]
        off += w

    xyz = split["xyz"]                                   # [B,R,SR,K,3]
    shift = xyz - campos.reshape(B, 1, 1, 1, 3)
    rot_t = camrotc2w.transpose(-1, -2).reshape(B, 1, 1, 1, 3, 3)
    xyz_c = torch.sum(shift[..., None, :] * rot_t, dim=-1)
    xyz_pers = torch.stack([xyz_c[..., 0] / xyz_c[..., 2],
                            xyz_c[..., 1] / xyz_c[..., 2],
                            xyz_c[..., 2]], dim=-1)
    rw2c = state["Rw2c"]
    if rw2c.dim() == 3:
        rw2c = rw2c.reshape(-1, 9)[safe].reshape(shape + (3, 3))
    return {
        "sampled_xyz": xyz,
        "sampled_xyz_pers": xyz_pers,
        "sampled_embedding": split["embedding"],
        "sampled_color": split.get("color"),
        "sampled_dir": split.get("dir"),
        "sampled_conf": split.get("conf"),
        "sample_pnt_mask": pnt_mask,
        "Rw2c": rw2c,
    }
