"""Neural point cloud state: fixed-capacity buffers with an active-slot mask.

PyTorch port of `pointnerf_tpu/models/neural_points.py` (the serving side:
building the padded state and gathering neighbor attributes). Padded slots
sit at SENTINEL, far outside every grid range, with conf 0.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

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
    [N,C], color/direction [N,3], conf [N,1], Rw2c [3,3] (identity if None),
    on `device` (the card unless the caller names another)."""
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
    if Rw2c.ndim != 2:
        raise NotImplementedError("per-point Rw2c (scene editing) is not "
                                  "ported")
    return {
        "xyz": pad(np.asarray(xyz, np.float32), SENTINEL),
        "embedding": pad(np.asarray(embedding, np.float32)),
        "mask": torch.as_tensor(np.arange(cap) < n, device=device),
        "color": opt_pad(color),
        "dir": opt_pad(direction),
        "conf": opt_pad(conf),
        "Rw2c": torch.as_tensor(Rw2c, device=device),
    }


class _GatherRows(torch.autograd.Function):
    """rows = table[idx] whose backward is one accumulating index_put_ into
    the [N, C] table. Missing neighbors read row 0, so most of idx can be 0;
    an accumulating index_put_ sums each run of one index serially on the
    card, so the missing rows' gradients are summed apart (one column sum,
    added to row 0) and their index slots spread over the table with zero
    gradients. The result is the plain scatter-add's, in a fixed order."""

    @staticmethod
    def forward(ctx, table, idx, present):
        ctx.save_for_backward(idx, present)
        ctx.n_rows = table.shape[0]
        return table[idx]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, ct):
        idx, present = ctx.saved_tensors
        keep = present[:, None].to(ct.dtype)
        spread = torch.arange(idx.shape[0], device=idx.device) % ctx.n_rows
        d = torch.zeros((ctx.n_rows, ct.shape[1]), dtype=ct.dtype,
                        device=ct.device)
        d.index_put_((torch.where(present, idx, spread),), ct * keep,
                     accumulate=True)
        d[0] += torch.sum(ct * (1.0 - keep), dim=0)
        return d, None, None


def gather_neighbors(state: Dict, sample_pidx: torch.Tensor,
                     camrotc2w: torch.Tensor, campos: torch.Tensor):
    """Gather per-neighbor attributes for the aggregator.

    sample_pidx: [B,R,SR,K] int32 (-1 = missing). All point attributes are
    packed into one [N, C] row table and gathered once (differentiable in
    the trainable buffers; see _GatherRows); the perspective coordinates are
    computed for the gathered points only.
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
    return {
        "sampled_xyz": xyz,
        "sampled_xyz_pers": xyz_pers,
        "sampled_embedding": split["embedding"],
        "sampled_color": split.get("color"),
        "sampled_dir": split.get("dir"),
        "sampled_conf": split.get("conf"),
        "sample_pnt_mask": pnt_mask,
        "Rw2c": state["Rw2c"],
    }
