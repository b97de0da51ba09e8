"""Row scatter-add, the point-gradient scatter of every train step (K6).

`scatter_add_rows(idx, upd, n_rows)` returns out [n_rows, C] with
out[idx[i]] += upd[i] over a zeroed table, entries whose index is negative
skipped. It is the backward of the packed point-attribute gather
(`models/neural_points._GatherRows`). On CUDA tensors it makes one call into
`csrc/scatter_rows.cu` (replaces `scripts/scatter_pallas.py::pallas_scatter`,
kernel `_kernel` :68), which zeroes the table and launches the kernel on the
current stream: the indices go in as they come, int32 or int64, with no
conversion, and each warp walks only the kept entries of its 32. On CPU
tensors it runs `scatter_add_rows_reference`, an accumulating `index_put_`
in a fixed order.

The kernel sums with float atomics, so on the card the result differs from
launch to launch in the last bits; the plain version's order is fixed.
An index at or past n_rows is an error on both routes: the plain version's
index_put_ raises, and the kernel traps (reported at the next synchronising
call, as index_put_'s own device-side assert is on CUDA).
"""

from __future__ import annotations

import torch

from . import kernels


def scatter_add_rows_reference(idx: torch.Tensor, upd: torch.Tensor,
                               n_rows: int) -> torch.Tensor:
    """The plain version: skipped entries are spread over the table with
    zero updates (an accumulating index_put_ sums a run of one index
    serially, so parking them all on one row would serialize them)."""
    keep = (idx >= 0)
    spread = torch.arange(idx.shape[0], device=idx.device) % n_rows
    out = torch.zeros((n_rows, upd.shape[1]), dtype=upd.dtype,
                      device=upd.device)
    out.index_put_((torch.where(keep, idx.long(), spread),),
                   upd * keep[:, None].to(upd.dtype), accumulate=True)
    return out


def scatter_add_rows(idx: torch.Tensor, upd: torch.Tensor,
                     n_rows: int) -> torch.Tensor:
    """idx [S] integer (negative = skip), upd [S, C] float32 → [n_rows, C]:
    K6 on CUDA tensors, the plain version on CPU tensors."""
    if upd.device.type == "cpu":
        return scatter_add_rows_reference(idx, upd, n_rows)
    if upd.device.type != "cuda":
        raise ValueError(f"scatter_add_rows runs on cpu or cuda, not "
                         f"{upd.device}")
    dev = upd.device
    S, C = upd.shape
    if idx.dtype not in (torch.int32, torch.int64):
        idx = idx.to(torch.int32)
    idx = idx.contiguous()
    upd = upd.contiguous()
    if upd.data_ptr() % 8:            # pairs of columns go out as float2
        upd = upd.clone()
    kernels.require(idx, "idx", idx.dtype, dev, (S,))
    kernels.require(upd, "upd", torch.float32, dev, (S, C))
    out = torch.empty((n_rows, C), dtype=torch.float32, device=dev)
    err = kernels.library().scatter_rows(
        idx.data_ptr(), upd.data_ptr(), out.data_ptr(), S, C, n_rows,
        idx.element_size(), kernels.stream_handle(upd))
    kernels.check(err, kernels.SCATTER_ROWS)
    kernels.SCATTER_ROWS.launches += 1
    return out
