"""The [S, 42] → [cap, 42] point-gradient scatter floor, on the card
(counterpart of `scripts/scatter_pallas.py`).

Times, on the JAX script's inputs (RandomState(0): S rows into `cap` slots,
each slot drawn `dup` times on average):

  kernel   `ops.scatter.scatter_add_rows` on CUDA: K6, `csrc/scatter_rows.cu`
           (replaces the script's Pallas kernel, the VMEM-resident
           accumulator)
  plain    `scatter_add_rows_reference`, an accumulating index_put_
  base     the script's `base` (XLA's scatter-add) in torch: one
           `torch.zeros(cap, C).index_add_(0, idx, upd)`, the library call
           computing the same function (the port never calls it)
  banks    the script's bank split in torch: index_add_ into [NB·cap, C]
           at (i % NB)·cap + idx, then a sum over the NB banks

and checks each against np.add.at. Prints one JSON line with the script's
keys (S, cap, C, dup, banks, backend, {name}_maxerr, {name}_ms).

Run:  python -m pointnerf_tpu_torch.scripts.scatter_pallas [--S 384000]
          [--cap 102400] [--C 42] [--dup 6] [--banks 8] [--reps 20]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def script_inputs(S: int, cap: int, C: int, dup: float):
    """idx [S] int32, upd [S, C] float32 as the JAX script draws them."""
    rng = np.random.RandomState(0)
    uniq = max(1, int(S / dup))
    pool = rng.choice(cap, uniq, replace=False)
    idx = pool[rng.randint(0, uniq, S)].astype(np.int32)
    upd = rng.uniform(-1, 1, (S, C)).astype(np.float32)
    return idx, upd


def bank_scatter(idx: torch.Tensor, upd: torch.Tensor, cap: int,
                 banks: int) -> torch.Tensor:
    lane = torch.arange(idx.shape[0], device=idx.device) % banks
    out = torch.zeros((banks * cap, upd.shape[1]), dtype=upd.dtype,
                      device=upd.device)
    out.index_add_(0, lane * cap + idx.long(), upd)
    return out.reshape(banks, cap, -1).sum(0)


def time_ms(fn, reps: int, dev: torch.device) -> float:
    """Mean ms per call after one warm-up: CUDA events on the card, the
    host clock on the CPU."""
    fn()
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e3 * (time.perf_counter() - t0) / reps


def main(argv=None) -> dict:
    from ..ops.scatter import scatter_add_rows, scatter_add_rows_reference
    ap = argparse.ArgumentParser()
    ap.add_argument("--S", type=int, default=384000)
    ap.add_argument("--cap", type=int, default=102400)
    ap.add_argument("--C", type=int, default=42)
    ap.add_argument("--dup", type=float, default=6.0)
    ap.add_argument("--banks", type=int, default=8)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    S, cap, C = args.S, args.cap, args.C
    idx_np, upd_np = script_inputs(S, cap, C, args.dup)
    want = np.zeros((cap, C), np.float32)
    np.add.at(want, idx_np, upd_np)
    idx = torch.as_tensor(idx_np, device=dev)
    upd = torch.as_tensor(upd_np, device=dev)
    results = {"S": S, "cap": cap, "C": C, "dup": args.dup,
               "banks": args.banks,
               "backend": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu")}
    fns = {
        "kernel": lambda: scatter_add_rows(idx, upd, cap),
        "plain": lambda: scatter_add_rows_reference(idx, upd, cap),
        "base": lambda: torch.zeros((cap, C), device=dev).index_add_(
            0, idx.long(), upd),
        "banks": lambda: bank_scatter(idx, upd, cap, args.banks),
    }
    for name, fn in fns.items():
        got = fn().cpu().numpy()
        results[f"{name}_maxerr"] = float(np.abs(got - want).max())
        if not results[f"{name}_maxerr"] < 1e-3:
            raise AssertionError(f"{name} differs from np.add.at by "
                                 f"{results[f'{name}_maxerr']}")
    for name, fn in fns.items():
        results[f"{name}_ms"] = time_ms(fn, args.reps, dev)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
