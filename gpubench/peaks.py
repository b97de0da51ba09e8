"""The card's published peaks and the bound arithmetic of the trunk.

NVIDIA's H100 SXM data sheet, dense rates at the 700 W limit. The fused
trunk (K1 forward, K2 backward) issues each float32 multiply-add as
three TF32 tensor-core products (3xTF32), so its operations bound is
three products per multiply-add at the TF32 rate; bytes move at the HBM
rate (PERF.md §6's `trunk_bound`, copied).
"""

from __future__ import annotations

PEAK_TF32 = 495e12        # FLOP/s, TF32 tensor cores, dense
PEAK_BYTES = 3.35e12      # bytes/s, HBM3
TF32_PASSES = 3           # TF32 products per float32 multiply-add (3xTF32)


def trunk_bytes(neighbor_rows: float, shading_rows: float, features: int,
                width: int) -> float:
    """Bytes the trunk's forward must move: each (shading row, neighbor)
    row's inputs read once (its embedding, 6 distances, 7 colour and
    direction inputs, its weight) and each shading row's output (width
    features and alpha) written once, in float32."""
    return 4.0 * (neighbor_rows * (features + 6 + 7 + 1)
                  + shading_rows * (width + 1))


def trunk_bound_s(macs: float, nbytes: float) -> float:
    """Least seconds the card could take for `macs` trunk multiply-adds
    moving `nbytes`: the larger of the 3xTF32 products at the TF32 peak and
    the bytes at the memory rate."""
    return max(TF32_PASSES * 2.0 * macs / PEAK_TF32, nbytes / PEAK_BYTES)


def mfu_pct(flops: float, seconds: float) -> float:
    """Share of the TF32 dense peak that `flops` model FLOPs in `seconds`
    reach."""
    return 100.0 * flops / (seconds * PEAK_TF32)
