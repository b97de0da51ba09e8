"""The arithmetic of the per-layer metrics, one function a family; each
file of gpubench/metrics/ names the traffic kind it reads and calls one
of these. A reader returns None where the run has nothing for it to
read: another kind of traffic, no rows, no device time.

The model's arithmetic comes in the context from the cell's mix
(`mix.model`): `passes` counts the forwards a unit's rows run (a train
step's forward and backward as three).
"""

from __future__ import annotations

from typing import Optional

from .layers import layer_seconds
from .peaks import mfu_pct, trunk_bound_s, trunk_bytes


def mfu(ctx, kind: str) -> Optional[float]:
    """Model FLOPs the window's rows need, as a share of the card's TF32
    dense peak over the window: the trunk (block1, block3, the alpha head)
    on every (shading row, neighbor) row the reference counts as shaded
    and the colour head on every such shading row, 2 FLOPs a
    multiply-add."""
    if ctx["kind"] != kind or ctx["window_rows"][0] == 0:
        return None
    nb, sh = ctx["window_rows"]
    flops = ctx["passes"] * 2.0 * (nb * ctx["trunk_macs"]
                                  + sh * ctx["head_macs"])
    return mfu_pct(flops, ctx["window_s"])


def trunk_roofline(ctx, kind: str) -> Optional[float]:
    """The fused trunk's share of its roofline in the traced slice: the
    least time the card could take for the trunk work of the slice's
    shaded rows (`peaks.trunk_bound_s`), over K1's (and in training K2's)
    device time."""
    t = layer_seconds(ctx["slice"]["families"], "trunk")
    nb, sh = ctx["slice_rows"]
    if ctx["kind"] != kind or t <= 0 or nb == 0:
        return None
    n = ctx["passes"]
    nbytes = n * trunk_bytes(nb, sh, ctx["point_features"],
                             ctx["trunk_width"])
    return 100.0 * trunk_bound_s(n * nb * ctx["trunk_macs"], nbytes) / t


def layer_ms(ctx, kind: str, layer: str) -> Optional[float]:
    """Device time a step or an image of the layer's kernel families
    (`layers.LAYERS`), in the traced slice."""
    t = layer_seconds(ctx["slice"]["families"], layer)
    if ctx["kind"] != kind or t <= 0 or ctx["slice_units"] == 0:
        return None
    return 1e3 * t / ctx["slice_units"]


def idle_pct(ctx, kind: str) -> Optional[float]:
    """Share of the traced slice's wall time in which no kernel or copy
    ran on the card (100 less the union of their intervals)."""
    s = ctx["slice"]
    if ctx["kind"] != kind or s["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["wall_s"])


def peak_gib(ctx, kind: str) -> Optional[float]:
    """torch.cuda.max_memory_allocated over the window, reset at its
    start."""
    if ctx["kind"] != kind or ctx["window_peak_bytes"] <= 0:
        return None
    return ctx["window_peak_bytes"] / 2 ** 30
