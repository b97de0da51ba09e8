"""The numbers that decide `correct`, each against its limit.

Train: the program's steps against the reference's on the same inputs
(the first step alone, then two whole dispatches, the second all graph
replays, as the window's are). `loss_gap`, the largest relative gap of a
step's total loss over every step; `grad_gap`, over the leaves, the gap
between the norms of the program's and the reference's first gradient,
against the reference's norm of that leaf or of the median leaf,
whichever is larger; over the leaves whose reference gradient is at
least a thousandth of the median leaf's (a smaller one moves under Adam
by round-off alone), `step_gap`, the median of the relative gaps between
the norms of each leaf's change over the steps, and `point_gap`, the
largest of them over the point leaves (embedding, colour, direction,
confidence: K6's and the point optimizer's); `point_grad_gap`, the
largest first-gradient gap over the point leaves (K6's scatter and the
backward into the points, before any Adam step). The worst leaf of the
weights is not compared: Adam moves an element whose gradient is near
zero by a whole step whichever its sign, so one such element of a small
leaf swings it from seed to seed (PERF.md). Over 17 steps the point
leaves' change is swung so too, on some inputs far more than on others:
`point_grad_gap` is the steadier number of the point leaves.

Render: `pixel_gap`, the widest gap of a colour channel over every pixel
of the images compared.
"""

from __future__ import annotations

import statistics
import sys
from typing import Dict, List

import numpy as np
import torch

TINY_GRAD = 1e-3      # share of the median leaf's gradient norm


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.norm(v.double())) for k, v in d.items()}


def _gap(prog: Dict[str, float], ref: Dict[str, float], keys) -> float:
    med = statistics.median(ref[k] for k in keys)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in keys)


def train_numbers(prog_losses: List[float], ref_losses: List[float],
                  prog_g1: Dict, ref_g1: Dict, prog_d: Dict,
                  ref_d: Dict) -> Dict[str, float]:
    """prog_losses/ref_losses: each step's total loss; prog_g1/ref_g1:
    each leaf's first gradient; prog_d/ref_d: each leaf's change over the
    steps."""
    from .reference.train import POINT_LEAVES
    if len(prog_losses) != len(ref_losses):
        raise ValueError(f"{len(prog_losses)} steps against the "
                         f"reference's {len(ref_losses)}")
    g_ref, g_prog = _norms(ref_g1), _norms(prog_g1)
    med = statistics.median(g_ref.values())
    moved = [k for k in g_ref if g_ref[k] >= TINY_GRAD * med]
    d_ref, d_prog = _norms(ref_d), _norms(prog_d)
    step = {k: abs(d_prog[k] - d_ref[k]) / max(d_ref[k], 1e-30)
            for k in moved}
    g_gap = {k: abs(g_prog[k] - g_ref[k]) / max(g_ref[k], med, 1e-30)
             for k in g_ref}
    print("gpubench: worst leaves: first gradient "
          f"{max(g_gap, key=g_gap.get)} {max(g_gap.values())!r}, change "
          f"{max(step, key=step.get)} {max(step.values())!r}; unmoved "
          f"{sorted(set(g_ref) - set(moved))}", file=sys.stderr)
    return {"loss_gap": max(abs(p - r) / abs(r)
                            for p, r in zip(prog_losses, ref_losses)),
            "grad_gap": _gap(g_prog, g_ref, g_ref),
            "step_gap": statistics.median(step.values()),
            "point_gap": max(step[k] for k in POINT_LEAVES if k in step),
            "point_grad_gap": max(g_gap[k] for k in POINT_LEAVES)}


def render_numbers(prog_images: List[np.ndarray],
                   ref_images: List[np.ndarray]) -> Dict[str, float]:
    return {"pixel_gap": max(float(np.max(np.abs(p - r)))
                             for p, r in zip(prog_images, ref_images))}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number within its limit; a number that is not finite fails."""
    return all(numbers[k] == numbers[k] and numbers[k] <= limits[k]
               for k in limits)
