"""The first train steps in plain PyTorch: losses, autograd, Adam.

Two Adam chains as the reference Point-NeRF trains them: the aggregator's
weights at `lr`, the point features, colours, directions and confidences
at `plr`, each lr read from the exponential decay at the chain's step
count before the update; Adam at (0.9, 0.999, 1e-8), written out.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .grid import Spec
from .model import train_forward

POINT_LEAVES = ("embedding", "color", "dir", "conf")
BETAS, EPS = (0.9, 0.999), 1e-8


def scheduled_lr(o: Dict, base: float, step: int) -> float:
    f32 = np.float32
    return float(f32(base) * np.power(f32(o["lr_decay_exp"]),
                                      f32(step) / f32(o["lr_decay_iters"])))


def run_steps(W0: Dict, pts0: Dict, o: Dict, grid: Dict, spec: Spec,
              batches: List[Dict], draws: List[torch.Tensor]):
    """len(batches) steps from the weights W0 and points pts0 (neither is
    changed). Returns (items of each step as floats, the first step's
    gradients by leaf, every leaf after the last step). Leaves: the
    weights by checkpoint name, the point buffers by POINT_LEAVES."""
    W = {k: v.detach().clone().requires_grad_(True) for k, v in W0.items()}
    pts = {k: v.detach().clone() for k, v in pts0.items()}
    for k in POINT_LEAVES:
        pts[k].requires_grad_(True)
    leaves = {**W, **{k: pts[k] for k in POINT_LEAVES}}
    net = set(W)
    m = {k: torch.zeros_like(v) for k, v in leaves.items()}
    v2 = {k: torch.zeros_like(v) for k, v in leaves.items()}
    items_by_step, first = [], None
    for t, (batch, u) in enumerate(zip(batches, draws)):
        total, items = train_forward(W, o, pts, grid, spec, batch, u)
        grads = torch.autograd.grad(total, list(leaves.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(leaves.items(), grads)}
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        items_by_step.append({k: float(x.detach()) for k, x in items.items()})
        lr = scheduled_lr(o, o["lr"], t)
        plr = scheduled_lr(o, o["plr"], t)
        bc1 = 1 - BETAS[0] ** (t + 1)
        bc2 = 1 - BETAS[1] ** (t + 1)
        with torch.no_grad():
            for k, p in leaves.items():
                g = grads[k]
                m[k].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                v2[k].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                step = (lr if k in net else plr) / bc1
                p.sub_(step * m[k] / (torch.sqrt(v2[k] / bc2) + EPS))
    after = {k: p.detach() for k, p in leaves.items()}
    return items_by_step, first, after
