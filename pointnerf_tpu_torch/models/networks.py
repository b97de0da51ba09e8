"""MLP construction and application, and the learning-rate schedules (port
of `pointnerf_tpu/models/networks.py`).

Each MLP is an ``nn.Sequential(Linear, act, Linear, act, ...)``, so Linear
layers sit at even indices and a state_dict carries the reference checkpoint
keys (``{branch}.{2i}.weight`` as [out, in]).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

NEG_SLOPE = 0.1  # the reference's LeakyReLU slope (networks.py:16)


def _gain(act: str) -> float:
    """torch.nn.init.calculate_gain as the reference init_seq uses it."""
    if act == "ReLU":
        return math.sqrt(2.0)
    if act == "LeakyReLU":
        return math.sqrt(2.0 / (1 + NEG_SLOPE ** 2))
    return 1.0


def activation(name: str) -> nn.Module:
    if name == "ReLU":
        return nn.ReLU()
    if name == "LeakyReLU":
        return nn.LeakyReLU(NEG_SLOPE)
    if name == "SELU":
        return nn.SELU()
    raise ValueError(f"unsupported act_type {name}")


def make_mlp(dims: Sequence[int], act: str, final_act: bool = True
             ) -> nn.Sequential:
    """Linear stack with `act` after every layer (after all but the last
    when final_act is False); weights uninitialized."""
    mods = []
    for i in range(len(dims) - 1):
        mods.append(nn.Linear(dims[i], dims[i + 1]))
        if final_act or i < len(dims) - 2:
            mods.append(activation(act))
    return nn.Sequential(*mods)


def init_mlp(dims: Sequence[int], act: str, final_act: bool = True,
             generator: torch.Generator = None) -> nn.Sequential:
    """Xavier-uniform init like the reference (networks.py:109-122, 163-172):
    hidden layers take the activation gain, a last layer without a following
    activation gain 1; biases zero."""
    seq = make_mlp(dims, act, final_act)
    layers = linears(seq)
    with torch.no_grad():
        for i, lin in enumerate(layers):
            has_act = final_act or i < len(layers) - 1
            g = _gain(act) if has_act else 1.0
            bound = g * math.sqrt(2.0 / (lin.in_features + lin.out_features)) \
                * math.sqrt(3.0)
            lin.weight.uniform_(-bound, bound, generator=generator)
            lin.bias.zero_()
    return seq


def linears(seq: nn.Sequential):
    return [m for m in seq if isinstance(m, nn.Linear)]


def apply_mlp(seq: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    """Apply the stack (activations are part of the Sequential)."""
    return seq(x)


def apply_mlp_pieces(seq: nn.Sequential, pieces: Sequence[torch.Tensor]
                     ) -> torch.Tensor:
    """apply_mlp(concat(pieces)) as one first-layer matmul per piece:
    concat(x1..xn) @ W == Σ_i xi @ W[rows_i]."""
    first = seq[0]
    w = first.weight                                   # [out, in]
    off = 0
    x = None
    for p in pieces:
        k = p.shape[-1]
        term = F.linear(p, w[:, off:off + k])
        x = term if x is None else x + term
        off += k
    if off != w.shape[1]:
        raise ValueError(f"pieces span {off} inputs, layer takes {w.shape[1]}")
    return seq[1:](x + first.bias)


def make_lr_schedule(opt, base_lr: float):
    """Step → learning rate (reference: networks.py:41-68), in float32 as
    the JAX package computes it. "plateau" is constant: the training loop
    owns the reduction (PlateauTracker), as in the JAX package."""
    f32 = np.float32
    if opt.lr_policy == "iter_exponential_decay":
        def sched(step):
            return float(f32(base_lr) * np.power(
                f32(opt.lr_decay_exp), f32(step) / f32(opt.lr_decay_iters)))
    elif opt.lr_policy == "lambda":
        def sched(step):
            frac = f32(1.0) - f32(max(0, step - opt.niter)) \
                / f32(opt.niter_decay + 1)
            return float(f32(base_lr) * frac)
    elif opt.lr_policy == "step":
        def sched(step):
            return float(f32(base_lr) * np.power(
                f32(0.1), f32(step // opt.lr_decay_iters)))
    elif opt.lr_policy == "plateau":
        def sched(step):
            return float(f32(base_lr))
    else:
        raise NotImplementedError(f"lr policy {opt.lr_policy}")
    return sched


class PlateauTracker:
    """Host-side ReduceLROnPlateau decision logic with a relative threshold
    (copy of `pointnerf_tpu/models/networks.py::PlateauTracker`; reference
    helpers/networks.py:50-55: factor 0.2, threshold 0.01, patience 5).
    update(metric) returns True when the lr should be multiplied by the
    factor now. mode="min" tracks a loss (improves iff metric <
    best·(1 − threshold)); mode="max" a quality score such as PSNR
    (improves iff metric > best·(1 + threshold)). A negated score in min
    mode never fires, as in torch: the relative test assumes positive
    metrics."""

    def __init__(self, factor: float = 0.2, threshold: float = 0.01,
                 patience: int = 5, mode: str = "min"):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be min or max, not {mode}")
        self.factor = factor
        self.threshold = threshold
        self.patience = patience
        self.mode = mode
        self.best = float("inf") if mode == "min" else float("-inf")
        self.num_bad = 0

    def _is_better(self, metric: float) -> bool:
        if self.mode == "min":
            return metric < self.best * (1.0 - self.threshold)
        return metric > self.best * (1.0 + self.threshold)

    def update(self, metric: float) -> bool:
        if self._is_better(metric):
            self.best = metric
            self.num_bad = 0
            return False
        self.num_bad += 1
        if self.num_bad > self.patience:
            self.num_bad = 0
            return True
        return False

    def state_dict(self) -> dict:
        return {"plateau_best": self.best, "plateau_num_bad": self.num_bad}

    def load_state_dict(self, d: dict) -> None:
        if "plateau_best" in d:
            self.best = float(d["plateau_best"])
        if "plateau_num_bad" in d:
            self.num_bad = int(d["plateau_num_bad"])
