"""Serving side of the trainer (port of the eval half of
`pointnerf_tpu/train/trainer.py`).

The serving state is the aggregator module plus the padded point-state
dict; `eval_step` renders one ray batch with no gradients.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from ..models.aggregator import Aggregator
from ..models.renderer import render_forward


class ServeState(NamedTuple):
    aggregator: Aggregator
    points: Dict[str, torch.Tensor]


def point_state_of(state: ServeState) -> Dict:
    return state.points


@torch.inference_mode()
def eval_step(state: ServeState, grid: Dict, batch: Dict, opt, spec) -> Dict:
    """No-grad forward for test/render (reference base_model.test)."""
    return render_forward(state.aggregator, point_state_of(state), grid, spec,
                          opt, batch)


@torch.inference_mode()
def eval_chunks(state: ServeState, grid: Dict, stacked: Dict,
                const_batch: Dict, opt, spec) -> Dict:
    """Render n ray chunks of one camera one after another.

    stacked: ray-dependent leaves [n, 1, C, ...]; const_batch: per-camera
    leaves. Returns every output stacked on a leading chunk axis."""
    n = next(iter(stacked.values())).shape[0]
    outs = [eval_step(state, grid,
                      dict(const_batch, **{k: v[i] for k, v in stacked.items()}),
                      opt, spec) for i in range(n)]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


@torch.inference_mode()
def eval_chunks_stacked(state: ServeState, grid: Dict, stacked: Dict,
                        const_batch: Dict, opt, spec) -> Dict:
    """Render n ray chunks of one camera as ONE wide eval_step.

    Same contract as eval_chunks ([n, 1, C, ...] in and out). Rays are
    independent, so the wide batch renders each chunk's rays as the chunk
    alone would; the compaction budget pools over the group (auto budgets
    scale with the row space; callers scale explicit ones by n). Only
    per-ray outputs come back; `sr_overflow` (a group total) comes back as
    [n] with the total at slot 0.
    """
    n, _, C = next(iter(stacked.values())).shape[:3]
    wide = {k: v.reshape((1, n * C) + v.shape[3:]) for k, v in stacked.items()}
    out = eval_step(state, grid, dict(const_batch, **wide), opt, spec)
    split: Dict = {}
    for k, v in out.items():
        if v.dim() >= 2 and tuple(v.shape[:2]) == (1, n * C):
            split[k] = v.reshape((n, 1, C) + v.shape[2:])
        elif v.dim() == 0:
            split[k] = torch.zeros((n,), dtype=v.dtype, device=v.device)
            split[k][0] = v
    return split
