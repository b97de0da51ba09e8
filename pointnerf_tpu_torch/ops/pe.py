"""Positional encoding (port of `pointnerf_tpu/ops/pe.py`)."""

from __future__ import annotations

import functools

import numpy as np
import torch


def positional_encoding(positions: torch.Tensor, freqs: int,
                        ori: bool = False) -> torch.Tensor:
    """Sin/cos positional encoding in the reference layout.

    ``ori=False`` → [..., 2·D·F] columns ordered channel → frequency →
    (sin, cos), computed as sin(x·2^f + phase) with phase π/2 (float32) on
    the cos columns, as the JAX package does. ``ori=True`` → [..., D + 2·D·F]:
    the raw input, then all sins, then all cosines (reference networks.py:187).
    """
    d = positions.shape[-1]
    bands = 2.0 ** torch.arange(freqs, dtype=positions.dtype,
                                device=positions.device)
    pts = (positions[..., None] * bands).reshape(positions.shape[:-1]
                                                 + (d * freqs,))
    if ori:
        return torch.cat([positions, torch.sin(pts), torch.cos(pts)], dim=-1)
    phase = torch.as_tensor(_pe_selection_np(d, freqs)[1],
                            device=positions.device)
    both = pts[..., :, None].expand(pts.shape + (2,)).reshape(
        pts.shape[:-1] + (2 * d * freqs,))
    return torch.sin(both + phase)


@functools.lru_cache(maxsize=None)
def _pe_selection_np(d: int, freqs: int):
    """(S [d, 2·d·F], phase [2·d·F]): column j = (di, f, sin|cos) carries
    S[di, j] = 2^f and phase π/2 on cos columns."""
    S = np.zeros((d, 2 * d * freqs), np.float32)
    phase = np.zeros((2 * d * freqs,), np.float32)
    j = 0
    for di in range(d):
        for f in range(freqs):
            for p in range(2):
                S[di, j] = 2.0 ** f
                phase[j] = p * (np.pi / 2)
                j += 1
    return S, phase
