"""Positional encoding (port of `pointnerf_tpu/ops/pe.py`)."""

from __future__ import annotations

import functools

import numpy as np
import torch

from .grid import host_const


def positional_encoding(positions: torch.Tensor, freqs: int,
                        ori: bool = False) -> torch.Tensor:
    """Sin/cos positional encoding in the reference layout.

    ``ori=False`` → [..., 2·D·F] columns ordered channel → frequency →
    (sin, cos), computed as sin(x·2^f + phase) with phase π/2 (float32) on
    the cos columns, as the JAX package does. ``ori=True`` → [..., D + 2·D·F]:
    the raw input, then all sins, then all cosines (reference networks.py:187).
    """
    if ori:
        pts = _scaled(positions, freqs)
        return torch.cat([positions, torch.sin(pts), torch.cos(pts)], dim=-1)
    return torch.sin(pe_args(positions, freqs))


def _bands(x: torch.Tensor, freqs: int) -> torch.Tensor:
    return 2.0 ** torch.arange(freqs, dtype=x.dtype, device=x.device)


def _scaled(positions: torch.Tensor, freqs: int) -> torch.Tensor:
    """x·2^f, [..., D·F] channel-major."""
    d = positions.shape[-1]
    return (positions[..., None] * _bands(positions, freqs)).reshape(
        positions.shape[:-1] + (d * freqs,))


def pe_args(positions: torch.Tensor, freqs: int) -> torch.Tensor:
    """The sine arguments of the ``ori=False`` encoding: x·2^f + phase,
    [..., 2·D·F] in its column order."""
    d = positions.shape[-1]
    pts = _scaled(positions, freqs)
    phase = host_const(_pe_selection_np(d, freqs)[1], torch.float32,
                       positions.device)
    both = pts[..., :, None].expand(pts.shape + (2,)).reshape(
        pts.shape[:-1] + (2 * d * freqs,))
    return both + phase


def pe_input_grad(dargs: torch.Tensor, freqs: int) -> torch.Tensor:
    """Chain a cotangent of the sine arguments [..., 2·D·F] back to the
    positions [..., D]: each column carries its channel's 2^f."""
    d = dargs.shape[-1] // (2 * freqs)
    per = dargs.reshape(dargs.shape[:-1] + (d, freqs, 2))
    return torch.sum(per * _bands(dargs, freqs)[:, None], dim=(-2, -1))


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
