"""Real spherical harmonics (port of `pointnerf_tpu/ops/sh.py`; reference:
utils/spherical.py).

`sh_basis` is the hardcoded table up to degree 5 (reference
SphericalHarm_table, spherical.py:153-237; `sh_degree` defaults to 4);
`sh_basis_runtime` is the recurrence for any degree (reference
SphericalHarm, spherical.py:9-151), unrolled into elementwise operations.
Both run on the directions' device in their dtype; the constants are
Python floats, cast to the tensor's dtype as the JAX package's weakly typed
constants are.
"""

from __future__ import annotations

import math

import torch


def _sq(v: float) -> float:
    return math.sqrt(v)


_PI = math.pi


def _xyz(dirs: torch.Tensor, flip_dir: bool):
    x = -dirs[..., 0] if flip_dir else dirs[..., 0]
    y = -dirs[..., 1] if flip_dir else dirs[..., 1]
    return x, y, dirs[..., 2]


def sh_basis(dirs: torch.Tensor, total_deg: int, flip_dir: bool = True
             ) -> torch.Tensor:
    """The real SH basis at unit directions: dirs [..., 3] → [...,
    total_deg²]. `flip_dir` negates x and y, the reference's default sign
    convention (spherical.py:158-162). Degrees past 5 (or below 1) go to
    `sh_basis_runtime`."""
    if not 1 <= total_deg <= 5:
        return sh_basis_runtime(dirs, total_deg, flip_dir=flip_dir)
    x, y, z = _xyz(dirs, flip_dir)
    out = [0.5 * _sq(1 / _PI) * torch.ones_like(x)]
    if total_deg >= 2:
        c = _sq(3 / (4 * _PI))
        out += [c * y, c * z, c * x]
    if total_deg >= 3:
        out += [
            0.5 * _sq(15 / _PI) * x * y,
            0.5 * _sq(15 / _PI) * z * y,
            0.25 * _sq(5 / _PI) * (-x * x - y * y + 2 * z * z),
            0.5 * _sq(15 / _PI) * x * z,
            0.25 * _sq(15 / _PI) * (x * x - y * y),
        ]
    if total_deg >= 4:
        out += [
            0.25 * _sq(35.0 / 2 / _PI) * (3 * x * x - y * y) * y,
            0.5 * _sq(105 / _PI) * x * y * z,
            0.25 * _sq(21 / 2 / _PI) * (4 * z * z - x * x - y * y) * y,
            0.25 * _sq(7 / _PI) * (2 * z * z - 3 * x * x - 3 * y * y) * z,
            0.25 * _sq(21 / 2 / _PI) * (4 * z * z - x * x - y * y) * x,
            0.25 * _sq(105 / _PI) * (x * x - y * y) * z,
            0.25 * _sq(35.0 / 2 / _PI) * (x * x - 3 * y * y) * x,
        ]
    if total_deg >= 5:
        z4 = (z * z) * (z * z)          # z ** 4, as XLA's integer_pow
        out += [
            0.75 * _sq(35.0 / _PI) * x * y * (x * x - y * y),
            0.75 * _sq(35.0 / 2 / _PI) * (3 * x * x - y * y) * y * z,
            0.75 * _sq(5 / _PI) * x * y * (7 * z * z - 1),
            0.75 * _sq(5 / 2 / _PI) * z * y * (7 * z * z - 3),
            3 / 16 * _sq(1 / _PI) * (35 * z4 - 30 * z * z + 3),
            0.75 * _sq(5 / 2 / _PI) * x * z * (7 * z * z - 3),
            3 / 8 * _sq(5 / _PI) * (x * x - y * y) * (7 * z * z - 1),
            0.75 * _sq(35.0 / 2 / _PI) * (x * x - 3 * y * y) * x * z,
            3 / 16 * _sq(35.0 / _PI) * (x * x * (x * x - 3 * y * y)
                                        - y * y * (3 * x * x - y * y)),
        ]
    return torch.stack(out, dim=-1)


def sh_basis_runtime(dirs: torch.Tensor, total_deg: int,
                     flip_dir: bool = True) -> torch.Tensor:
    """The real SH basis of any degree by recurrence: the associated
    Legendre values by the (m,m) → (m+1,m) → (l,m) recurrences with
    sin^m(θ) folded into the azimuthal pair (A_m, B_m) = r_xy^m (cos mφ,
    sin mφ), so no trigonometry and no division by the direction (the
    recurrence divides by the constant l - m). No Condon-Shortley phase,
    as the table. dirs [..., 3] unit → [..., total_deg²]."""
    if total_deg < 1:
        raise ValueError("total_deg must be >= 1")
    x, y, z = _xyz(dirs, flip_dir)
    L = total_deg - 1
    A = [torch.ones_like(x)]
    B = [torch.zeros_like(x)]
    for m in range(1, L + 1):
        A.append(x * A[m - 1] - y * B[m - 1])
        B.append(x * B[m - 1] + y * A[m - 1])
    P = [[None] * (L + 1) for _ in range(L + 1)]
    P[0][0] = torch.ones_like(z)
    for m in range(1, L + 1):
        P[m][m] = (2 * m - 1) * P[m - 1][m - 1]
    for m in range(L):
        P[m + 1][m] = (2 * m + 1) * z * P[m][m]
    for m in range(L + 1):
        for l in range(m + 2, L + 1):
            P[l][m] = ((2 * l - 1) * z * P[l - 1][m]
                       - (l + m - 1) * P[l - 2][m]) / (l - m)
    out = []
    for l in range(L + 1):
        row = [None] * (2 * l + 1)
        for m in range(l + 1):
            K = math.sqrt((2 * l + 1) / (4 * math.pi)
                          * math.factorial(l - m) / math.factorial(l + m))
            if m == 0:
                row[l] = K * P[l][0]
            else:
                row[l + m] = math.sqrt(2) * K * A[m] * P[l][m]
                row[l - m] = math.sqrt(2) * K * B[m] * P[l][m]
        out += row
    return torch.stack(out, dim=-1)


class SphericalHarm:
    """The reference's runtime SphericalHarm class: sh_all(dirs) on the
    flattened directions."""

    def __init__(self, total_deg: int):
        self.total_deg = total_deg

    def sh_all(self, indirs, filp_dir: bool = True):
        return sh_basis_runtime(indirs.reshape(-1, 3), self.total_deg,
                                flip_dir=filp_dir)


class SphericalHarmTable:
    """The reference's SphericalHarm_table class: sh_all(dirs) on the
    flattened directions."""

    def __init__(self, total_deg: int):
        self.total_deg = total_deg

    def sh_all(self, indirs, filp_dir: bool = True):
        return sh_basis(indirs.reshape(-1, 3), self.total_deg,
                        flip_dir=filp_dir)
