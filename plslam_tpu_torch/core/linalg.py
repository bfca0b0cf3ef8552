"""Small-matrix linear algebra for the BA (``plslam_tpu.core.linalg``).

The landmark blocks keep the JAX package's closed-form 3x3 and 4x4
inverses, whose formulas decide the damped block inverses.  The dense SPD
solve uses ``torch.linalg.cholesky_ex``, which reports a failed
factorization in ``info`` instead of raising (raising would sync with the
host); ``solve_spd`` turns ``info != 0`` into a NaN solution, the JAX
scan-Cholesky's failure value, so callers reject the step on the device.
"""

from __future__ import annotations

import torch


def inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (..., 3, 3) via the adjugate."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co_a = e * i - f * h
    co_b = -(d * i - f * g)
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    inv_det = 1.0 / det
    adj = torch.stack([
        torch.stack([co_a, -(b * i - c * h), b * f - c * e], dim=-1),
        torch.stack([co_b, a * i - c * g, -(a * f - c * d)], dim=-1),
        torch.stack([co_c, -(a * h - b * g), a * e - b * d], dim=-1),
    ], dim=-2)
    return adj * inv_det[..., None, None]


def _inv2(M: torch.Tensor) -> torch.Tensor:
    a, b = M[..., 0, 0], M[..., 0, 1]
    c, d = M[..., 1, 0], M[..., 1, 1]
    inv_det = 1.0 / (a * d - b * c)
    return torch.stack([torch.stack([d, -b], dim=-1),
                        torch.stack([-c, a], dim=-1)], dim=-2) * inv_det[..., None, None]


def inv4x4(A: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (..., 4, 4) by 2x2 blockwise inversion; the
    (damped, SPD) top-left block must be invertible."""
    P, Q = A[..., :2, :2], A[..., :2, 2:]
    R, S = A[..., 2:, :2], A[..., 2:, 2:]
    Pi = _inv2(P)
    Mi = _inv2(S - R @ Pi @ Q)
    TL = Pi + Pi @ Q @ Mi @ R @ Pi
    TR = -Pi @ Q @ Mi
    BL = -Mi @ R @ Pi
    return torch.cat([torch.cat([TL, TR], dim=-1),
                      torch.cat([BL, Mi], dim=-1)], dim=-2)


def cholesky(A: torch.Tensor):
    """(L, ok): lower Cholesky factor of an SPD matrix and a 0-d bool
    tensor that is false when the factorization failed (L is then
    partial).  No host sync."""
    L, info = torch.linalg.cholesky_ex(A)
    return L, info == 0


def cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) x = b for a vector b."""
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)[..., 0]


def solve_spd(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for SPD A; NaN where A is not SPD."""
    L, ok = cholesky(A)
    return torch.where(ok, cho_solve(L, b), torch.nan)
