"""Pluecker line coordinates L = [n(3); d(3)] (the part of
``plslam_tpu.core.plucker`` on the VO path; the orthonormal (U, W) update
waits for the BA port)."""

from __future__ import annotations

import torch

from .lie import skew


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def plucker_motion_matrix(T: torch.Tensor) -> torch.Tensor:
    """6x6 H(T) with L_c = H(T) @ L_w (mapHandler.h:242-250)."""
    R = T[..., :3, :3]
    H = torch.zeros(T.shape[:-2] + (6, 6), dtype=T.dtype, device=T.device)
    H[..., :3, :3] = R
    H[..., :3, 3:] = skew(T[..., :3, 3]) @ R
    H[..., 3:, 3:] = R
    return H


def transform_plucker(T: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """n' = R n + t x (R d);  d' = R d."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    n = torch.einsum("...ij,...j->...i", R, L[..., :3])
    d = torch.einsum("...ij,...j->...i", R, L[..., 3:])
    return torch.cat([n + _cross(t, d), d], dim=-1)


def plane_from_points(x1, x2, x3) -> torch.Tensor:
    """Plane [a,b,c,d] through three 3D points (stereoFrame.cpp :870)."""
    normal = _cross(x1 - x3, x2 - x3)
    d = -torch.sum(x3 * _cross(x1, x2), dim=-1, keepdim=True)
    return torch.cat([normal, d], dim=-1)


def plucker_from_planes(pi1: torch.Tensor, pi2: torch.Tensor) -> torch.Tensor:
    """Pluecker line of two planes' intersection (stereoFrame.cpp :877)."""
    dp = pi1[..., :, None] * pi2[..., None, :] - pi2[..., :, None] * pi1[..., None, :]
    n = dp[..., :3, 3]
    d = torch.stack([-dp[..., 1, 2], dp[..., 0, 2], -dp[..., 0, 1]], dim=-1)
    return torch.cat([n, d], dim=-1)
