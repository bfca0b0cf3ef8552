"""Pluecker line coordinates L = [n(3); d(3)] and the orthonormal 4-DoF
(U, W) representation the BA updates (``plslam_tpu.core.plucker``).

Every function broadcasts over leading batch dimensions."""

from __future__ import annotations

import torch

from .lie import skew

_EPS = 1e-12


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


def normalize_plucker(L: torch.Tensor) -> torch.Tensor:
    """Scale so that ||d|| = 1 (mapHandler.cpp:451-459)."""
    dn = torch.linalg.norm(L[..., 3:], dim=-1, keepdim=True)
    return L / torch.where(dn > _EPS, dn, torch.ones_like(dn))


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=_EPS)


def _euler_R(theta: torch.Tensor) -> torch.Tensor:
    """The reference's rotation parameterization R(theta)
    (g2o_types.h:84-92)."""
    s1, c1 = torch.sin(theta[..., 0]), torch.cos(theta[..., 0])
    s2, c2 = torch.sin(theta[..., 1]), torch.cos(theta[..., 1])
    s3, c3 = torch.sin(theta[..., 2]), torch.cos(theta[..., 2])
    return torch.stack([
        torch.stack([c2 * c3, s1 * s2 * c3 - c1 * s3, c1 * s2 * c3 + s1 * s3], dim=-1),
        torch.stack([c2 * s3, s1 * s2 * s3 + c1 * c3, c1 * s2 * s3 - s1 * c3], dim=-1),
        torch.stack([-s2, s1 * c2, c1 * c2], dim=-1),
    ], dim=-2)


def _R_to_euler(R: torch.Tensor) -> torch.Tensor:
    """Inverse of _euler_R (g2o_types.h:125-131)."""
    u1, u2, u3 = R[..., :, 0], R[..., :, 1], R[..., :, 2]
    t0 = torch.atan2(u2[..., 2], u3[..., 2])
    t1 = torch.asin(torch.clamp(-u1[..., 2], -1.0, 1.0))
    t2 = torch.atan2(u1[..., 1], u1[..., 0])
    return torch.stack([t0, t1, t2], dim=-1)


def orth_U_from_plucker(L: torch.Tensor) -> torch.Tensor:
    """U = [n_hat, d_hat, (n x d)_hat] (mapFeatures.cpp :226)."""
    n, d = L[..., :3], L[..., 3:]
    return torch.stack([_unit(n), _unit(d), _unit(_cross(n, d))], dim=-1)


def orth_W_from_plucker(L: torch.Tensor) -> torch.Tensor:
    """W = [[w1, -w2], [w2, w1]], (w1, w2) = (||n||, ||d||) normalized
    (mapFeatures.cpp :241)."""
    nn = torch.linalg.norm(L[..., :3], dim=-1)
    dn = torch.linalg.norm(L[..., 3:], dim=-1)
    den = torch.clamp(torch.sqrt(nn * nn + dn * dn), min=_EPS)
    w1, w2 = nn / den, dn / den
    return torch.stack([torch.stack([w1, -w2], dim=-1),
                        torch.stack([w2, w1], dim=-1)], dim=-2)


def plucker_to_orth(L: torch.Tensor) -> torch.Tensor:
    """Pluecker 6-vec -> orthonormal 4-vec [theta(3); phi]
    (mapFeatures.cpp :186)."""
    theta = _R_to_euler(orth_U_from_plucker(L))
    phi = torch.asin(torch.clamp(orth_W_from_plucker(L)[..., 1, 0], -1.0, 1.0))
    return torch.cat([theta, phi[..., None]], dim=-1)


def orth_to_plucker(o: torch.Tensor) -> torch.Tensor:
    """Orthonormal 4-vec -> Pluecker 6-vec with ||n||^2 + ||d||^2 = 1
    (mapFeatures.cpp :203)."""
    R = _euler_R(o[..., :3])
    n = torch.cos(o[..., 3])[..., None] * R[..., :, 0]
    d = torch.sin(o[..., 3])[..., None] * R[..., :, 1]
    return torch.cat([n, d], dim=-1)


def _axis_rotation(a: torch.Tensor, i: int, j: int) -> torch.Tensor:
    """Rotation by angle a in the (i, j) coordinate plane."""
    c, s = torch.cos(a), torch.sin(a)
    one, zero = torch.ones_like(a), torch.zeros_like(a)
    rows = [[one, zero, zero], [zero, one, zero], [zero, zero, one]]
    rows[i][i], rows[i][j], rows[j][i], rows[j][j] = c, -s, s, c
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def orth_plus(o: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Box-plus: U <- U Rx Ry Rz of delta[:3], W <- W R(delta[3])
    (g2o_types.h updateOrthCoord :72-155)."""
    Rx = _axis_rotation(delta[..., 0], 1, 2)
    Ry = _axis_rotation(delta[..., 1], 2, 0)
    Rz = _axis_rotation(delta[..., 2], 0, 1)
    theta_new = _R_to_euler(_euler_R(o[..., :3]) @ Rx @ Ry @ Rz)
    # the reference's W-matrix re-extraction: asin(sin(phi + dphi))
    phi_new = torch.asin(torch.clamp(torch.sin(o[..., 3] + delta[..., 3]), -1.0, 1.0))
    return torch.cat([theta_new, phi_new[..., None]], dim=-1)


def jac_plucker_wrt_orth(L: torch.Tensor) -> torch.Tensor:
    """Analytic 6x4 Jacobian d L(orth boxplus delta) / d delta at delta = 0
    (g2o_types.h:455-470, corrected version)."""
    U = orth_U_from_plucker(L)
    W = orth_W_from_plucker(L)
    w1, w2 = W[..., 0, 0, None], W[..., 1, 0, None]
    u1, u2, u3 = U[..., :, 0], U[..., :, 1], U[..., :, 2]
    z = torch.zeros_like(u1)
    top = torch.stack([z, -w1 * u3, w1 * u2, -w2 * u1], dim=-1)
    bot = torch.stack([w2 * u3, z, -w2 * u1, w1 * u2], dim=-1)
    return torch.cat([top, bot], dim=-2)


def plucker_closest_point(L: torch.Tensor) -> torch.Tensor:
    """Point on the line closest to the origin: (d x n) / ||d||^2."""
    n, d = L[..., :3], L[..., 3:]
    dd = torch.sum(d * d, dim=-1, keepdim=True)
    return _cross(d, n) / torch.clamp(dd, min=_EPS)


def plucker_from_two_points(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Line through 3D points A, B: d = B - A, n = A x B."""
    return torch.cat([_cross(A, B), B - A], dim=-1)
