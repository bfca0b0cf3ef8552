"""SE(3)/SO(3) operations on tensors (the part of ``plslam_tpu.core.lie``
that the VO path uses).

Twist layout ``x = [t(3); w(3)]``, translation first (reference
``src2/auxiliar.cpp``).  Every function broadcasts over leading batch
dimensions.  Branches are ``torch.where`` on Taylor-safe arguments, as in
the JAX package.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def skew(v: torch.Tensor) -> torch.Tensor:
    """3-vector -> 3x3 skew-symmetric matrix."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], z, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], z], dim=-1),
    ], dim=-2)


def unskew(M: torch.Tensor) -> torch.Tensor:
    return torch.stack([M[..., 2, 1], M[..., 0, 2], M[..., 1, 0]], dim=-1)


def _safe_norm(v: torch.Tensor):
    sq = torch.sum(v * v, dim=-1)
    small = sq < 1e-8
    norm = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    return torch.where(small, torch.zeros_like(norm), norm), small


def _sinc_coeffs_sq(t2: torch.Tensor, theta: torch.Tensor, small: torch.Tensor):
    """Taylor-safe (sin t/t, (1-cos t)/t^2, (t-sin t)/t^3)."""
    ts = torch.where(small, torch.ones_like(theta), theta)
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(ts) / ts)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(ts)) / (ts * ts))
    c = torch.where(small, 1.0 / 6.0 - t2 / 120.0,
                    (ts - torch.sin(ts)) / (ts * ts * ts))
    return a, b, c


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    theta, small = _safe_norm(w)
    a, b, _ = _sinc_coeffs_sq(torch.sum(w * w, dim=-1), theta, small)
    W = skew(w)
    return _eye3(w) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    w_raw = unskew(R - R.transpose(-1, -2))
    raw_norm, _ = _safe_norm(w_raw)
    sin_t = 0.5 * raw_norm
    theta = torch.atan2(sin_t, cos_t)
    small = theta < 1e-6
    near_pi = cos_t < -1.0 + 1e-6
    denom = torch.where(small | near_pi, torch.ones_like(sin_t), 2.0 * sin_t)
    w_generic = theta[..., None] * w_raw / denom[..., None]
    w_small = 0.5 * w_raw
    diag = torch.diagonal(R, dim1=-2, dim2=-1)
    axis_sq = torch.clamp((diag - cos_t[..., None])
                          / (1.0 - cos_t[..., None] + _EPS), min=0.0)
    axis = torch.sqrt(axis_sq)
    s01 = R[..., 0, 1] + R[..., 1, 0]
    s02 = R[..., 0, 2] + R[..., 2, 0]
    one = torch.ones_like(s01)
    sign1 = torch.where(s01 >= 0, one, -one)
    sign2 = torch.where(s02 >= 0, one, -one)
    axis = axis * torch.stack([one, sign1, sign2], dim=-1)
    nrm = torch.linalg.norm(axis, dim=-1, keepdim=True)
    w_pi = theta[..., None] * axis / torch.where(nrm > 0, nrm, torch.ones_like(nrm))
    return torch.where(small[..., None], w_small,
                       torch.where(near_pi[..., None], w_pi, w_generic))


def left_jacobian_so3(w: torch.Tensor) -> torch.Tensor:
    theta, small = _safe_norm(w)
    _, b, c = _sinc_coeffs_sq(torch.sum(w * w, dim=-1), theta, small)
    W = skew(w)
    return _eye3(w) + b[..., None, None] * W + c[..., None, None] * (W @ W)


def inv_left_jacobian_so3(w: torch.Tensor) -> torch.Tensor:
    theta, small = _safe_norm(w)
    W = skew(w)
    t2 = torch.sum(w * w, dim=-1)
    ts = torch.where(small, torch.ones_like(theta), theta)
    half = 0.5 * ts
    cot = torch.cos(half) / torch.sin(torch.where(small, torch.ones_like(half), half))
    coef = torch.where(small, 1.0 / 12.0 + t2 / 720.0,
                       (1.0 - 0.5 * ts * cot) / (ts * ts))
    return _eye3(w) - 0.5 * W + coef[..., None, None] * (W @ W)


def _homogeneous(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[[R, t], [0, 1]]; the last row comes from a device eye, since
    assigning a Python scalar into a CUDA tensor syncs with the host."""
    last = torch.eye(4, dtype=R.dtype, device=R.device)[3:]
    return torch.cat([torch.cat([R, t[..., None]], dim=-1),
                      last.expand(R.shape[:-2] + (1, 4))], dim=-2)


def exp_se3(x: torch.Tensor) -> torch.Tensor:
    """Twist [t; w] -> 4x4 transform (auxiliar.cpp expmap_se3 :124)."""
    t, w = x[..., :3], x[..., 3:]
    V = left_jacobian_so3(w)
    return _homogeneous(exp_so3(w), torch.einsum("...ij,...j->...i", V, t))


def log_se3(T: torch.Tensor) -> torch.Tensor:
    """4x4 transform -> twist [t; w] (auxiliar.cpp logmap_se3 :143)."""
    w = log_so3(T[..., :3, :3])
    t = torch.einsum("...ij,...j->...i", inv_left_jacobian_so3(w), T[..., :3, 3])
    return torch.cat([t, w], dim=-1)


def inv_se3(T: torch.Tensor) -> torch.Tensor:
    Rt = T[..., :3, :3].transpose(-1, -2)
    return _homogeneous(Rt, -torch.einsum("...ij,...j->...i", Rt, T[..., :3, 3]))


def adjoint_se3(T: torch.Tensor) -> torch.Tensor:
    """Adj = [[R, skew(t) R], [0, R]] for the [t; w] layout."""
    R = T[..., :3, :3]
    # built by concatenation, not slice writes, so it also runs under vmap
    return torch.cat([torch.cat([R, skew(T[..., :3, 3]) @ R], dim=-1),
                      torch.cat([torch.zeros_like(R), R], dim=-1)], dim=-2)


def cov_Tinv(T: torch.Tensor, cov: torch.Tensor) -> torch.Tensor:
    A = adjoint_se3(inv_se3(T))
    return A @ cov @ A.transpose(-1, -2)


def cov_compose(T1: torch.Tensor, cov1: torch.Tensor,
                cov_inc: torch.Tensor) -> torch.Tensor:
    A = adjoint_se3(T1)
    return cov1 + A @ cov_inc @ A.transpose(-1, -2)


def transform_point(T: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,...j->...i", T[..., :3, :3], P) + T[..., :3, 3]


def se3_chordal_project(T: torch.Tensor) -> torch.Tensor:
    """Re-orthonormalize via exp(log(T)) (stereoFrameHandler.cpp:385-389)."""
    return exp_se3(log_se3(T))
