"""Frame-to-frame pose tracking by robust Gauss-Newton
(``plslam_tpu.frontend.tracker``; optimizePose :307,
gaussNewtonOptimizationforPluker :803, removeOutliers :1303,
isGoodSolution :292 of stereoFrameHandler.cpp).

Residuals and Jacobians of all features are computed at once and reduced
into one weighted 8x8 Gram.  The update solves H delta = g and applies
DT <- exp(-delta) @ DT.  The GN loop runs a fixed number of trips with a
converged mask, without a host sync inside the step.  With
``TrackerConfig.early_exit`` (the default) the carry freezes once the
stopping rule fires, which gives exactly the iterates of the JAX
package's early-exit while-loop; without it the trips run the JAX
package's fixed-length scan: a finished trip still applies exp(-0) and
still updates ``good``.  In both forms a trip is used when it enters with
the carry not yet done; ``optimize_pose`` hands on each trip's flag of its
two solves (``PoseEstimate.done_in``), and the VO step counts them
(``trips_used``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import lie, robust
from ..core.camera import StereoCamera
from ..core.plucker import transform_plucker
from .features import TrackedLines, TrackedPoints

HOMOG_TH = 1e-7  # Config::homogTh (config.cpp:84)


class TrackerConfig(NamedTuple):
    """Optimizer tunables (defaults = reference config.cpp:36-113)."""

    max_iters: int = 5
    max_iters_ref: int = 10
    min_error: float = 1e-7
    min_error_change: float = 1e-7
    inlier_k: float = 4.0
    min_features: int = 10
    use_lines: bool = True
    use_points: bool = True
    plucker_lines: bool = True
    min_entropy_ratio: float = 0.85
    max_kf_t_dist: float = 5.0
    max_kf_r_dist: float = 15.0
    defer_lines_min_pts: int = 30
    line_abs_gate: float = 3.0
    # the JAX package's GN loop form: True its lax.while_loop (a converged
    # carry freezes), False its fixed-length lax.scan
    early_exit: bool = True


def _rdiv(num: float, den: torch.Tensor) -> torch.Tensor:
    """num / den, divided (``float / tensor`` is reciprocal-multiply)."""
    return torch.full_like(den, num) / den


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def point_residuals(DT: torch.Tensor, pts: TrackedPoints, cam: StereoCamera):
    """r_i = ||proj(DT P_i) - obs_i|| and its 6-vector Jacobian wrt the
    left-multiplicative twist (stereoFrameHandler.cpp:654-698)."""
    P_ = lie.transform_point(DT, pts.P)
    e = cam.project(P_) - pts.obs
    r = torch.linalg.norm(e, dim=-1)
    x, y, z = P_[..., 0], P_[..., 1], P_[..., 2]
    z2 = torch.clamp(z * z, min=HOMOG_TH)
    zs = torch.clamp(z, min=HOMOG_TH)
    fxz = _rdiv(cam.fx, zs)
    fyz = _rdiv(cam.fy, zs)
    rs = torch.clamp(r, min=HOMOG_TH)
    c = torch.stack([e[..., 0] * fxz / rs, e[..., 1] * fyz / rs,
                     -(e[..., 0] * cam.fx * x + e[..., 1] * cam.fy * y) / z2 / rs],
                    dim=-1)
    return r, torch.cat([c, _cross(P_, c)], dim=-1)


def _K_L_T_apply(K, v):
    """u = K_L^T @ v for (N, 3) v."""
    return torch.stack([K[0][0] * v[..., 0] + K[2][0] * v[..., 2],
                        K[1][1] * v[..., 1] + K[2][1] * v[..., 2],
                        K[2][2] * v[..., 2]], dim=-1)


def line_residuals_plucker(DT: torch.Tensor, ls: TrackedLines, cam: StereoCamera):
    """Pluecker-mode residual (stereoFrameHandler.cpp:702-785):
    r = sqrt(e0^2 + e1^2), e_i the distance of observed endpoint i to the
    projected infinite line l = K_L n_c."""
    Lc = transform_plucker(DT, ls.NDc)
    n_c, d_c = Lc[..., :3], Lc[..., 3:]
    K = cam.plucker_K
    l = cam.apply_plucker_K(n_c)
    lx, ly, lz = l[..., 0], l[..., 1], l[..., 2]
    fm = 1.0 / torch.sqrt(torch.clamp(lx * lx + ly * ly, min=HOMOG_TH))
    a0, b0 = ls.sobs[..., 0], ls.sobs[..., 1]
    a1, b1 = ls.eobs[..., 0], ls.eobs[..., 1]
    e0 = (a0 * lx + b0 * ly + lz) * fm
    e1 = (a1 * lx + b1 * ly + lz) * fm
    r = torch.sqrt(e0 * e0 + e1 * e1)
    de0 = torch.stack([a0 * fm - lx * e0 * fm * fm, b0 * fm - ly * e0 * fm * fm, fm],
                      dim=-1)
    de1 = torch.stack([a1 * fm - lx * e1 * fm * fm, b1 * fm - ly * e1 * fm * fm, fm],
                      dim=-1)
    rs = torch.clamp(r, min=HOMOG_TH)
    de = (de0 * e0[..., None] + de1 * e1[..., None]) / rs[..., None]
    u = _K_L_T_apply(K, de)
    J = torch.cat([_cross(d_c, u), _cross(n_c, u)], dim=-1)
    return r, J, e0, e1


def line_residuals_endpoint(DT: torch.Tensor, ls: TrackedLines, cam: StereoCamera):
    """Endpoint-mode residual (stereoFrameHandler.cpp:1196-1277):
    e_i = l_obs . [proj(DT P_i); 1] for the two 3D endpoints."""
    sP_ = lie.transform_point(DT, ls.sP)
    eP_ = lie.transform_point(DT, ls.eP)
    sp = cam.project(sP_)
    ep = cam.project(eP_)
    lo = ls.le_obs
    e0 = lo[..., 0] * sp[..., 0] + lo[..., 1] * sp[..., 1] + lo[..., 2]
    e1 = lo[..., 0] * ep[..., 0] + lo[..., 1] * ep[..., 1] + lo[..., 2]
    r = torch.sqrt(e0 * e0 + e1 * e1)

    def endpoint_J(P_):
        x, y, z = P_[..., 0], P_[..., 1], P_[..., 2]
        z2 = torch.clamp(z * z, min=HOMOG_TH)
        zs = torch.clamp(z, min=HOMOG_TH)
        a = torch.stack([lo[..., 0] * cam.fx / zs, lo[..., 1] * cam.fy / zs,
                         -(lo[..., 0] * cam.fx * x + lo[..., 1] * cam.fy * y) / z2],
                        dim=-1)
        return torch.cat([a, _cross(P_, a)], dim=-1)

    J = ((endpoint_J(sP_) * e0[..., None] + endpoint_J(eP_) * e1[..., None])
         / torch.clamp(r, min=HOMOG_TH)[..., None])
    return r, J, sp, ep


def f2f_line_overlap(sp_obs, ep_obs, sp_proj, ep_proj) -> torch.Tensor:
    """Overlap in [0, 1] of the projected segment with the observed one
    (f2fLineSegmentOverlap :186-300)."""
    l = ep_obs - sp_obs
    denom = torch.clamp(torch.sum(l * l, dim=-1), min=1e-12)
    lam_s = torch.sum((sp_proj - sp_obs) * l, dim=-1) / denom
    lam_e = torch.sum((ep_proj - sp_obs) * l, dim=-1) / denom
    lam_min = torch.minimum(lam_s, lam_e)
    lam_max = torch.maximum(lam_s, lam_e)
    return torch.clamp(torch.clamp(lam_max, max=1.0) - torch.clamp(lam_min, min=0.0),
                       0.0, 1.0)


def build_normal_equations(DT: torch.Tensor, pts: TrackedPoints, ls: TrackedLines,
                           cam: StereoCamera, cfg: TrackerConfig):
    """(H, g, err) with MAD scales, Cauchy weights and line overlap weights,
    from one weighted Gram G = sum_n w_n a_n a_n^T of rows
    a = [J | r_grad | r]: H = G[:6, :6], g = G[:6, 6], e_sum = G[7, 7]."""
    dtype, dev = DT.dtype, DT.device
    if not (cfg.use_points or cfg.use_lines):
        return (torch.zeros((6, 6), dtype=dtype, device=dev),
                torch.zeros(6, dtype=dtype, device=dev),
                torch.zeros((), dtype=dtype, device=dev))
    if cfg.use_points:
        m_p = pts.valid & pts.inlier
        r_p, J_p = point_residuals(DT, pts, cam)
        # zero masked rows before they reach H: padded rows can hold
        # degenerate geometry, and 0 * NaN is NaN
        r_p = torch.where(m_p, r_p, 0.0)
        J_p = torch.where(m_p[..., None], J_p, 0.0)
    if cfg.use_lines:
        m_l = ls.valid & ls.inlier
        if cfg.plucker_lines:
            r_l, J_l, _, _ = line_residuals_plucker(DT, ls, cam)
            r_g = r_l * torch.sqrt(ls.sigma2)   # stereoFrameHandler.cpp:760
        else:
            r_l, J_l, _, _ = line_residuals_endpoint(DT, ls, cam)
            r_g = r_l
        r_l = torch.where(m_l, r_l, 0.0)
        r_g = torch.where(m_l, r_g, 0.0)
        J_l = torch.where(m_l[..., None], J_l, 0.0)

    if cfg.use_points and cfg.use_lines:
        s_p, s_l = robust.clipped_mad_scale_pair(r_p, m_p, r_l, m_l)
    elif cfg.use_points:
        s_p = robust.clipped_mad_scale(r_p, m_p)
    else:
        s_l = robust.clipped_mad_scale(r_l, m_l)

    rows = []
    if cfg.use_points:
        w_p = torch.where(m_p, robust.cauchy_weight(r_p / s_p), 0.0)
        rows.append((w_p, J_p, r_p, r_p, m_p))
    if cfg.use_lines:
        sp_proj = cam.project(lie.transform_point(DT, ls.sP))
        ep_proj = cam.project(lie.transform_point(DT, ls.eP))
        overlap = f2f_line_overlap(ls.sp, ls.ep, sp_proj, ep_proj)
        w_l = torch.where(m_l, robust.cauchy_weight(r_l / s_l) * overlap, 0.0)
        rows.append((w_l, J_l, r_g, r_l, m_l))

    w = torch.cat([t[0] for t in rows])
    A = torch.cat([torch.cat([t[1], t[2][:, None], t[3][:, None]], dim=-1)
                   for t in rows])                               # (N, 8)
    G = (A * w[:, None]).T @ A
    n_sum = sum(t[4].to(dtype).sum() for t in rows)
    err = G[7, 7] / torch.clamp(n_sum, min=1.0)
    return G[:6, :6], G[:6, 6], err


def _cholesky(A: torch.Tensor):
    """(L, ok): ok = factorisation succeeded, finite, positive diagonal."""
    L, info = torch.linalg.cholesky_ex(A)
    ok = ((info == 0) & torch.isfinite(L).all()
          & (torch.diagonal(L, dim1=-2, dim2=-1) > 0).all())
    return L, ok


def _solve_spd(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A^-1 B for SPD A; NaN when A is not SPD (as the JAX scan-Cholesky)."""
    L, ok = _cholesky(A)
    return torch.where(ok, torch.cholesky_solve(B, L), torch.nan)


class GNResult(NamedTuple):
    DT: torch.Tensor
    cov: torch.Tensor
    err: torch.Tensor
    good: torch.Tensor
    done_in: tuple = ()     # each trip's done flag at its entry (0-d bools)


def gauss_newton(DT0: torch.Tensor, pts: TrackedPoints, ls: TrackedLines,
                 cam: StereoCamera, cfg: TrackerConfig, max_iters: int) -> GNResult:
    """GN with the reference's stopping rules (:803-853) as a fixed-trip
    masked loop in the form ``cfg.early_exit`` names (module docstring)."""
    dtype, dev = DT0.dtype, DT0.device
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    DT = DT0
    err_prev = torch.full((), 9.9e8, dtype=dtype, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    good = torch.ones((), dtype=torch.bool, device=dev)
    done_in = []
    for _ in range(max_iters):
        done_in.append(done)
        H, g, err = build_normal_equations(DT, pts, ls, cam, cfg)
        stop = (torch.abs(err - err_prev) < cfg.min_error_change) | (err < cfg.min_error)
        L, chol_ok = _cholesky(H)
        delta = torch.cholesky_solve(g[:, None], L)[:, 0]
        ok = chol_ok & torch.isfinite(delta).all()
        halt = done | stop | ~ok
        step = torch.where(halt, 0.0, delta)
        small = torch.linalg.norm(step) < cfg.min_error_change
        if cfg.early_exit:
            # a converged carry freezes: the early-exit loop's iterates
            DT = torch.where(done, DT, lie.exp_se3(-step) @ DT)
            good = torch.where(done, good, good & (ok | stop))
        else:
            # the scan's carry: exp(-0) @ DT, and good updates on every trip
            DT = lie.exp_se3(-step) @ DT
            good = good & (ok | stop)
        err_prev = torch.where(done, err_prev, err)
        done = halt | small
    H, _, err_final = build_normal_equations(DT, pts, ls, cam, cfg)
    cov = torch.where(good, _solve_spd(H, eye6), eye6)
    return GNResult(DT=DT, cov=cov, err=torch.where(good, err_final, -1.0), good=good,
                    done_in=tuple(done_in))


def trips_used(done_in: tuple) -> torch.Tensor:
    """f32: the trips that entered not done, in one stack and one sum, not a
    kernel a trip."""
    return len(done_in) - torch.stack(done_in).sum(dtype=torch.float32)


def remove_outliers(DT: torch.Tensor, pts: TrackedPoints, ls: TrackedLines,
                    cam: StereoCamera, cfg: TrackerConfig):
    """Flag |r*sqrt(sigma2) - mean| > inlier_k * mad_stdv (:1303-1463);
    lines are also gated absolutely at line_abs_gate px."""
    if cfg.use_points:
        r_p, _ = point_residuals(DT, pts, cam)
        r_p = r_p * torch.sqrt(pts.sigma2)
        mean_p, stdv_p = robust.mean_stdv_mad(r_p, pts.valid)
        keep_p = torch.abs(r_p - mean_p) <= cfg.inlier_k * stdv_p
        pts = pts._replace(inlier=pts.inlier & (keep_p | ~pts.valid))
    if cfg.use_lines:
        if cfg.plucker_lines:
            r_l = line_residuals_plucker(DT, ls, cam)[0]
        else:
            r_l = line_residuals_endpoint(DT, ls, cam)[0]
        r_l = r_l * torch.sqrt(ls.sigma2)
        mean_l, stdv_l = robust.mean_stdv_mad(r_l, ls.valid)
        keep_l = ((torch.abs(r_l - mean_l) <= cfg.inlier_k * stdv_l)
                  & (torch.abs(r_l) <= cfg.line_abs_gate))
        ls = ls._replace(inlier=ls.inlier & (keep_l | ~ls.valid))
    return pts, ls


def is_good_solution(DT: torch.Tensor, cov: torch.Tensor, err: torch.Tensor):
    """Covariance PSD with Gershgorin upper bound <= 1, 0 <= err <= 1,
    finite pose (isGoodSolution :292)."""
    diag = torch.diagonal(cov, dim1=-2, dim2=-1)
    hi = (diag + torch.abs(cov).sum(-1) - torch.abs(diag)).amax(-1)
    eye6 = torch.eye(6, dtype=cov.dtype, device=cov.device)
    _, psd = _cholesky(cov + 1e-18 * eye6)
    return psd & (hi <= 1.0) & (err >= 0.0) & (err <= 1.0) & torch.isfinite(DT).all()


class PoseEstimate(NamedTuple):
    DT: torch.Tensor
    cov: torch.Tensor
    err: torch.Tensor
    n_inliers: torch.Tensor
    good: torch.Tensor
    done_in: tuple              # both solves' ``GNResult.done_in``, in trip order


def _count(m: torch.Tensor) -> torch.Tensor:
    return m.sum(dtype=torch.int32)


def optimize_pose(pts: TrackedPoints, ls: TrackedLines, cam: StereoCamera,
                  cfg: TrackerConfig, DT_init: torch.Tensor | None = None):
    """GN -> outlier removal -> refinement from the round-1 pose, with the
    identity fallback when anything degenerates (optimizePose :307-430)."""
    dtype, dev = pts.P.dtype, pts.P.device
    I4 = torch.eye(4, dtype=dtype, device=dev)
    Z6 = torch.zeros((6, 6), dtype=dtype, device=dev)
    DT0 = I4 if DT_init is None else DT_init

    n_pts0 = _count(pts.valid & pts.inlier)
    enough0 = (n_pts0 + _count(ls.valid & ls.inlier)) >= cfg.min_features
    # round 1: plentiful points fix the pose alone
    defer = (n_pts0 >= cfg.defer_lines_min_pts) & cfg.use_points
    ls_r1 = ls._replace(inlier=ls.inlier & ~defer)
    first = gauss_newton(DT0, pts, ls_r1, cam, cfg, cfg.max_iters)
    good1 = is_good_solution(first.DT, first.cov, first.err) & enough0

    pts2, ls2 = remove_outliers(first.DT, pts, ls, cam, cfg)
    pts2 = pts2._replace(inlier=torch.where(good1, pts2.inlier, pts.inlier))
    ls2 = ls2._replace(inlier=torch.where(good1, ls2.inlier, ls.inlier))
    n1 = _count(pts2.valid & pts2.inlier) + _count(ls2.valid & ls2.inlier)
    enough1 = n1 >= cfg.min_features

    refined = gauss_newton(torch.where(good1, first.DT, DT0), pts2, ls2, cam, cfg,
                           cfg.max_iters_ref)
    use_refined = good1 & enough1
    DT = torch.where(use_refined, refined.DT, torch.where(good1, first.DT, I4))
    cov = torch.where(use_refined, refined.cov, torch.where(good1, first.cov, Z6))
    err = torch.where(use_refined, refined.err, torch.where(good1, first.err, -1.0))

    final_good = is_good_solution(DT, cov, err) & enough0
    est = PoseEstimate(DT=torch.where(final_good, DT, I4),
                       cov=torch.where(final_good, cov, Z6),
                       err=torch.where(final_good, err, -1.0),
                       n_inliers=n1, good=final_good,
                       done_in=first.done_in + refined.done_in)
    return est, pts2, ls2
