"""Bundle adjustment: batched Levenberg-Marquardt with an explicit Schur
complement (``plslam_tpu.backend.ba``; reference ``src/mapHandler.cpp``
localBundleAdjustmentForPlukerWithG2O :5851-6323 and the edge math of
``g2o_types/g2o_types.h`` EdgePosePoint :206 / EdgePoseLine :302).

Poses are T_c_w (world -> camera) with left-multiplicative twist updates;
points are world 3-vectors; lines are 4-DoF orthonormal coordinates of
world Pluecker lines with box-plus updates.  The two-round schedule
(optimize, drop chi^2 > 5.991 edges, re-optimize) is kept.

Differences of form from the JAX package, none of semantics:
- normal-equation blocks are segment sums in a fixed order
  (``core/segment.py``), the camera-landmark coupling W over a flat
  ``cam * n_lm + lm`` index; the sort behind them is planned once per
  problem (``assembly_plans``), so an LM run repeats bit for bit;
- the reduced camera system is factored with ``torch.linalg.cholesky_ex``;
  a failed factorization gives a NaN step, which the LM rejects, as the
  JAX scan-Cholesky's NaN columns do;
- the LM early exit is a fixed-trip loop with a mask that freezes the
  whole carry once the no-progress streak is reached: the same iterates
  as the JAX ``while_loop``, with no host sync.
Index fields of ``BAProblem`` are int64 here.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import graphs
from ..core import lie, linalg
from ..core.camera import StereoCamera
from ..core.plucker import (jac_plucker_wrt_orth, orth_plus, orth_to_plucker,
                            plucker_motion_matrix)
from ..core.segment import SegmentPlan, segment_plan, segment_sum

CHI2_TH = 5.991  # 2-DoF chi-square 95% gate (mapHandler.cpp:5978, :6131)
HOMOG = 1e-7


def _check_precision() -> None:
    """The solver needs full-f32 matmuls (``device.py`` turns TF32 off);
    TF32 passes stalled the JAX package's LM on the TPU's bf16 analogue."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("BA needs torch.backends.cuda.matmul.allow_tf32 = False "
                           "(plslam_tpu_torch.device.set_precision_policy)")


class BAProblem(NamedTuple):
    """Padded, fixed-shape BA problem: K poses, P points, L lines, Np point
    observations, Nl line observations."""

    T_c_w: torch.Tensor        # (K, 4, 4) world->camera
    pose_fixed: torch.Tensor   # (K,) bool
    pose_valid: torch.Tensor   # (K,) bool
    points: torch.Tensor       # (P, 3)
    point_valid: torch.Tensor  # (P,) bool
    lines_orth: torch.Tensor   # (L, 4)
    lines_scale: torch.Tensor  # (L,) norm of the Pluecker 6-vector
    line_valid: torch.Tensor   # (L,) bool
    p_cam: torch.Tensor        # (Np,) int64 pose slot
    p_lm: torch.Tensor         # (Np,) int64 point slot
    p_uv: torch.Tensor         # (Np, 2)
    p_sigma2: torch.Tensor     # (Np,)
    p_valid: torch.Tensor      # (Np,) bool
    l_cam: torch.Tensor        # (Nl,) int64
    l_lm: torch.Tensor         # (Nl,) int64
    l_sobs: torch.Tensor       # (Nl, 2)
    l_eobs: torch.Tensor       # (Nl, 2)
    l_sigma2: torch.Tensor     # (Nl,)
    l_valid: torch.Tensor      # (Nl,) bool
    # endpoint-line mode: per point obs, the observed image line (a, b, c)
    # and whether the row is a point-to-line residual
    p_lo: Optional[torch.Tensor] = None       # (Np, 3)
    p_is_line: Optional[torch.Tensor] = None  # (Np,) bool


class BAConfig(NamedTuple):
    """Solver settings; see ``plslam_tpu.backend.ba.BAConfig`` for the
    measured reasons behind the two endpoint damping regimes and the LM
    early exit."""

    iters1: int = 5
    iters2: int = 10
    lambda_init: float = 1e-4
    lambda_factor: float = 10.0
    huber_delta: float = CHI2_TH ** 0.5
    chi2_gate: float = CHI2_TH
    optimize_lines: bool = True
    optimize_points: bool = True
    tikhonov: float = 1e-6
    tikhonov_endpoint: float = 1e-4
    tikhonov_endpoint_warm: float = 1e-4
    early_exit: bool = True
    lm_min_rel_decrease: float = 1e-6
    lm_exit_streak: int = 2


# ---------------------------------------------------------------------------
# Residuals / Jacobians per observation
# ---------------------------------------------------------------------------


def _point_proj(prob: BAProblem, cam: StereoCamera):
    T = prob.T_c_w[prob.p_cam]
    Pc = lie.transform_point(T, prob.points[prob.p_lm])
    return T, Pc, cam.project(Pc)


def _point_e(prob: BAProblem, proj: torch.Tensor) -> torch.Tensor:
    e = proj - prob.p_uv
    if prob.p_lo is None:
        return e
    lo = prob.p_lo
    e_line = lo[..., 0] * proj[..., 0] + lo[..., 1] * proj[..., 1] + lo[..., 2]
    return torch.where(prob.p_is_line[:, None],
                       torch.stack([e_line, torch.zeros_like(e_line)], dim=-1), e)


def point_obs_residuals(prob: BAProblem, cam: StereoCamera):
    """2-vec reprojection residual per point obs and its Jacobians wrt the
    pose twist (6) and the world point (3) (g2o_types.h :206-300); endpoint
    rows carry the point-to-line residual in row 0."""
    T, Pc, proj = _point_proj(prob, cam)
    e = _point_e(prob, proj)
    x, y, z = Pc[..., 0], Pc[..., 1], Pc[..., 2]
    zs = torch.clamp(z, min=HOMOG)
    z2 = zs * zs
    zeros = torch.zeros_like(z)
    Jproj = torch.stack([
        torch.stack([cam.fx / zs, zeros, -cam.fx * x / z2], dim=-1),
        torch.stack([zeros, cam.fy / zs, -cam.fy * y / z2], dim=-1),
    ], dim=-2)                                                 # (Np, 2, 3)
    I3 = torch.eye(3, dtype=Pc.dtype, device=Pc.device).expand(Pc.shape[:-1] + (3, 3))
    dPc_ddelta = torch.cat([I3, -lie.skew(Pc)], dim=-1)        # (Np, 3, 6)
    J_pose = Jproj @ dPc_ddelta                                # (Np, 2, 6)
    J_pt = Jproj @ T[..., :3, :3]                              # (Np, 2, 3)
    if prob.p_lo is not None:
        lxy = prob.p_lo[..., None, :2]                         # (Np, 1, 2)
        is_l = prob.p_is_line[:, None, None]
        J_pose = torch.where(is_l, torch.cat([lxy @ J_pose, torch.zeros_like(J_pose[:, :1])],
                                             dim=-2), J_pose)
        J_pt = torch.where(is_l, torch.cat([lxy @ J_pt, torch.zeros_like(J_pt[:, :1])],
                                           dim=-2), J_pt)
    return e, J_pose, J_pt


def _line_geometry(prob: BAProblem, cam: StereoCamera):
    T = prob.T_c_w[prob.l_cam]
    scale = prob.lines_scale[prob.l_lm]
    Lw = orth_to_plucker(prob.lines_orth[prob.l_lm]) * scale[..., None]
    H = plucker_motion_matrix(T)
    Lc = (H @ Lw[..., None])[..., 0]
    l = cam.apply_plucker_K(Lc[..., :3])
    lx, ly, lz = l[..., 0], l[..., 1], l[..., 2]
    fm = 1.0 / torch.sqrt(torch.clamp(lx * lx + ly * ly, min=HOMOG))
    e0 = (prob.l_sobs[..., 0] * lx + prob.l_sobs[..., 1] * ly + lz) * fm
    e1 = (prob.l_eobs[..., 0] * lx + prob.l_eobs[..., 1] * ly + lz) * fm
    return torch.stack([e0, e1], dim=-1), (scale, Lw, H, Lc, l, fm)


def line_obs_residuals(prob: BAProblem, cam: StereoCamera):
    """2-vec endpoint-to-projected-line residual per line obs and its
    Jacobians wrt the pose twist (6) and the orth update (4)
    (g2o_types.h EdgePoseLine :302-453)."""
    e, (scale, Lw, H, Lc, l, fm) = _line_geometry(prob, cam)
    lx, ly = l[..., 0], l[..., 1]
    e0, e1 = e[..., 0], e[..., 1]
    a0, b0 = prob.l_sobs[..., 0], prob.l_sobs[..., 1]
    a1, b1 = prob.l_eobs[..., 0], prob.l_eobs[..., 1]
    de_dl = torch.stack([
        torch.stack([a0 * fm - lx * e0 * fm * fm, b0 * fm - ly * e0 * fm * fm, fm], dim=-1),
        torch.stack([a1 * fm - lx * e1 * fm * fm, b1 * fm - ly * e1 * fm * fm, fm], dim=-1),
    ], dim=-2)                                                 # (Nl, 2, 3)
    n_c, d_c = Lc[..., :3], Lc[..., 3:]
    dn = torch.cat([-lie.skew(d_c), -lie.skew(n_c)], dim=-1)   # (Nl, 3, 6)
    J_pose = de_dl @ cam.apply_plucker_K(dn, dim=-2)           # (Nl, 2, 6)
    # the unit-line Jacobian times the landmark's fixed scale
    dLw = jac_plucker_wrt_orth(Lw) * scale[..., None, None]    # (Nl, 6, 4)
    dLc = H @ dLw
    J_line = de_dl @ cam.apply_plucker_K(dLc[..., :3, :], dim=-2)  # (Nl, 2, 4)
    return e, J_pose, J_line


def cauchy_weight(e: torch.Tensor) -> torch.Tensor:
    """IRLS weight of the unit-scale Cauchy loss (auxiliar.cpp:556)."""
    return 1.0 / (1.0 + torch.sum(e * e, dim=-1))


def cauchy_cost(e: torch.Tensor) -> torch.Tensor:
    """rho(r) = log(1 + r^2), the loss whose IRLS weight is cauchy_weight."""
    return torch.log1p(torch.sum(e * e, dim=-1))


def _w(e: torch.Tensor, robust: bool) -> torch.Tensor:
    return cauchy_weight(e) if robust else torch.ones_like(e[..., 0])


def _rho(e: torch.Tensor, robust: bool) -> torch.Tensor:
    return cauchy_cost(e) if robust else torch.sum(e * e, dim=-1)


def chi2(e: torch.Tensor, sigma2: torch.Tensor) -> torch.Tensor:
    return torch.sum(e * e, dim=-1) * sigma2


# ---------------------------------------------------------------------------
# Normal equations + Schur complement
# ---------------------------------------------------------------------------


class _Assembled(NamedTuple):
    Hcc: torch.Tensor  # (K, 6, 6)
    bc: torch.Tensor   # (K, 6)
    Hpp: torch.Tensor  # (P, 3, 3)
    bp: torch.Tensor   # (P, 3)
    Wp: torch.Tensor   # (K, P, 6, 3)
    Hll: torch.Tensor  # (L, 4, 4)
    bl: torch.Tensor   # (L, 4)
    Wl: torch.Tensor   # (K, L, 6, 4)
    cost: torch.Tensor


class _ModalityPlans(NamedTuple):
    """Segment plans of one modality's observations: per camera, per
    landmark and per (camera, landmark) pair."""

    cam: SegmentPlan
    lm: SegmentPlan
    pair: SegmentPlan


class AssemblyPlans(NamedTuple):
    points: _ModalityPlans
    lines: _ModalityPlans


def _modality_plans(cam_idx, lm_idx, K: int, n_lm: int) -> _ModalityPlans:
    return _ModalityPlans(segment_plan(cam_idx, K), segment_plan(lm_idx, n_lm),
                          segment_plan(cam_idx * n_lm + lm_idx, K * n_lm))


def assembly_plans(prob: BAProblem) -> AssemblyPlans:
    """The observation indices' segment plans; they depend only on the
    index fields, so one plan serves every LM trip of a problem."""
    K = prob.T_c_w.shape[0]
    return AssemblyPlans(
        _modality_plans(prob.p_cam, prob.p_lm, K, prob.points.shape[0]),
        _modality_plans(prob.l_cam, prob.l_lm, K, prob.lines_orth.shape[0]))


def _accumulate(plans: _ModalityPlans, w, Jc, Jl, e):
    """Weighted normal-equation blocks of one modality, summed per camera,
    per landmark and per (camera, landmark) pair in the fixed order of
    ``core/segment.py`` (the same sums on every run and device)."""
    N, d = Jl.shape[0], Jl.shape[-1]
    wJcT = (w[:, None, None] * Jc).transpose(1, 2)
    wJlT = (w[:, None, None] * Jl).transpose(1, 2)
    cam = segment_sum(torch.cat([(wJcT @ Jc).reshape(N, 36),
                                 (wJcT @ e[..., None]).reshape(N, 6)], dim=1), plans.cam)
    lm = segment_sum(torch.cat([(wJlT @ Jl).reshape(N, d * d),
                                (wJlT @ e[..., None]).reshape(N, d)], dim=1), plans.lm)
    W = segment_sum(wJcT @ Jl, plans.pair)
    K, n_lm = cam.shape[0], lm.shape[0]
    return (cam[:, :36].reshape(K, 6, 6), cam[:, 36:], lm[:, :d * d].reshape(n_lm, d, d),
            lm[:, d * d:], W.view(K, n_lm, 6, d))


def _masked_cost(e, sigma2, active, robust):
    return torch.sum(torch.where(active, _rho(e, robust) * sigma2, 0.0))


def assemble(prob: BAProblem, cam: StereoCamera, cfg: BAConfig, p_active, l_active,
             robust: bool = True, plans: Optional[AssemblyPlans] = None) -> _Assembled:
    """The normal equations; ``plans`` are ``assembly_plans(prob)``, built
    here when not given."""
    plans = assembly_plans(prob) if plans is None else plans

    e_p, Jc_p, Jp_p = point_obs_residuals(prob, cam)
    w_p = torch.where(p_active, _w(e_p, robust) * prob.p_sigma2, 0.0)
    Hcc, bc, Hpp, bp, Wp = _accumulate(plans.points, w_p, Jc_p, Jp_p, e_p)
    cost = _masked_cost(e_p, prob.p_sigma2, p_active, robust)

    e_l, Jc_l, Jl_l = line_obs_residuals(prob, cam)
    w_l = torch.where(l_active, _w(e_l, robust) * prob.l_sigma2, 0.0)
    Hcc_l, bc_l, Hll, bl, Wl = _accumulate(plans.lines, w_l, Jc_l, Jl_l, e_l)
    cost = cost + _masked_cost(e_l, prob.l_sigma2, l_active, robust)
    return _Assembled(Hcc + Hcc_l, bc + bc_l, Hpp, bp, Wp, Hll, bl, Wl, cost)


def _trace(H: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(H, dim1=-2, dim2=-1).sum(-1)


def _damped_inv(Hblocks, lam, valid, dim: int, floor=1e-6, extra=None):
    """Per-landmark damped inverse (H + lam diag(H) + floor tr(H) I)^-1,
    zero for invalid or unobserved landmarks.  ``floor`` is a scalar or a
    per-block (n,) tensor; ``extra`` adds a per-block damping matrix."""
    diag = torch.eye(dim, dtype=Hblocks.dtype, device=Hblocks.device)
    tr = _trace(Hblocks)
    damped = Hblocks + lam * Hblocks * diag + (floor * tr + 1e-12)[:, None, None] * diag
    if extra is not None:
        damped = damped + extra
    use = (valid & (tr > 1e-12))[:, None, None]
    safe = torch.where(use, damped, diag)
    inv = linalg.inv3x3(safe) if dim == 3 else linalg.inv4x4(safe)
    return torch.where(use, inv, 0.0), use[:, 0, 0]


def _endpoint_slots(prob: BAProblem) -> torch.Tensor:
    P = prob.points.shape[0]
    cnt = torch.zeros(P, dtype=torch.int32, device=prob.points.device)
    return cnt.index_add_(0, prob.p_lm, prob.p_is_line.to(torch.int32)) > 0


def point_block_floor(prob: BAProblem, cfg: BAConfig) -> torch.Tensor:
    """Per-slot isotropic floor of WARM solves (dense local BA): endpoint
    slots get max(tikhonov, tikhonov_endpoint_warm)."""
    base = torch.full((prob.points.shape[0],), cfg.tikhonov, dtype=prob.points.dtype,
                      device=prob.points.device)
    if prob.p_is_line is None:
        return base
    return torch.where(_endpoint_slots(prob),
                       max(cfg.tikhonov, cfg.tikhonov_endpoint_warm), base)


def point_block_floor_global(prob: BAProblem, cfg: BAConfig) -> torch.Tensor:
    """Uniform light floor of COLD/GLOBAL solves (chunked GBA)."""
    return torch.full((prob.points.shape[0],), cfg.tikhonov, dtype=prob.points.dtype,
                      device=prob.points.device)


def point_block_aniso(prob: BAProblem, cfg: BAConfig, Hpp: torch.Tensor):
    """Damping of only the null direction of endpoint slots' rank-2 blocks
    (the cross product of the two most independent columns), strength
    tikhonov_endpoint * trace."""
    if prob.p_is_line is None:
        return None
    c0, c1, c2 = Hpp[..., 0], Hpp[..., 1], Hpp[..., 2]
    crosses = torch.stack([torch.linalg.cross(c0, c1), torch.linalg.cross(c1, c2),
                           torch.linalg.cross(c0, c2)], dim=1)     # (P, 3, 3)
    norms = torch.linalg.norm(crosses, dim=-1)
    best = torch.gather(crosses, 1, torch.argmax(norms, dim=1)[:, None, None]
                        .expand(-1, 1, 3))[:, 0]
    null = best / torch.clamp(torch.linalg.norm(best, dim=-1, keepdim=True), min=1e-30)
    aniso = (cfg.tikhonov_endpoint * _trace(Hpp))[:, None, None] \
        * null[:, :, None] * null[:, None, :]
    return torch.where(_endpoint_slots(prob)[:, None, None], aniso, 0.0)


def _landmark_inverses(a: _Assembled, prob: BAProblem, lam, cfg: BAConfig, mode: str):
    if mode == "global":
        floor = point_block_floor_global(prob, cfg)
        extra = point_block_aniso(prob, cfg, a.Hpp)
    else:
        floor = point_block_floor(prob, cfg)
        extra = None
    Hpp_inv, _ = _damped_inv(a.Hpp, lam, prob.point_valid, 3, floor, extra=extra)
    Hll_inv, _ = _damped_inv(a.Hll, lam, prob.line_valid, 4, cfg.tikhonov)
    return Hpp_inv, Hll_inv


def schur_partials(a: _Assembled, prob: BAProblem, lam, cfg: BAConfig = BAConfig(),
                   mode: str = "warm"):
    """Landmark-marginalized parts of the reduced camera system,
    S_off = -W Hll^-1 W^T and rhs = bc - W Hll^-1 b; additive over
    observation chunks."""
    Hpp_inv, Hll_inv = _landmark_inverses(a, prob, lam, cfg, mode)
    WHp = torch.einsum("kpab,pbc->kpac", a.Wp, Hpp_inv)
    WHl = torch.einsum("klab,lbc->klac", a.Wl, Hll_inv)
    S_off = -torch.einsum("kpac,qpdc->kqad", WHp, a.Wp) \
        - torch.einsum("klac,qldc->kqad", WHl, a.Wl)
    rhs = a.bc - torch.einsum("kpac,pc->ka", WHp, a.bp) \
        - torch.einsum("klac,lc->ka", WHl, a.bl)
    return Hpp_inv, Hll_inv, S_off, rhs


def solve_reduced(Hcc, S_off, rhs, lam, free) -> torch.Tensor:
    """Pose update from the damped reduced camera system; NaN when its
    Cholesky factorization fails (the LM then rejects the step)."""
    K = Hcc.shape[0]
    I6 = torch.eye(6, dtype=Hcc.dtype, device=Hcc.device)
    fmask = free.to(Hcc.dtype)
    S = S_off.clone()
    S.diagonal(dim1=0, dim2=1).add_((Hcc + lam * Hcc * I6).permute(1, 2, 0))
    # fixed or invalid poses: identity rows/cols, zero rhs
    S = S * fmask[:, None, None, None] * fmask[None, :, None, None]
    S.diagonal(dim1=0, dim2=1).add_((I6 * (1.0 - fmask)[:, None, None]).permute(1, 2, 0))
    b = (rhs * fmask[:, None]).reshape(-1)
    Smat = S.permute(0, 2, 1, 3).reshape(6 * K, 6 * K) \
        + 1e-10 * torch.eye(6 * K, dtype=Hcc.dtype, device=Hcc.device)
    L, ok = linalg.cholesky(Smat)
    x = linalg.cho_solve(L, b)
    # one step of iterative refinement: the reduced system's conditioning
    # (~1e6 on large maps) is at the edge of f32 Cholesky
    x = x + linalg.cho_solve(L, b - Smat @ x)
    x = torch.where(ok, x, torch.nan)
    return x.reshape(K, 6) * fmask[:, None]


def back_substitute(a: _Assembled, Hpp_inv, Hll_inv, dpose, cfg: BAConfig):
    """Landmark back-substitution dx = Hll^-1 (b - W^T dpose)."""
    tp = a.bp - torch.einsum("kpab,ka->pb", a.Wp, dpose)
    tl = a.bl - torch.einsum("klab,ka->lb", a.Wl, dpose)
    dpoint = (Hpp_inv @ tp[..., None])[..., 0]
    dline = (Hll_inv @ tl[..., None])[..., 0]
    if not cfg.optimize_points:
        dpoint = torch.zeros_like(dpoint)
    if not cfg.optimize_lines:
        dline = torch.zeros_like(dline)
    return dpoint, dline


def solve_schur(a: _Assembled, prob: BAProblem, cfg: BAConfig, lam, allsum=None):
    """One damped Schur solve: (dpose (K,6), dpoint (P,3), dline (L,4)).
    ``allsum`` sums Hcc, S_off and rhs over ranks that each hold a block of
    the landmarks (``parallel/dist_ba.py``)."""
    free = prob.pose_valid & ~prob.pose_fixed
    Hpp_inv, Hll_inv, S_off, rhs = schur_partials(a, prob, lam, cfg)
    Hcc = a.Hcc
    if allsum is not None:
        Hcc, S_off, rhs = allsum((Hcc, S_off, rhs))
    dpose = solve_reduced(Hcc, S_off, rhs, lam, free)
    dpoint, dline = back_substitute(a, Hpp_inv, Hll_inv, dpose, cfg)
    return dpose, dpoint, dline


def _pose_step(dpose, T):
    """T <- exp(-d) T (descent step, since b = J^T e)."""
    return lie.exp_se3(-dpose) @ T


def apply_update(prob: BAProblem, dpose, dpoint, dline) -> BAProblem:
    return prob._replace(T_c_w=_pose_step(dpose, prob.T_c_w),
                         points=prob.points - dpoint,
                         lines_orth=orth_plus(prob.lines_orth, -dline))


def total_cost(prob: BAProblem, cam: StereoCamera, cfg: BAConfig, p_active, l_active,
               robust: bool = True) -> torch.Tensor:
    e_p = _point_e(prob, _point_proj(prob, cam)[2])
    e_l, _ = _line_geometry(prob, cam)
    return (_masked_cost(e_p, prob.p_sigma2, p_active, robust)
            + _masked_cost(e_l, prob.l_sigma2, l_active, robust))


def _lm_select(ok, new, old):
    return torch.where(ok.reshape((1,) * new.dim()), new, old)


def lm_rounds(prob: BAProblem, cam: StereoCamera, cfg: BAConfig, p_active, l_active,
              iters: int, robust: bool = True, allsum=None):
    """LM with accept/reject damping (the reference's levMarquardt loop
    :2530-2600) as ``iters`` fixed trips.  With ``cfg.early_exit`` a trip
    after ``lm_exit_streak`` consecutive trips of relative decrease at most
    ``lm_min_rel_decrease`` changes nothing, which gives the iterates of
    the JAX ``while_loop``.  ``allsum``: when each rank holds a block of
    the landmarks and their observations (``parallel/dist_ba.py``), the
    function that sums a tensor, or a tuple of them, over the ranks; it
    combines the costs and the reduced camera system.  Returns (problem,
    cost, trips run)."""
    _check_precision()
    dev = prob.points.device

    def cost_of(p):
        c = total_cost(p, cam, cfg, p_active, l_active, robust)
        return c if allsum is None else allsum(c)

    lam = torch.full((), cfg.lambda_init, dtype=prob.points.dtype, device=dev)
    cost = cost_of(prob)
    streak = torch.zeros((), dtype=torch.int32, device=dev)
    trips = torch.zeros((), dtype=torch.int32, device=dev)
    exit_streak = cfg.lm_exit_streak if cfg.early_exit else iters + 1
    plans = assembly_plans(prob)
    for _ in range(iters):
        a = assemble(prob, cam, cfg, p_active, l_active, robust, plans)
        cand = apply_update(prob, *solve_schur(a, prob, cfg, lam, allsum))
        new_cost = cost_of(cand)
        run = streak < exit_streak
        ok = (new_cost < cost) & torch.isfinite(new_cost)
        rel = torch.where(ok, (cost - new_cost) / torch.clamp(cost, min=1e-30), 0.0)
        take = ok & run
        prob = prob._replace(T_c_w=_lm_select(take, cand.T_c_w, prob.T_c_w),
                             points=_lm_select(take, cand.points, prob.points),
                             lines_orth=_lm_select(take, cand.lines_orth, prob.lines_orth))
        lam_new = torch.clamp(torch.where(ok, lam / cfg.lambda_factor,
                                          lam * cfg.lambda_factor), 1e-9, 1e6)
        lam = torch.where(run, lam_new, lam)
        cost = torch.where(take, new_cost, cost)
        streak = torch.where(run, torch.where(rel > cfg.lm_min_rel_decrease,
                                              0, streak + 1), streak)
        trips = trips + run.to(torch.int32)
    return prob, cost, trips


class BAResult(NamedTuple):
    problem: BAProblem
    p_active: torch.Tensor
    l_active: torch.Tensor
    cost: torch.Tensor


def _gate(prob: BAProblem, cam: StereoCamera, cfg: BAConfig, p_active, l_active):
    """Drop observations with chi^2 above the gate (:6133-6152)."""
    e_p = _point_e(prob, _point_proj(prob, cam)[2])
    e_l, _ = _line_geometry(prob, cam)
    return (p_active & (chi2(e_p, prob.p_sigma2) <= cfg.chi2_gate),
            l_active & (chi2(e_l, prob.l_sigma2) <= cfg.chi2_gate))


def bundle_adjust(prob: BAProblem, cam: StereoCamera, cfg: BAConfig = BAConfig()) -> BAResult:
    """Two-round BA with chi^2 gating between rounds
    (localBundleAdjustmentForPlukerWithG2O :6119-6152); the Cauchy kernel
    stays on in round 2, as in the JAX package."""
    _check_precision()
    prob, _, _ = lm_rounds(prob, cam, cfg, prob.p_valid, prob.l_valid, cfg.iters1)
    p_active, l_active = _gate(prob, cam, cfg, prob.p_valid, prob.l_valid)
    prob, cost, _ = lm_rounds(prob, cam, cfg, p_active, l_active, cfg.iters2)
    return BAResult(problem=prob, p_active=p_active, l_active=l_active, cost=cost)


# ---------------------------------------------------------------------------
# Chunked global BA: Schur accumulation over fixed-shape landmark chunks
# ---------------------------------------------------------------------------

# Leaves of BAProblem that carry a leading chunk axis in the stacked global
# problem (poses are shared across chunks).
_CHUNK_LEAVES = (
    "points", "point_valid", "lines_orth", "lines_scale", "line_valid",
    "p_cam", "p_lm", "p_uv", "p_sigma2", "p_valid",
    "l_cam", "l_lm", "l_sobs", "l_eobs", "l_sigma2", "l_valid",
    "p_lo", "p_is_line",
)


def _chunk(prob: BAProblem, c: int, T, points, lines_orth) -> BAProblem:
    x = {f: getattr(prob, f)[c] for f in _CHUNK_LEAVES if getattr(prob, f) is not None}
    x.update(T_c_w=T, points=points, lines_orth=lines_orth)
    return prob._replace(**x)


def bundle_adjust_chunked(prob: BAProblem, cam: StereoCamera, cfg: BAConfig = BAConfig(),
                          gather=None, *, capture: bool = False,
                          report: dict | None = None) -> BAResult:
    """Global BA over every landmark, tiled in fixed-shape chunks
    (globalBundleAdjustment :3022-3126).  ``prob`` carries a leading chunk
    axis C on every landmark and observation leaf (``_CHUNK_LEAVES``) and
    unstacked pose leaves; chunks own their landmarks together with all
    their observations.  Per LM trip the reduced camera system is summed
    over the chunks, the pose update is solved once, and each chunk's
    landmarks are back-substituted.  Fixed trips, no early exit (as in the
    JAX package).

    The trips of both rounds run as one ``graphs.Trips`` program: a trip
    reads the LM carry (poses, landmarks, lambda, cost, the active masks)
    from static buffers and writes it back, so with ``capture`` on a CUDA
    device its warm-ups are the first trips and the others replay one
    graph, which the call drops at its end; ``capture=False`` runs the
    same trips eagerly.  The round-start cost and the chi^2 gate between
    the rounds run eagerly.  ``report``, when given, receives the trips'
    ``graphs.Trips.stats``.

    ``gather`` (the JAX ``axis_name``): when each rank holds a contiguous
    run of the chunks (``parallel/dist_gba.py``), the function that
    concatenates a tensor's leading axis over the ranks in chunk order.
    The chunks' costs and, after pass 1, their Hcc, S_off and rhs are then
    gathered and summed in chunk order on every rank: the sums, and so the
    result, of this solve in one process on all the chunks, bit for bit.
    The chi^2 gate stays per chunk.  That form runs eagerly."""
    _check_precision()
    if gather is not None and capture:
        raise ValueError("the gathered GBA runs collectives: it is not captured")
    C = prob.points.shape[0]
    K = prob.T_c_w.shape[0]
    free = prob.pose_valid & ~prob.pose_fixed
    dev = prob.points.device

    def chunk_sum(parts):
        """The sum over every chunk, in chunk order, of per-chunk tensors
        (a list over this rank's chunks)."""
        if gather is not None:
            parts = gather(torch.stack(parts)).unbind(0)
        total = torch.zeros_like(parts[0])
        for x in parts:
            total = total + x
        return total

    def cost_all(T, pts, ls, p_act, l_act):
        return chunk_sum([total_cost(_chunk(prob, c, T, pts[c], ls[c]), cam, cfg, p_act[c],
                                     l_act[c]) for c in range(C)])

    plans = [assembly_plans(_chunk(prob, c, prob.T_c_w, prob.points[c], prob.lines_orth[c]))
             for c in range(C)]
    # the LM carry: static buffers every trip reads and writes back
    T, pts, ls = prob.T_c_w.clone(), prob.points.clone(), prob.lines_orth.clone()
    p_act, l_act = prob.p_valid.clone(), prob.l_valid.clone()
    lam = torch.empty((), dtype=prob.points.dtype, device=dev)
    cost = torch.empty((), dtype=prob.points.dtype, device=dev)

    def trip():
        systems, parts = [], []
        for c in range(C):
            pr = _chunk(prob, c, T, pts[c], ls[c])
            a = assemble(pr, cam, cfg, p_act[c], l_act[c], plans=plans[c])
            Hpp_inv, Hll_inv, S_c, rhs_c = schur_partials(a, pr, lam, cfg, mode="global")
            systems.append(torch.cat([a.Hcc.reshape(-1), S_c.reshape(-1), rhs_c.reshape(-1)]))
            parts.append((a, Hpp_inv, Hll_inv))
        Hcc, S_off, rhs = chunk_sum(systems).split([K * 36, K * K * 36, K * 6])
        dpose = solve_reduced(Hcc.view(K, 6, 6), S_off.view(K, K, 6, 6), rhs.view(K, 6),
                              lam, free)
        T_new = _pose_step(dpose, T)
        cand_pts, cand_ls, costs = [], [], []
        for c, (a, Hpp_inv, Hll_inv) in enumerate(parts):
            dpoint, dline = back_substitute(a, Hpp_inv, Hll_inv, dpose, cfg)
            cand_pts.append(pts[c] - dpoint)
            cand_ls.append(orth_plus(ls[c], -dline))
            costs.append(total_cost(_chunk(prob, c, T_new, cand_pts[c], cand_ls[c]),
                                    cam, cfg, p_act[c], l_act[c]))
        new_cost = chunk_sum(costs)
        ok = (new_cost < cost) & torch.isfinite(new_cost)
        T_next = _lm_select(ok, T_new, T)
        pts_next = _lm_select(ok, torch.stack(cand_pts), pts)
        ls_next = _lm_select(ok, torch.stack(cand_ls), ls)
        lam_next = torch.clamp(torch.where(ok, lam / cfg.lambda_factor,
                                           lam * cfg.lambda_factor), 1e-9, 1e6)
        cost_next = torch.where(ok, new_cost, cost)
        for buf, x in ((T, T_next), (pts, pts_next), (ls, ls_next), (lam, lam_next),
                       (cost, cost_next)):
            buf.copy_(x)

    def start_round():
        lam.fill_(cfg.lambda_init)
        cost.copy_(cost_all(T, pts, ls, p_act, l_act))

    with graphs.Trips(trip, dev, cfg.iters1 + cfg.iters2, capture=capture) as trips:
        start_round()
        trips.run(cfg.iters1)
        gated = [_gate(_chunk(prob, c, T, pts[c], ls[c]), cam, cfg, p_act[c], l_act[c])
                 for c in range(C)]
        p_act.copy_(torch.stack([g[0] for g in gated]))
        l_act.copy_(torch.stack([g[1] for g in gated]))
        start_round()
        trips.run(cfg.iters2)
        if report is not None:
            report.update(trips.stats())
    out = prob._replace(T_c_w=T, points=pts, lines_orth=ls)
    return BAResult(problem=out, p_active=p_act, l_active=l_act, cost=cost)
