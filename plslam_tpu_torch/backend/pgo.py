"""SE(3) pose-graph optimization, the loop-closure correction
(``plslam_tpu.backend.pgo``; reference ``src/mapHandler.cpp``
loopClosureOptimizationEssGraphG2O :5070-5299 and
loopClosureOptimizationCovGraphG2O :5301-5531).

Edge residuals e_ij = log(Z_ij^-1 T_i^-1 T_j) and their Jacobians with
respect to right perturbations T exp(delta) of both poses are scattered
into a dense (K, K, 6, 6) Gauss-Newton system, solved with
``cholesky_ex``.  The JAX package differentiates the residual with
``jax.jacfwd``; here the same derivatives are closed form: with
X = Z^-1 T_i^-1 T_j and e = log X,
    de/d delta_j = Jr^-1(e),   de/d delta_i = -Jr^-1(e) Ad(T_j^-1 T_i),
Jr^-1 the inverse right Jacobian of SE(3) (Barfoot, "State Estimation for
Robotics", 7.1.5).  The poses come from host float64 and the PGO runs in
float64; the fixed-trip loop takes a zero step when the solve is not
finite, with no host sync; its iterations can be one captured graph
replayed (``graphs.Trips``).  The edges' blocks are summed in a fixed
order (``core/segment.py``), so a PGO repeats bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import graphs
from ..core import lie, linalg
from ..core.plucker import transform_plucker
from ..core.segment import SegmentPlan, segment_plan, segment_sum


class PoseGraph(NamedTuple):
    T_w_k: torch.Tensor   # (K, 4, 4) keyframe poses (kf -> world)
    fixed: torch.Tensor   # (K,) bool gauge mask
    valid: torch.Tensor   # (K,) bool
    e_i: torch.Tensor     # (E,) int64 edge source
    e_j: torch.Tensor     # (E,) int64 edge target
    e_T: torch.Tensor     # (E, 4, 4) measured T_i^-1 T_j
    e_info: torch.Tensor  # (E,) scalar information weight
    e_valid: torch.Tensor  # (E,) bool


def edge_residual(Ti, Tj, Zij):
    """e = log(Z_ij^-1 T_i^-1 T_j), zero when the measurement holds."""
    return lie.log_se3(lie.inv_se3(Zij) @ lie.inv_se3(Ti) @ Tj)


def _series(theta, direct, taylor):
    """A coefficient of theta: its Taylor series below 1e-2 (the direct
    form cancels there), else the direct form."""
    small = theta < 1e-2
    ts = torch.where(small, torch.ones_like(theta), theta)
    return torch.where(small, taylor(theta * theta), direct(ts))


def _inv_left_jacobian_se3(xi):
    """Jl^-1(xi) of SE(3), xi = [rho; phi]: [[Jl^-1, -Jl^-1 Q Jl^-1], [0,
    Jl^-1]], Q(rho, phi) the translation block of Jl."""
    rho, phi = xi[..., :3], xi[..., 3:]
    theta = torch.linalg.norm(phi, dim=-1)[..., None, None]
    P, Rh = lie.skew(phi), lie.skew(rho)
    PR, RP = P @ Rh, Rh @ P
    a = _series(theta, lambda t: (t - torch.sin(t)) / t ** 3,
                lambda t2: 1.0 / 6.0 - t2 / 120.0)
    b = _series(theta, lambda t: (t * t + 2.0 * torch.cos(t) - 2.0) / (2.0 * t ** 4),
                lambda t2: 1.0 / 24.0 - t2 / 720.0)
    c = _series(theta, lambda t: (2.0 * t - 3.0 * torch.sin(t) + t * torch.cos(t))
                / (2.0 * t ** 5), lambda t2: 1.0 / 120.0 - t2 / 2520.0)
    PRP = PR @ P
    Q = 0.5 * Rh + a * (PR + RP + PRP) + b * (P @ PR + RP @ P - 3.0 * PRP) \
        + c * (PRP @ P + P @ PRP)
    Ji = lie.inv_left_jacobian_so3(phi)
    return torch.cat([torch.cat([Ji, -Ji @ Q @ Ji], dim=-1),
                      torch.cat([torch.zeros_like(Ji), Ji], dim=-1)], dim=-2)


def _adjoint(T):
    """Ad(T) = [[R, t^ R], [0, R]] for the [t; w] twist layout."""
    R = T[..., :3, :3]
    return torch.cat([torch.cat([R, lie.skew(T[..., :3, 3]) @ R], dim=-1),
                      torch.cat([torch.zeros_like(R), R], dim=-1)], dim=-2)


def edge_res_and_jac(Ti, Tj, Zij):
    """Batched residuals (E, 6) and Jacobians (E, 6, 6) wrt the right
    perturbations T exp(delta) of Ti and Tj."""
    e = edge_residual(Ti, Tj, Zij)
    Jr_inv = _inv_left_jacobian_se3(-e)          # Jr^-1(e) = Jl^-1(-e)
    return e, -Jr_inv @ _adjoint(lie.inv_se3(Tj) @ Ti), Jr_inv


class SystemPlans(NamedTuple):
    """Segment plans of the edges' blocks in H and b (``core/segment.py``)."""

    H: SegmentPlan
    b: SegmentPlan


def system_plans(g: PoseGraph) -> SystemPlans:
    """They depend only on the edge indices: one serves every iteration."""
    K = g.T_w_k.shape[0]
    rows = torch.cat([g.e_i, g.e_j, g.e_i, g.e_j])
    cols = torch.cat([g.e_i, g.e_j, g.e_j, g.e_i])
    return SystemPlans(segment_plan(rows * K + cols, K * K),
                       segment_plan(torch.cat([g.e_i, g.e_j]), K))


def build_system(g: PoseGraph, plans: SystemPlans | None = None):
    """The dense Gauss-Newton system (H (K, K, 6, 6), b (K, 6), cost),
    blocks summed in a fixed order."""
    K = g.T_w_k.shape[0]
    plans = system_plans(g) if plans is None else plans
    e, Ji, Jj = edge_res_and_jac(g.T_w_k[g.e_i], g.T_w_k[g.e_j], g.e_T)
    w = torch.where(g.e_valid, g.e_info, 0.0)[:, None, None]
    JiT, JjT = Ji.transpose(1, 2), Jj.transpose(1, 2)
    H = segment_sum(torch.cat([w * JiT @ Ji, w * JjT @ Jj, w * JiT @ Jj, w * JjT @ Ji]),
                    plans.H).view(K, K, 6, 6)
    b = segment_sum(torch.cat([(w * JiT @ e[..., None])[..., 0],
                               (w * JjT @ e[..., None])[..., 0]]), plans.b)
    cost = torch.sum(w[:, 0, 0] * torch.sum(e * e, dim=-1))
    return H, b, cost


def optimize(g: PoseGraph, iters: int = 10, damping: float = 1e-6, allsum=None, *,
             capture: bool = False, report: dict | None = None) -> PoseGraph:
    """Fixed-trip Gauss-Newton.  Fixed and invalid poses get identity rows
    and a zero right-hand side; a non-finite step becomes a zero step.
    The iterations run as one ``graphs.Trips`` program over a static pose
    buffer: with ``capture`` on a CUDA device the warm-ups are the first
    iterations and the others replay one graph, which the call drops at
    its end; ``capture=False`` runs the same iterations eagerly.
    ``report``, when given, receives the trips' ``graphs.Trips.stats``.
    ``allsum``: when each rank holds a block of the edges
    (``parallel/dist_match.make_dist_pgo``), the function that sums a
    tuple of tensors over the ranks; H and b are summed, and every rank
    solves.  That form runs eagerly."""
    if allsum is not None and capture:
        raise ValueError("the edge-sharded PGO runs collectives: it is not captured")
    K = g.T_w_k.shape[0]
    dtype, dev = g.T_w_k.dtype, g.T_w_k.device
    free = (g.valid & ~g.fixed).to(dtype)
    I6 = torch.eye(6, dtype=dtype, device=dev)
    gauge = I6 * (1.0 - free)[:, None, None] + damping * I6
    T = g.T_w_k.clone()   # the static pose buffer every iteration reads and writes back
    plans = system_plans(g)

    def trip():
        H, b, _ = build_system(g._replace(T_w_k=T), plans)
        if allsum is not None:
            H, b = allsum((H, b))
        Hm = H * free[:, None, None, None] * free[None, :, None, None]
        Hm.diagonal(dim1=0, dim2=1).add_(gauge.permute(1, 2, 0))
        Hmat = Hm.permute(0, 2, 1, 3).reshape(6 * K, 6 * K)
        delta = linalg.solve_spd(Hmat, (b * free[:, None]).reshape(-1)).reshape(K, 6)
        delta = torch.where(torch.isfinite(delta).all(), delta, 0.0)
        T.copy_(T @ lie.exp_se3(-delta))

    with graphs.Trips(trip, dev, iters, capture=capture) as trips:
        trips.run(iters)
        if report is not None:
            report.update(trips.stats())
    return g._replace(T_w_k=T)


def _relative(T_old, T_new):
    return T_new @ lie.inv_se3(T_old)


def correct_landmarks(T_old, T_new, owner_kf, points):
    """Drag landmarks rigidly with their owner keyframe's correction
    (mapHandler.cpp:5219-5287): X' = T_new T_old^-1 X."""
    return lie.transform_point(_relative(T_old, T_new)[owner_kf], points)


def correct_plucker_landmarks(T_old, T_new, owner_kf, lines):
    return transform_plucker(_relative(T_old, T_new)[owner_kf], lines)
