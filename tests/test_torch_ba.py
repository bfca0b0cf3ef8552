"""plslam_tpu_torch.backend.ba against plslam_tpu.backend.ba in float64 on
the same problems (tests/test_ba.make_problem and
tests/test_ba_endpoint.make_endpoint_problem, converted to numpy):
residuals and Jacobians to 1e-9, normal-equation and Schur blocks to 1e-8
relative, one Schur step to 1e-8, the LM iterates trip by trip, the
two-round BA, the chunked GBA, and a rejected non-SPD step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam_tpu.backend import ba as jba
from plslam_tpu.core.camera import StereoCamera as JCam
from plslam_tpu_torch.backend import ba
from plslam_tpu_torch.convert import ba_problem_from_numpy
from plslam_tpu_torch.core.camera import StereoCamera

from test_ba import make_problem
from test_ba_endpoint import make_endpoint_problem
from test_torch_helpers import one_torch_thread, to_np  # noqa: F401

# intrinsics whose line-projection products are exact in float32, so the
# port's f32-rounded K_L equals the JAX float64 one
INTR = (435.25, 435.25, 367.5, 252.25, 0.110074)
JC = JCam.create(*INTR, dtype=jnp.float64)
TC = StereoCamera.create(*INTR)
CFG = jba.BAConfig()
TCFG = ba.BAConfig()


def _np(prob):
    return jax.tree.map(np.asarray, prob)


def _port(prob):
    return ba_problem_from_numpy(_np(prob), "cpu")


def _rel_close(got, want, tol):
    got, want = to_np(got), np.asarray(want)
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


@pytest.fixture(scope="module")
def problems():
    noisy, *_ = make_problem(noise=0.5, pert=0.05)
    endpoint, *_ = make_endpoint_problem(pert=0.05)
    return {"plucker": noisy, "endpoint": endpoint}


@pytest.mark.parametrize("kind", ["plucker", "endpoint"])
def test_residuals_and_jacobians(problems, kind):
    jp = problems[kind]
    tp = _port(jp)
    for got, want in zip(ba.point_obs_residuals(tp, TC),
                         jax.jit(jba.point_obs_residuals)(jp, JC)):
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=0, atol=1e-9)
    if kind == "plucker":
        for got, want in zip(ba.line_obs_residuals(tp, TC),
                             jax.jit(jba.line_obs_residuals)(jp, JC)):
            np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=0, atol=1e-9)


@pytest.mark.parametrize("kind,mode", [("plucker", "warm"), ("endpoint", "warm"),
                                       ("endpoint", "global")])
def test_assemble_and_schur(problems, kind, mode):
    jp = problems[kind]
    tp = _port(jp)
    lam = 1e-3
    ja = jax.jit(jba.assemble, static_argnums=(2, 5))(jp, JC, CFG, jp.p_valid, jp.l_valid, True)
    ta = ba.assemble(tp, TC, TCFG, tp.p_valid, tp.l_valid, True)
    for name in ja._fields:
        _rel_close(getattr(ta, name), getattr(ja, name), 1e-8)
    want = jax.jit(jba.schur_partials, static_argnums=(3, 4))(ja, jp, lam, CFG, mode)
    got = ba.schur_partials(ta, tp, torch.tensor(lam, dtype=torch.float64), TCFG, mode)
    for g, w in zip(got, want):
        _rel_close(g, w, 1e-8)


@pytest.mark.parametrize("kind", ["plucker", "endpoint"])
def test_one_schur_step(problems, kind):
    jp = problems[kind]
    tp = _port(jp)
    lam = 1e-4

    @jax.jit
    def jstep(p):
        a = jba.assemble(p, JC, CFG, p.p_valid, p.l_valid)
        return jba.apply_update(p, *jba.solve_schur(a, p, CFG, lam))

    a = ba.assemble(tp, TC, TCFG, tp.p_valid, tp.l_valid)
    got = ba.apply_update(tp, *ba.solve_schur(a, tp, TCFG, torch.tensor(lam, dtype=torch.float64)))
    want = jstep(jp)
    for name in ("T_c_w", "points", "lines_orth"):
        np.testing.assert_allclose(to_np(getattr(got, name)), np.asarray(getattr(want, name)),
                                   rtol=0, atol=1e-8, err_msg=name)


def _jax_lm_mirror(jp, iters):
    """The JAX lm_rounds while-loop driven from Python, counting trips."""
    @jax.jit
    def trip(p, lam, cost):
        a = jba.assemble(p, JC, CFG, p.p_valid, p.l_valid)
        cand = jba.apply_update(p, *jba.solve_schur(a, p, CFG, lam))
        return cand, jba.total_cost(cand, JC, CFG, p.p_valid, p.l_valid)

    cost = jax.jit(jba.total_cost, static_argnums=2)(jp, JC, CFG, jp.p_valid, jp.l_valid)
    lam = jnp.asarray(CFG.lambda_init, jnp.float64)
    streak = trips = 0
    costs = []
    while trips < iters and streak < CFG.lm_exit_streak:
        cand, new = trip(jp, lam, cost)
        ok = bool(new < cost) and bool(jnp.isfinite(new))
        rel = float((cost - new) / jnp.maximum(cost, 1e-30)) if ok else 0.0
        if ok:
            jp, cost = cand, new
        lam = jnp.clip(lam / CFG.lambda_factor if ok else lam * CFG.lambda_factor, 1e-9, 1e6)
        streak = 0 if rel > CFG.lm_min_rel_decrease else streak + 1
        trips += 1
        costs.append(float(cost))
    return jp, cost, trips, costs


def test_lm_rounds_early_exit_iterates():
    # converges in 12 trips, the last two below the relative-decrease bar
    jp, *_ = make_problem(noise=0.3, pert=0.02)
    iters = 15
    mirror, mcost, mtrips, mcosts = _jax_lm_mirror(jp, iters)
    jres, jcost = jax.jit(lambda p: jba.lm_rounds(p, JC, CFG, p.p_valid, p.l_valid, iters))(jp)
    np.testing.assert_array_equal(np.asarray(mirror.T_c_w), np.asarray(jres.T_c_w))
    assert mtrips < iters, "the early exit did not fire"

    tp = _port(jp)
    tres, tcost, ttrips = ba.lm_rounds(tp, TC, TCFG, tp.p_valid, tp.l_valid, iters)
    assert int(ttrips) == mtrips
    np.testing.assert_allclose(float(tcost), float(jcost), rtol=1e-8, atol=1e-18)
    # the iterates after the first trips and around the exit
    for n in sorted({1, 2, mtrips - 2, mtrips - 1, mtrips}):
        _, c, tr = ba.lm_rounds(tp, TC, TCFG, tp.p_valid, tp.l_valid, n)
        assert int(tr) == n
        np.testing.assert_allclose(float(c), mcosts[n - 1], rtol=1e-8, atol=1e-18)
    np.testing.assert_allclose(to_np(tres.T_c_w), np.asarray(jres.T_c_w), rtol=0, atol=1e-7)


def test_bundle_adjust_two_rounds():
    jp, *_ = make_problem(noise=0.2, pert=0.02)
    uv = np.asarray(jp.p_uv).copy()
    bad = np.random.default_rng(11).choice(len(uv), size=8, replace=False)
    uv[bad] += 50.0
    jp = jp._replace(p_uv=jnp.asarray(uv))
    jres = jax.jit(jba.bundle_adjust, static_argnums=2)(jp, JC, CFG)
    tres = ba.bundle_adjust(_port(jp), TC, TCFG)
    np.testing.assert_array_equal(to_np(tres.p_active), np.asarray(jres.p_active))
    np.testing.assert_array_equal(to_np(tres.l_active), np.asarray(jres.l_active))
    assert not to_np(tres.p_active)[bad].any()
    for name in ("T_c_w", "points", "lines_orth"):
        np.testing.assert_allclose(to_np(getattr(tres.problem, name)),
                                   np.asarray(getattr(jres.problem, name)),
                                   rtol=0, atol=1e-7, err_msg=name)
    np.testing.assert_allclose(float(tres.cost), float(jres.cost), rtol=1e-7)


def _two_chunks(prob):
    """Split a make_problem problem into two landmark-disjoint chunks that
    own all their observations, stacked on a leading axis."""
    p = _np(prob)
    P, L = len(p.points), len(p.lines_orth)
    chunks = []
    for c in range(2):
        pts = np.arange(P)[c * P // 2:(c + 1) * P // 2]
        lns = np.arange(L)[c * L // 2:(c + 1) * L // 2]
        po = np.where(np.isin(p.p_lm, pts))[0]
        lo = np.where(np.isin(p.l_lm, lns))[0]
        chunks.append(dict(
            points=p.points[pts], point_valid=p.point_valid[pts],
            lines_orth=p.lines_orth[lns], lines_scale=p.lines_scale[lns],
            line_valid=p.line_valid[lns],
            p_cam=p.p_cam[po], p_lm=p.p_lm[po] - pts[0], p_uv=p.p_uv[po],
            p_sigma2=p.p_sigma2[po], p_valid=p.p_valid[po],
            l_cam=p.l_cam[lo], l_lm=p.l_lm[lo] - lns[0], l_sobs=p.l_sobs[lo],
            l_eobs=p.l_eobs[lo], l_sigma2=p.l_sigma2[lo], l_valid=p.l_valid[lo]))
    stacked = {k: np.stack([c[k] for c in chunks]) for k in chunks[0]}
    return p._replace(**stacked)


def test_chunked_gba():
    jp, *_ = make_problem(K=4, P=20, L=8, noise=0.3, pert=0.03)
    stacked = _two_chunks(jp)
    jres = jax.jit(jba.bundle_adjust_chunked, static_argnums=(2, 3))(
        jax.tree.map(jnp.asarray, stacked), JC, CFG, None)
    tres = ba.bundle_adjust_chunked(ba_problem_from_numpy(stacked, "cpu"), TC, TCFG)
    np.testing.assert_array_equal(to_np(tres.p_active), np.asarray(jres.p_active))
    for name in ("T_c_w", "points", "lines_orth"):
        np.testing.assert_allclose(to_np(getattr(tres.problem, name)),
                                   np.asarray(getattr(jres.problem, name)),
                                   rtol=0, atol=1e-7, err_msg=name)
    # against the port's unchunked solve (same fixed trips, same damping)
    whole = ba.bundle_adjust(_port(jp), TC, TCFG._replace(early_exit=False))
    np.testing.assert_allclose(to_np(tres.problem.T_c_w), to_np(whole.problem.T_c_w),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(to_np(tres.problem.points).reshape(-1, 3),
                               to_np(whole.problem.points), rtol=0, atol=1e-7)


def test_non_spd_step_rejected():
    jp, *_ = make_problem(K=3, P=10, L=4, noise=0.3, pert=0.03)
    tp = _port(jp)
    # negative damping makes the reduced camera system indefinite: the
    # first step is NaN and rejected on both sides
    cfg_j, cfg_t = CFG._replace(lambda_init=-2.0), TCFG._replace(lambda_init=-2.0)
    jr, jc = jax.jit(lambda p: jba.lm_rounds(p, JC, cfg_j, p.p_valid, p.l_valid, 1))(jp)
    tr, tc, _ = ba.lm_rounds(tp, TC, cfg_t, tp.p_valid, tp.l_valid, 1)
    np.testing.assert_array_equal(np.asarray(jr.T_c_w), np.asarray(jp.T_c_w))
    np.testing.assert_array_equal(to_np(tr.T_c_w), to_np(tp.T_c_w))
    np.testing.assert_allclose(float(tc), float(jc), rtol=1e-10)
    K = tp.T_c_w.shape[0]
    dpose = ba.solve_reduced(-torch.eye(6, dtype=torch.float64).expand(K, 6, 6),
                             torch.zeros((K, K, 6, 6), dtype=torch.float64),
                             torch.ones((K, 6), dtype=torch.float64),
                             torch.tensor(0.0, dtype=torch.float64), torch.ones(K, dtype=torch.bool))
    assert torch.isnan(dpose).all()


def test_solver_refuses_tf32():
    jp, *_ = make_problem(K=2, P=5, L=3)
    tp = _port(jp)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError):
            ba.lm_rounds(tp, TC, TCFG, tp.p_valid, tp.l_valid, 1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
