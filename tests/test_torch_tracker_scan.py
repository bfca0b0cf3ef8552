"""The GN scan form (``TrackerConfig(early_exit=False)``) against the JAX
package's ``lax.scan`` form, on seeded numpy inputs:

- ``gauss_newton`` and ``optimize_pose``: ``good`` and ``n_inliers``
  equal, DT within 1e-6;
- a case built so that the scan's ``good`` and the while form's differ
  (the step that meets the stopping rule moves every line off its
  observed segment, so the next trip's system is empty): both packages'
  forms differ the same way;
- ``early_exit=True`` bit for bit the frozen-carry loop it was before
  the scan form existed;
- a 3-frame ``VisualOdometry`` with the scan form against the JAX one;
- ``euroc_default_camera`` field for field."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from plslam_tpu import vo as jvo_mod
from plslam_tpu.core.camera import StereoCamera as JCam
from plslam_tpu.core.camera import euroc_default_camera as jax_euroc_camera
from plslam_tpu.frontend import tracker as jtr
from plslam_tpu.frontend.frame import FrontendConfig as JFcfg
from plslam_tpu.io.synthetic import SyntheticScene, circular_trajectory
from plslam_tpu.io.trajectory import ate_rmse
from plslam_tpu_torch import core, vo
from plslam_tpu_torch.core import lie
from plslam_tpu_torch.core.camera import StereoCamera
from plslam_tpu_torch.frontend import features, tracker
from plslam_tpu_torch.frontend.frame import FrontendConfig

from test_torch_helpers import cams, one_torch_thread, t, to_np  # noqa: F401

DT_TOL = 1e-6


def _inputs(seed, noise=0.5, outliers=0.1, n_pts=256, n_ls=64):
    """The graft entry's tracking inputs with seeded pixel noise and
    outliers (as tests/test_torch_tracker.py builds them)."""
    _, pts, ls = to_np(graft._synthetic_tracking_inputs(n_pts=n_pts, n_ls=n_ls))
    rng = np.random.default_rng(seed)
    obs = pts.obs + rng.normal(0, noise, pts.obs.shape)
    bad = rng.uniform(size=len(obs)) < outliers
    obs[bad] += rng.uniform(20, 40, (bad.sum(), 2))
    sobs = ls.sobs + rng.normal(0, noise, ls.sobs.shape)
    eobs = ls.eobs + rng.normal(0, noise, ls.eobs.shape)
    lbad = rng.uniform(size=len(sobs)) < outliers
    sobs[lbad] += 25.0
    h = lambda a: np.concatenate([a, np.ones((len(a), 1))], -1)
    le = np.cross(h(sobs), h(eobs))
    le /= np.linalg.norm(le[:, :2], axis=-1, keepdims=True)
    return (pts._replace(obs=obs.astype(np.float32)),
            ls._replace(sobs=sobs.astype(np.float32), eobs=eobs.astype(np.float32),
                        le_obs=le.astype(np.float32)))


def _port(pts, ls):
    return (features.TrackedPoints(*(t(x) for x in pts)),
            features.TrackedLines(*(t(x) for x in ls)))


def _gn_both(pts, ls, max_iters, **cfg):
    jcam, tcam = cams()
    DT0 = np.eye(4, dtype=np.float32)
    jcfg = jtr.TrackerConfig(**cfg)
    want = jax.jit(lambda p, l: jtr.gauss_newton(jnp.asarray(DT0), p, l, jcam, jcfg,
                                                 max_iters))(pts, ls)
    got = tracker.gauss_newton(t(DT0), *_port(pts, ls), tcam, tracker.TrackerConfig(**cfg),
                               max_iters)
    return want, to_np(got)


@pytest.mark.parametrize("plucker_lines", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gauss_newton_scan_form(seed, plucker_lines):
    pts, ls = _inputs(seed)
    for max_iters in (5, 10):
        want, got = _gn_both(pts, ls, max_iters, early_exit=False, plucker_lines=plucker_lines)
        assert bool(got.good) == bool(want.good)
        np.testing.assert_allclose(got.DT, np.asarray(want.DT), rtol=0, atol=DT_TOL)


@pytest.mark.parametrize("plucker_lines", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_optimize_pose_scan_form(seed, plucker_lines):
    pts, ls = _inputs(seed)
    jcam, tcam = cams()
    kw = dict(early_exit=False, plucker_lines=plucker_lines)
    want, wpts, wls = jax.jit(lambda p, l: jtr.optimize_pose(p, l, jcam, jtr.TrackerConfig(**kw))
                              )(pts, ls)
    got, gpts, gls = tracker.optimize_pose(*_port(pts, ls), tcam, tracker.TrackerConfig(**kw))
    assert bool(want.good) and bool(got.good)
    assert int(got.n_inliers) == int(want.n_inliers)
    np.testing.assert_allclose(to_np(got.DT), np.asarray(want.DT), rtol=0, atol=DT_TOL)
    np.testing.assert_array_equal(to_np(gpts.inlier), np.asarray(wpts.inlier))
    np.testing.assert_array_equal(to_np(gls.inlier), np.asarray(wls.inlier))


def _forms_differ_case():
    """Lines only; each line's overlap segment (sp, ep and its 3D ends sP,
    eP) is 1e-4 of the line at its start, so any pose step moves every
    projection off it and every line's weight to 0.  The first GN step is
    below ``min_error_change`` (0.5), which ends the while form with
    ``good``; the scan's next trip meets H = 0 (no Cholesky) and err = 0
    (``min_error`` 0: no stop), so its ``good`` turns False."""
    jcam, _ = cams()
    _, pts, ls = to_np(graft._synthetic_tracking_inputs(n_pts=64, n_ls=16))
    eP = (ls.sP + 1e-4 * (ls.eP - ls.sP)).astype(np.float32)
    sp = np.asarray(jcam.project(jnp.asarray(ls.sP)), np.float32)
    ep = np.asarray(jcam.project(jnp.asarray(eP)), np.float32)
    return pts, ls._replace(eP=eP, sp=sp, ep=ep), dict(use_points=False, min_error=0.0,
                                                       min_error_change=0.5)


def test_scan_and_while_forms_differ_alike():
    pts, ls, cfg = _forms_differ_case()
    runs = {ee: _gn_both(pts, ls, 5, early_exit=ee, **cfg) for ee in (True, False)}
    for ee, (want, got) in runs.items():
        assert bool(got.good) == bool(want.good)
        np.testing.assert_allclose(got.DT, np.asarray(want.DT), rtol=0, atol=DT_TOL)
        assert float(got.err) == float(want.err)
    # each package: the while form ends good, the scan form does not, at
    # the same pose
    for side in (0, 1):
        w, s = runs[True][side], runs[False][side]
        assert bool(w.good) and not bool(s.good)
        np.testing.assert_array_equal(np.asarray(w.DT), np.asarray(s.DT))
        assert float(s.err) == -1.0


def _frozen_carry_gn(DT0, pts, ls, cam, cfg, max_iters):
    """The port's ``gauss_newton`` as it was before ``early_exit`` existed
    (every trip's carry frozen once done), to hold the default bit for bit."""
    dtype, dev = DT0.dtype, DT0.device
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    DT = DT0
    err_prev = torch.full((), 9.9e8, dtype=dtype, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    good = torch.ones((), dtype=torch.bool, device=dev)
    done_in = []
    for _ in range(max_iters):
        done_in.append(done)
        H, g, err = tracker.build_normal_equations(DT, pts, ls, cam, cfg)
        stop = (torch.abs(err - err_prev) < cfg.min_error_change) | (err < cfg.min_error)
        L, chol_ok = tracker._cholesky(H)
        delta = torch.cholesky_solve(g[:, None], L)[:, 0]
        ok = chol_ok & torch.isfinite(delta).all()
        halt = done | stop | ~ok
        step = torch.where(halt, 0.0, delta)
        small = torch.linalg.norm(step) < cfg.min_error_change
        DT = torch.where(done, DT, lie.exp_se3(-step) @ DT)
        good = torch.where(done, good, good & (ok | stop))
        err_prev = torch.where(done, err_prev, err)
        done = halt | small
    H, _, err_final = tracker.build_normal_equations(DT, pts, ls, cam, cfg)
    cov = torch.where(good, tracker._solve_spd(H, eye6), eye6)
    return tracker.GNResult(DT=DT, cov=cov, err=torch.where(good, err_final, -1.0), good=good,
                            done_in=tuple(done_in))


@pytest.mark.parametrize("case", ["noisy", "forms_differ"])
def test_early_exit_is_the_frozen_carry_bit_for_bit(case):
    if case == "noisy":
        pts, ls = _inputs(0)
        cfg = tracker.TrackerConfig()
    else:
        pts, ls, kw = _forms_differ_case()
        cfg = tracker.TrackerConfig(**kw)
    assert cfg.early_exit
    _, tcam = cams()
    tp, tl = _port(pts, ls)
    DT0 = torch.eye(4)
    for max_iters in (5, 10):
        got = tracker.gauss_newton(DT0, tp, tl, tcam, cfg, max_iters)
        want = _frozen_carry_gn(DT0, tp, tl, tcam, cfg, max_iters)
        for a, b in zip(got[:4] + got.done_in, want[:4] + want.done_in):
            assert torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def test_three_frame_vo_scan_form_against_jax():
    """initialize + 2 tracked frames at test_vo_e2e's 376x240
    configuration, the scan form on both sides: every frame good on both,
    equal inlier counts, the port's ATE within max(2x JAX's, 0.01 m) (the
    bar of tests/test_torch_vo.py's run: each side detects its own
    features, which round apart by 1e-4 m here in both forms); and the
    port's scan form gives its while form's poses bit for bit."""
    scene = SyntheticScene(seed=3)
    poses = circular_trajectory(3)
    frames = [scene.render_stereo(T) for T in poses]
    jcam = JCam.create(scene.fx, scene.fy, scene.cx, scene.cy, scene.b, width=scene.width,
                       height=scene.height, dtype=jnp.float32)
    jv = jvo_mod.VisualOdometry(jcam, JFcfg(n_points=512, n_lines=128, fast_th=15.0),
                                jtr.TrackerConfig(early_exit=False))
    jv.initialize(*(jnp.asarray(x) for x in frames[0]))
    want = [jv.process(*(jnp.asarray(x) for x in f)) for f in frames[1:]]
    tcam = StereoCamera.create(scene.fx, scene.fy, scene.cx, scene.cy, scene.b,
                               width=scene.width, height=scene.height)
    got = {}
    for ee in (False, True):
        pv = vo.VisualOdometry(tcam, FrontendConfig(n_points=512, n_lines=128, fast_th=15.0),
                               tracker.TrackerConfig(early_exit=ee), device="cpu")
        pv.initialize(*(torch.from_numpy(x) for x in frames[0]))
        got[ee] = [pv.process(*(torch.from_numpy(x) for x in f)) for f in frames[1:]]
    for w, g in zip(want, got[False]):
        assert bool(w.good) and bool(g.good)
        assert int(g.n_inliers) == int(w.n_inliers)
    gt = np.stack([T[:3, 3] for T in poses])
    ate_j = ate_rmse(np.stack([np.zeros(3)] + [np.asarray(r.T_f_w)[:3, 3] for r in want]), gt,
                     align=False)
    ate_t = ate_rmse(np.stack([np.zeros(3)] + [to_np(r.T_f_w)[:3, 3] for r in got[False]]), gt,
                     align=False)
    assert ate_t <= max(2.0 * ate_j, 0.01), (ate_t, ate_j)
    for s, w in zip(got[False], got[True]):
        assert torch.equal(s.T_f_w, w.T_f_w) and bool(s.good) == bool(w.good)


def test_euroc_default_camera_matches_jax():
    want = jax_euroc_camera(jnp.float32)
    got = core.euroc_default_camera()
    for name in got._fields:
        assert float(getattr(got, name)) == float(np.asarray(getattr(want, name))), name


# ---------------------------------------------------------------------------
# GN trips used against unrolled


def _host_trips(DT, pts, ls, cam, cfg, max_iters):
    """The trips a GN solve uses, from a plain Python loop whose stopping
    rules are decided on the host: a trip is used when it starts before
    the loop is done.  Done never clears, so the while form stops there
    and the scan form's later trips (a zero step) are not used either."""
    err_prev = torch.full((), 9.9e8, dtype=DT.dtype)
    done, used = False, 0
    for _ in range(max_iters):
        if done:
            break
        used += 1
        H, g, err = tracker.build_normal_equations(DT, pts, ls, cam, cfg)
        stop = bool((torch.abs(err - err_prev) < cfg.min_error_change) | (err < cfg.min_error))
        L, chol_ok = tracker._cholesky(H)
        delta = torch.cholesky_solve(g[:, None], L)[:, 0]
        if stop or not (bool(chol_ok) and bool(torch.isfinite(delta).all())):
            done = True
            continue
        DT = lie.exp_se3(-delta) @ DT
        err_prev = err
        done = bool(torch.linalg.norm(delta) < cfg.min_error_change)
    return used


@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("case", ["noisy", "forms_differ"])
def test_gn_trips_used_equal_a_host_loop(case, early_exit):
    """``PoseEstimate.done_in`` holds the 5 + 10 trips unrolled; the used
    ones (``trips_used``) equal the host loop's count over the inputs
    ``optimize_pose`` handed each of its two solves, at least one a solve;
    each solve's ``done_in`` agrees."""
    if case == "noisy":
        pts, ls = _inputs(0)
        kw = {}
    else:
        pts, ls, kw = _forms_differ_case()
    cfg = tracker.TrackerConfig(early_exit=early_exit, **kw)
    _, tcam = cams()
    calls, real = [], tracker.gauss_newton

    def spy(DT0, p, l, cam, c, max_iters):
        res = real(DT0, p, l, cam, c, max_iters)
        calls.append(((DT0, p, l, cam, c, max_iters), res))
        return res

    tracker.gauss_newton = spy
    try:
        est, _, _ = tracker.optimize_pose(*_port(pts, ls), tcam, cfg)
    finally:
        tracker.gauss_newton = real
    assert [c[0][-1] for c in calls] == [cfg.max_iters, cfg.max_iters_ref] == [5, 10]
    want = []
    for args, res in calls:
        n = _host_trips(*args)
        assert n >= 1
        assert sum(not bool(d) for d in res.done_in) == n and len(res.done_in) == args[-1]
        want.append(n)
    assert est.done_in == calls[0][1].done_in + calls[1][1].done_in and len(est.done_in) == 15
    used = tracker.trips_used(est.done_in)
    assert used.dtype == torch.float32 and float(used) == sum(want)
