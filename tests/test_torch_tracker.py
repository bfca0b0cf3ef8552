"""Robust GN pose solve: plslam_tpu_torch.frontend.tracker.optimize_pose
against plslam_tpu's on the numpy form of the graft entry's synthetic
tracking inputs: DT to 1e-5, ``good`` equal, cov to 1e-3 relative (of its
largest entry; the 6x6 Gram sums in another order)."""

import jax
import numpy as np
import pytest

import __graft_entry__ as graft
from plslam_tpu.frontend import tracker as jtr
from plslam_tpu_torch.frontend import features, tracker

from test_torch_helpers import cams, t, to_np


def _inputs(noise=0.0, outliers=0.0, n_valid=None, seed=0):
    _, pts, ls = to_np(graft._synthetic_tracking_inputs())
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
    pts = pts._replace(obs=obs.astype(np.float32))
    ls = ls._replace(sobs=sobs.astype(np.float32), eobs=eobs.astype(np.float32),
                     le_obs=le.astype(np.float32))
    if n_valid is not None:
        pts = pts._replace(valid=np.arange(len(obs)) < n_valid)
        ls = ls._replace(valid=np.zeros(len(sobs), bool))
    return pts, ls


def _run(pts, ls, **cfg):
    jcam, tcam = cams()
    jcfg = jtr.TrackerConfig(**cfg)
    want, wpts, wls = jax.jit(lambda p, l: jtr.optimize_pose(p, l, jcam, jcfg))(pts, ls)
    tp = features.TrackedPoints(*(t(x) for x in pts))
    tl = features.TrackedLines(*(t(x) for x in ls))
    got, gpts, gls = tracker.optimize_pose(tp, tl, tcam, tracker.TrackerConfig(**cfg))
    return want, to_np(got), (wpts, wls), (to_np(gpts), to_np(gls))


def _check(want, got, cov_and_err=True):
    assert bool(got.good) == bool(want.good)
    np.testing.assert_allclose(got.DT, np.asarray(want.DT), rtol=0, atol=1e-5)
    assert int(got.n_inliers) == int(want.n_inliers)
    if not cov_and_err:
        return
    cov = np.asarray(want.cov)
    np.testing.assert_allclose(got.cov, cov, rtol=1e-3,
                               atol=1e-3 * max(np.abs(cov).max(), 1e-30))
    np.testing.assert_allclose(got.err, np.asarray(want.err), rtol=1e-3, atol=1e-7)


@pytest.mark.parametrize("plucker_lines", [True, False])
def test_optimize_pose_noiseless(plucker_lines):
    """Noiseless residuals sit at f32 rounding level, below the 1e-4 floor
    of the MAD scale, so the Cauchy weights (and with them cov and err)
    follow the rounding of each side; the pose does not."""
    want, got, _, _ = _run(*_inputs(), plucker_lines=plucker_lines)
    assert bool(want.good)
    _check(want, got, cov_and_err=False)


@pytest.mark.parametrize("plucker_lines", [True, False])
def test_optimize_pose_noise_and_outliers(plucker_lines):
    want, got, (wpts, wls), (gpts, gls) = _run(*_inputs(noise=0.5, outliers=0.1),
                                               plucker_lines=plucker_lines)
    assert bool(want.good)
    _check(want, got)
    np.testing.assert_array_equal(gpts.inlier, np.asarray(wpts.inlier))
    np.testing.assert_array_equal(gls.inlier, np.asarray(wls.inlier))


def test_optimize_pose_too_few_features():
    want, got, _, _ = _run(*_inputs(n_valid=6))
    assert not bool(want.good)
    _check(want, got)
