"""plslam_tpu_torch.core against plslam_tpu.core: lie, camera, plucker and
robust on shared float32 inputs, to 1e-5 (float32 rounding)."""

import jax
import numpy as np
import pytest

from plslam_tpu.core import lie as jlie
from plslam_tpu.core import plucker as jpl
from plslam_tpu.core import robust as jrob
from plslam_tpu_torch import convert
from plslam_tpu_torch.core import lie, plucker, robust

from test_torch_helpers import cams, t, to_np

TOL = dict(rtol=1e-5, atol=1e-5)


def _twists(n=64, seed=0):
    rng = np.random.default_rng(seed)
    xi = np.concatenate([rng.normal(0, 0.5, (n, 3)), rng.normal(0, 0.6, (n, 3))], 1)
    xi[:4, 3:] = [[0, 0, 0], [1e-6, 0, 0], [0, 3e-5, 0], [0, 0, 3.1]]
    return xi.astype(np.float32)


@pytest.mark.parametrize("name", ["exp_se3", "log_se3", "inv_se3", "adjoint_se3",
                                  "se3_chordal_project"])
def test_lie_maps(name):
    xi = _twists()
    T = np.asarray(jlie.exp_se3(xi))
    arg = xi if name == "exp_se3" else T
    # the JAX log map takes one matrix at a time (jnp.trace)
    want = np.asarray(jax.vmap(getattr(jlie, name))(arg))
    got = to_np(getattr(lie, name)(t(arg)))
    np.testing.assert_allclose(got, want, **TOL)


def test_lie_covariances_and_points():
    rng = np.random.default_rng(1)
    T = np.asarray(jlie.exp_se3(_twists(8, seed=2)))
    A = rng.normal(size=(8, 6, 6)).astype(np.float32) * 0.1
    cov = (A @ A.transpose(0, 2, 1)).astype(np.float32)
    P = rng.uniform(-5, 5, (8, 3)).astype(np.float32)
    np.testing.assert_allclose(to_np(lie.cov_Tinv(t(T), t(cov))),
                               np.asarray(jlie.cov_Tinv(T, cov)), **TOL)
    np.testing.assert_allclose(to_np(lie.cov_compose(t(T), t(cov), t(cov[::-1].copy()))),
                               np.asarray(jlie.cov_compose(T, cov, cov[::-1].copy())),
                               **TOL)
    np.testing.assert_allclose(to_np(lie.transform_point(t(T), t(P))),
                               np.asarray(jlie.transform_point(T, P)), **TOL)


def test_camera():
    jc, tc = cams()
    rng = np.random.default_rng(3)
    P = np.stack([rng.uniform(-3, 3, 50), rng.uniform(-2, 2, 50),
                  rng.uniform(1, 12, 50)], -1).astype(np.float32)
    uv = rng.uniform(0, 700, (50, 2)).astype(np.float32)
    disp = rng.uniform(1, 60, 50).astype(np.float32)
    np.testing.assert_allclose(to_np(tc.project(t(P))), np.asarray(jc.project(P)), **TOL)
    np.testing.assert_allclose(to_np(tc.back_project(t(uv), t(disp))),
                               np.asarray(jc.back_project(uv, disp)), **TOL)
    np.testing.assert_allclose(to_np(tc.back_project_unit(t(uv))),
                               np.asarray(jc.back_project_unit(uv)), **TOL)
    np.testing.assert_array_equal(np.asarray(tc.plucker_K, np.float32),
                                  np.asarray(jc.plucker_K))
    assert convert.camera_from_numpy(to_np(jc)._asdict()) == tc


def test_plucker():
    rng = np.random.default_rng(4)
    x1, x2, x3 = (rng.uniform(-4, 4, (40, 3)).astype(np.float32) for _ in range(3))
    pi1 = np.asarray(jpl.plane_from_points(x1, x2, x3))
    pi2 = np.asarray(jpl.plane_from_points(x2, x3, x1))
    np.testing.assert_allclose(
        to_np(plucker.plane_from_points(t(x1), t(x2), t(x3))), pi1, rtol=1e-5, atol=1e-4)
    L = np.asarray(jpl.plucker_from_planes(pi1, pi2))
    np.testing.assert_allclose(to_np(plucker.plucker_from_planes(t(pi1), t(pi2))), L,
                               rtol=1e-5, atol=1e-3)  # |L| ~ 1e3: f32 ulp of the products
    T = np.asarray(jlie.exp_se3(_twists(40, seed=5)))
    np.testing.assert_allclose(to_np(plucker.plucker_motion_matrix(t(T))),
                               np.asarray(jpl.plucker_motion_matrix(T)), **TOL)
    Ln = (L / np.linalg.norm(L, axis=-1, keepdims=True)).astype(np.float32)
    np.testing.assert_allclose(to_np(plucker.transform_plucker(t(T), t(Ln))),
                               np.asarray(jpl.transform_plucker(T, Ln)), **TOL)


@pytest.mark.parametrize("n_valid", [0, 1, 7, 60])
def test_robust(n_valid):
    rng = np.random.default_rng(n_valid)
    x = np.abs(rng.standard_cauchy(64)).astype(np.float32)
    m = np.zeros(64, bool)
    m[rng.permutation(64)[:n_valid]] = True
    np.testing.assert_array_equal(to_np(robust.masked_median_upper(t(x), t(m))),
                                  np.asarray(jrob.masked_median_upper(x, m)))
    np.testing.assert_allclose(to_np(robust.mad_stdv(t(x), t(m))),
                               np.asarray(jrob.mad_stdv(x, m)), **TOL)
    for g, w in zip(robust.mean_stdv_mad(t(x), t(m)), jrob.mean_stdv_mad(x, m)):
        np.testing.assert_allclose(to_np(g), np.asarray(w), **TOL)
    np.testing.assert_allclose(to_np(robust.cauchy_weight(t(x))),
                               np.asarray(jrob.cauchy_weight(x)), **TOL)
    np.testing.assert_allclose(to_np(robust.clipped_mad_scale(t(x), t(m))),
                               np.asarray(jrob.clipped_mad_scale(x, m)), **TOL)
    y = np.abs(rng.normal(size=40)).astype(np.float32)
    my = rng.uniform(size=40) > 0.3
    got = robust.clipped_mad_scale_pair(t(x), t(m), t(y), t(my))
    want = jrob.clipped_mad_scale_pair(x, m, y, my)
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_np(g), np.asarray(w), **TOL)
