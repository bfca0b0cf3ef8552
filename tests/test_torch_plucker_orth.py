"""The orthonormal (U, W) half of plslam_tpu_torch.core.plucker and the
closed-form inverses of core.linalg against the JAX package, batched:
f64 to 1e-10, f32 to 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam_tpu.core import linalg as jlinalg
from plslam_tpu.core import plucker as jp
from plslam_tpu_torch.core import linalg, plucker

from test_torch_helpers import one_torch_thread, t, to_np  # noqa: F401

TOL = {np.float64: 1e-10, np.float32: 1e-5}


def _lines(dtype, n=64, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.uniform(-3, 3, (n, 3)) + np.array([0, 0, 6.0])
    B = A + rng.uniform(-1.5, 1.5, (n, 3))
    L = np.concatenate([np.cross(A, B), B - A], -1)
    return (L / np.linalg.norm(L, axis=-1, keepdims=True)).astype(dtype), A.astype(dtype), \
        B.astype(dtype)


def _close(got, want, dtype):
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", ["normalize_plucker", "orth_U_from_plucker",
                                  "orth_W_from_plucker", "plucker_to_orth",
                                  "jac_plucker_wrt_orth", "plucker_closest_point"])
def test_plucker_functions(name, dtype):
    L, _, _ = _lines(dtype)
    L = L * np.asarray(2.5, dtype)  # not unit: exercises the normalizations
    want = jax.vmap(getattr(jp, name))(jnp.asarray(L))
    _close(getattr(plucker, name)(t(L)), want, dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_euler_orth_round_trips(dtype):
    L, A, B = _lines(dtype)
    o = np.asarray(jax.vmap(jp.plucker_to_orth)(jnp.asarray(L)))
    _close(plucker._euler_R(t(o[:, :3])), jax.vmap(jp._euler_R)(jnp.asarray(o[:, :3])), dtype)
    R = np.asarray(jax.vmap(jp._euler_R)(jnp.asarray(o[:, :3])))
    _close(plucker._R_to_euler(t(R)), jax.vmap(jp._R_to_euler)(jnp.asarray(R)), dtype)
    _close(plucker.orth_to_plucker(t(o)), jax.vmap(jp.orth_to_plucker)(jnp.asarray(o)), dtype)
    _close(plucker.plucker_from_two_points(t(A), t(B)),
           jax.vmap(jp.plucker_from_two_points)(jnp.asarray(A), jnp.asarray(B)), dtype)
    # orth -> plucker -> orth reproduces the unit line
    _close(plucker.orth_to_plucker(plucker.plucker_to_orth(t(L))), L, dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_orth_plus_and_jacobian(dtype):
    L, _, _ = _lines(dtype)
    rng = np.random.default_rng(1)
    o = np.asarray(jax.vmap(jp.plucker_to_orth)(jnp.asarray(L)))
    d = (rng.normal(size=o.shape) * 0.05).astype(dtype)
    got = plucker.orth_plus(t(o), t(d))
    _close(got, jax.vmap(jp.orth_plus)(jnp.asarray(o), jnp.asarray(d)), dtype)
    # a zero step is the identity; a small step moves the line by J d
    zero = plucker.orth_plus(t(o), torch.zeros_like(t(d)))
    _close(plucker.orth_to_plucker(zero), L, dtype)
    small = d * np.asarray(1e-2, dtype)
    moved = to_np(plucker.orth_to_plucker(plucker.orth_plus(t(o), t(small))))
    first = L + np.einsum("nij,nj->ni", to_np(plucker.jac_plucker_wrt_orth(t(L))), small)
    np.testing.assert_allclose(moved, first, atol=1e-5)
    # the analytic Jacobian against finite differences of orth_plus
    if dtype == np.float64:
        J = to_np(plucker.jac_plucker_wrt_orth(t(L)))
        eps = 1e-6
        for k in range(4):
            e = np.zeros((len(o), 4))
            e[:, k] = eps
            fd = (to_np(plucker.orth_to_plucker(plucker.orth_plus(t(o), t(e))))
                  - to_np(plucker.orth_to_plucker(plucker.orth_plus(t(o), t(-e))))) / (2 * eps)
            np.testing.assert_allclose(J[:, :, k], fd, atol=1e-7)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_closed_form_inverses(dtype):
    rng = np.random.default_rng(2)
    for n, jf, tf in ((3, jlinalg.inv3x3, linalg.inv3x3), (4, jlinalg.inv4x4, linalg.inv4x4)):
        X = rng.normal(size=(50, n, n))
        A = (X @ X.transpose(0, 2, 1) + n * np.eye(n)).astype(dtype)
        got, want = to_np(tf(t(A))), np.asarray(jf(jnp.asarray(A)))
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype] * 10)
        np.testing.assert_allclose(A.astype(np.float64) @ got, np.broadcast_to(np.eye(n), A.shape),
                                   atol=TOL[dtype] * 100)


def test_solve_spd_flags_non_spd():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(12, 12))
    A = X @ X.T + np.eye(12)
    b = rng.normal(size=12)
    x = to_np(linalg.solve_spd(t(A), t(b)))
    np.testing.assert_allclose(A @ x, b, atol=1e-10)
    A[3, 3] = -5.0
    assert np.isnan(to_np(linalg.solve_spd(t(A), t(b)))).all()
