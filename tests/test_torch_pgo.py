"""plslam_tpu_torch.backend.pgo against plslam_tpu.backend.pgo in float64
(``tests/conftest.py`` turns on jax x64) on the square loop of
tests/test_pgo_vocab.py: the closed-form edge Jacobians against JAX's
``jacfwd``, the
assembled system and cost within 1e-9, ``optimize`` poses within 1e-9 with
the gauge untouched, and the rigid landmark corrections."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam_tpu.backend import pgo as jpgo
from plslam_tpu.core import lie as jlie
from plslam_tpu_torch.backend import pgo as tpgo

from test_torch_helpers import one_torch_thread  # noqa: F401

TOL = 1e-9


def make_loop(n=12, noise=0.03, seed=21):
    """Noisy square-loop odometry chained into drifting poses, with the
    loop edge T_{K-1}^-1 T_0 = I; numpy float64 fields."""
    rng = np.random.default_rng(seed)
    xis = []
    for _ in range(4):
        for s in range(n // 4):
            xi = np.zeros(6)
            xi[0] = 1.0
            if s == n // 4 - 1:
                xi[5] = np.pi / 2
            xis.append(xi)
    noisy = np.asarray(xis) + rng.normal(size=(n, 6)) * noise
    steps = np.asarray(jax.vmap(jlie.exp_se3)(jnp.asarray(noisy)))
    poses = [np.eye(4)]
    for S in steps:
        poses.append(poses[-1] @ S)
    K = n + 1
    return dict(T_w_k=np.stack(poses), fixed=np.arange(K) == 0, valid=np.ones(K, bool),
                e_i=np.asarray(list(range(K - 1)) + [K - 1]),
                e_j=np.asarray(list(range(1, K)) + [0]),
                e_T=np.concatenate([steps, np.eye(4)[None]]),
                e_info=np.ones(K), e_valid=np.ones(K, bool))


def _graphs(d):
    jg = jpgo.PoseGraph(**{k: jnp.asarray(v.astype(np.int32) if k in ("e_i", "e_j") else v)
                           for k, v in d.items()})
    tg = tpgo.PoseGraph(**{k: torch.from_numpy(np.asarray(v)) for k, v in d.items()})
    return jg, tg


@pytest.fixture(scope="module")
def loop():
    return make_loop()


@pytest.mark.parametrize("scale", [1e-5, 3e-3, 1.2e-2, 0.2])
def test_edge_jacobians(loop, scale):
    """The closed-form Jacobians against JAX's jacfwd, with the poses moved
    off the measurements so that the residual rotations straddle the
    Taylor switch of the coefficients (1e-2 rad)."""
    rng = np.random.default_rng(3)
    moves = np.asarray(jax.vmap(jlie.exp_se3)(jnp.asarray(rng.normal(size=(13, 6)) * scale)))
    T = loop["T_w_k"] @ moves
    Ti, Tj, Z = T[loop["e_i"]], T[loop["e_j"]], loop["e_T"]
    e, Ji, Jj = jax.vmap(jpgo._edge_res_and_jac)(jnp.asarray(Ti), jnp.asarray(Tj),
                                                  jnp.asarray(Z))
    te, tJi, tJj = tpgo.edge_res_and_jac(*map(torch.from_numpy, (Ti, Tj, Z)))
    assert te.dtype == torch.float64
    assert np.abs(np.asarray(e)).max() > scale
    np.testing.assert_allclose(te.numpy(), np.asarray(e), rtol=0, atol=TOL)
    np.testing.assert_allclose(tJi.numpy(), np.asarray(Ji), rtol=0, atol=TOL)
    np.testing.assert_allclose(tJj.numpy(), np.asarray(Jj), rtol=0, atol=TOL)


def test_build_system(loop):
    jg, tg = _graphs(loop)
    H, b, c = jpgo.build_system(jg)
    tH, tb, tc = tpgo.build_system(tg)
    np.testing.assert_allclose(tH.numpy(), np.asarray(H), rtol=0, atol=TOL)
    np.testing.assert_allclose(tb.numpy(), np.asarray(b), rtol=0, atol=TOL)
    np.testing.assert_allclose(float(tc), float(c), rtol=0, atol=TOL)
    assert float(tc) > 1e-3


@pytest.mark.parametrize("iters", [1, 15])
def test_optimize(loop, iters):
    jg, tg = _graphs(loop)
    j2 = jax.jit(jpgo.optimize, static_argnums=1)(jg, iters)
    t2 = tpgo.optimize(tg, iters)
    np.testing.assert_allclose(t2.T_w_k.numpy(), np.asarray(j2.T_w_k), rtol=0, atol=TOL)
    np.testing.assert_array_equal(t2.T_w_k[0].numpy(), loop["T_w_k"][0])
    if iters == 15:
        drift = np.linalg.norm(t2.T_w_k[-1, :3, 3].numpy() - t2.T_w_k[0, :3, 3].numpy())
        assert drift < 0.02
        assert float(tpgo.build_system(t2)[2]) < float(tpgo.build_system(tg)[2])


def test_non_finite_step_is_zero(loop):
    """A NaN information weight makes the solve non-finite: the step is
    zero and the poses stay, on both sides."""
    d = dict(loop, e_info=np.where(np.arange(len(loop["e_info"])) == 2, np.nan, 1.0))
    jg, tg = _graphs(d)
    t2 = tpgo.optimize(tg, 2)
    np.testing.assert_array_equal(t2.T_w_k.numpy(), d["T_w_k"])
    np.testing.assert_array_equal(np.asarray(jpgo.optimize(jg, 2).T_w_k), d["T_w_k"])


def test_landmark_corrections(loop):
    jg, tg = _graphs(loop)
    T_new = tpgo.optimize(tg, 10).T_w_k
    rng = np.random.default_rng(8)
    pts = rng.normal(size=(30, 3)) + np.array([0.0, 0.0, 5.0])
    L = rng.normal(size=(20, 6))
    owner = rng.integers(0, len(loop["T_w_k"]), 30)
    T_old = loop["T_w_k"]
    a = np.asarray(jpgo.correct_landmarks(jnp.asarray(T_old), jnp.asarray(T_new.numpy()),
                                          jnp.asarray(owner, jnp.int32), jnp.asarray(pts)))
    b = tpgo.correct_landmarks(torch.from_numpy(T_old), T_new, torch.from_numpy(owner),
                               torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(b, a, rtol=0, atol=TOL)
    # each point stays fixed in its owner's frame
    To, Tn = np.linalg.inv(T_old)[owner], np.linalg.inv(T_new.numpy())[owner]
    np.testing.assert_allclose(np.einsum("nij,nj->ni", Tn[:, :3, :3], b) + Tn[:, :3, 3],
                               np.einsum("nij,nj->ni", To[:, :3, :3], pts) + To[:, :3, 3],
                               rtol=0, atol=TOL)
    a = np.asarray(jpgo.correct_plucker_landmarks(
        jnp.asarray(T_old), jnp.asarray(T_new.numpy()), jnp.asarray(owner[:20], jnp.int32),
        jnp.asarray(L)))
    b = tpgo.correct_plucker_landmarks(torch.from_numpy(T_old), T_new,
                                       torch.from_numpy(owner[:20]), torch.from_numpy(L))
    np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=TOL)
