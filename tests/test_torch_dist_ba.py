"""plslam_tpu_torch.parallel.dist_ba in 8 gloo rank processes against
plslam_tpu.parallel.dist_ba on the conftest's 8-device CPU mesh, in
float64, on tests/test_dist_ba.py's problems (make_sharded_problem: 4
poses, 64 points, 16 lines, every pose sees every landmark, observations
grouped by landmark shard), built here with intrinsics whose products are
exact in float32 (the port's camera rounds its constants to f32):

- port against JAX, the same fixed LM trips: poses within 1e-6, cost
  within 1e-6 relative;
- port against the port's single-device ``lm_rounds`` with no early exit:
  poses within 1e-6, and both near the truth;
- the cost falls below 0.1 x its start (test_dist_ba.py's bar);
- every rank ends with the same poses and cost, bit for bit."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam_tpu.backend import ba as jba
from plslam_tpu.core import lie as jlie
from plslam_tpu.core.camera import StereoCamera as JCam
from plslam_tpu.core.plucker import plucker_from_two_points, plucker_to_orth
from plslam_tpu.parallel import dist_ba as jdist
from plslam_tpu.parallel.mesh import make_mesh as jmesh
from plslam_tpu_torch.backend import ba
from plslam_tpu_torch.convert import ba_problem_from_numpy
from plslam_tpu_torch.core.camera import StereoCamera
from plslam_tpu_torch.parallel.launch import launch

from test_torch_helpers import one_torch_thread  # noqa: F401

N_DEV = 8
INTR = (435.25, 435.25, 367.5, 252.25, 0.110074)
PROBLEMS = {"a.": dict(pert=0.02, seed=42, iters=10), "b.": dict(pert=0.05, seed=7, iters=8)}
TESTS = os.path.dirname(os.path.abspath(__file__))


def make_sharded_problem(K=4, P_shard=8, L_shard=2, pert=0.02, seed=42):
    """tests/test_dist_ba.make_sharded_problem at INTR, as numpy float64:
    (fields with global landmark indices, the shard-local p_lm and l_lm,
    true poses)."""
    fx, fy, cx, cy, _ = INTR
    rng = np.random.default_rng(seed)
    P, L = P_shard * N_DEV, L_shard * N_DEV
    poses_xi = np.concatenate(
        [rng.uniform(-0.5, 0.5, (K, 2)), rng.uniform(-0.1, 0.1, (K, 1)),
         rng.uniform(-0.05, 0.05, (K, 3))], axis=1)
    T_c_w = np.linalg.inv(np.asarray(jax.vmap(jlie.exp_se3)(jnp.asarray(poses_xi))))
    Pw = np.stack([rng.uniform(-3, 3, P), rng.uniform(-2, 2, P), rng.uniform(4, 10, P)], -1)
    LA = np.stack([rng.uniform(-3, 3, L), rng.uniform(-2, 2, L), rng.uniform(4, 10, L)], -1)
    LB = LA + np.stack([rng.uniform(-1.5, 1.5, L), rng.uniform(-1.5, 1.5, L),
                        rng.uniform(-0.5, 0.5, L)], -1)

    def proj(cams, X):
        Xc = np.einsum("nij,nj->ni", T_c_w[cams, :3, :3], X) + T_c_w[cams, :3, 3]
        return np.stack([cx + fx * Xc[:, 0] / Xc[:, 2], cy + fy * Xc[:, 1] / Xc[:, 2]], -1)

    p_cam = np.tile(np.arange(K), P)
    p_lm = np.repeat(np.arange(P), K)
    l_cam = np.tile(np.arange(K), L)
    l_lm = np.repeat(np.arange(L), K)
    Lw = np.asarray(plucker_from_two_points(jnp.asarray(LA), jnp.asarray(LB)))
    scale = np.linalg.norm(Lw, axis=-1)
    orth = np.asarray(plucker_to_orth(jnp.asarray(Lw / scale[:, None])))
    pert_xi = rng.normal(size=(K, 6)) * pert
    pert_xi[0] = 0
    T_init = np.asarray(jax.vmap(lambda d, T: jlie.exp_se3(d) @ T)(
        jnp.asarray(pert_xi), jnp.asarray(T_c_w)))
    fields = dict(
        T_c_w=T_init, pose_fixed=np.arange(K) == 0, pose_valid=np.ones(K, bool),
        points=Pw + rng.normal(size=Pw.shape) * pert, point_valid=np.ones(P, bool),
        lines_orth=orth + rng.normal(size=orth.shape) * pert * 0.5, lines_scale=scale,
        line_valid=np.ones(L, bool), p_cam=p_cam, p_lm=p_lm, p_uv=proj(p_cam, Pw[p_lm]),
        p_sigma2=np.ones(K * P), p_valid=np.ones(K * P, bool), l_cam=l_cam, l_lm=l_lm,
        l_sobs=proj(l_cam, LA[l_lm]), l_eobs=proj(l_cam, LB[l_lm]), l_sigma2=np.ones(K * L),
        l_valid=np.ones(K * L, bool))
    local = dict(p_lm=p_lm % P_shard, l_lm=l_lm % L_shard)
    return fields, local, T_c_w


@pytest.fixture(scope="module")
def problems():
    return {name: make_sharded_problem(pert=kw["pert"], seed=kw["seed"])
            for name, kw in PROBLEMS.items()}


@pytest.fixture(scope="module")
def port_runs(problems):
    """Every rank's outputs of one 8-rank launch over both problems."""
    inputs = {"problems": list(PROBLEMS), "intrinsics": list(INTR)}
    for name, (fields, local, _) in problems.items():
        inputs[name + "iters"] = PROBLEMS[name]["iters"]
        inputs.update({name + k: np.asarray(v) for k, v in dict(fields, **local).items()})
    return launch("torch_dist_ranks:run_dist_ba", N_DEV, inputs, timeout=240,
                  pythonpath=(TESTS,), device_type="cpu")


def _jax_problem(fields, local=None):
    f = dict(fields, **(local or {}))
    return jba.BAProblem(**{k: jnp.asarray(v.astype(np.int32) if v.dtype.kind == "i" else v)
                            for k, v in f.items()})


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_dist_ba_matches_jax(problems, port_runs, name):
    fields, local, _ = problems[name]
    mesh = jmesh(N_DEV)
    run = jdist.make_dist_bundle_adjust(mesh, JCam.create(*INTR, dtype=jnp.float64),
                                        jba.BAConfig(), iters=PROBLEMS[name]["iters"])
    want, want_cost = run(jdist.shard_problem(mesh, _jax_problem(fields, local)))
    got = port_runs[0]
    np.testing.assert_allclose(got[name + "T_c_w"], np.asarray(want.T_c_w), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(got[name + "cost"]), float(want_cost), rtol=1e-6)
    np.testing.assert_allclose(got[name + "points"], np.asarray(want.points), rtol=0, atol=1e-6)


def test_dist_ba_matches_single_device(problems, port_runs):
    fields, _, T_true = problems["a."]
    prob = ba_problem_from_numpy(fields, "cpu")
    cfg = ba.BAConfig(early_exit=False)
    single, cost, trips = ba.lm_rounds(prob, StereoCamera.create(*INTR), cfg, prob.p_valid,
                                       prob.l_valid, PROBLEMS["a."]["iters"])
    assert int(trips) == PROBLEMS["a."]["iters"]
    got = port_runs[0]
    np.testing.assert_allclose(got["a.T_c_w"], single.T_c_w.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(got["a.cost"]), float(cost), rtol=1e-6)
    # both recover the true poses
    T = torch.from_numpy(got["a.T_c_w"]) @ torch.linalg.inv(torch.from_numpy(T_true))
    assert (T[:, :3, 3].abs().max() < 5e-3) and ((T[:, :3, :3] - torch.eye(3)).abs().max() < 5e-3)


def test_dist_ba_cost_decreases(problems, port_runs):
    fields, _, _ = problems["b."]
    prob = ba_problem_from_numpy(fields, "cpu")
    c0 = float(ba.total_cost(prob, StereoCamera.create(*INTR), ba.BAConfig(), prob.p_valid,
                             prob.l_valid))
    assert float(port_runs[0]["b.cost"]) < 0.1 * c0, (c0, float(port_runs[0]["b.cost"]))


def test_every_rank_holds_the_same_solution(port_runs):
    for out in port_runs[1:]:
        for k in out:
            np.testing.assert_array_equal(out[k], port_runs[0][k], err_msg=k)
