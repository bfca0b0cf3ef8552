"""plslam_tpu_torch.parallel.dist_match in 8 gloo rank processes:

- the sharded matcher on tests/test_dist_match_pgo.py's descriptors (512
  query rows over 8 ranks, 300 database rows, planted matches, about 5% of
  the query and database rows masked): ``idx`` and ``dist`` equal exactly
  the port's single-device ``match_mutual_nnr`` and JAX's sharded matcher
  (x64 on, as the conftest sets it).  The column-best packing is int64;
  with it truncated to int32 a masked row would wrap below every valid
  packed value and win its column;
- the edge-sharded PGO on the square loop of test_dist_match_pgo.py (edges
  padded to a multiple of 8): poses within 1e-6 of JAX's ``make_dist_pgo``
  and of the port's ``pgo.optimize`` (float64), the loop closed."""

import os

import jax
import numpy as np
import pytest
import torch

from plslam_tpu.ops import matching as JM
from plslam_tpu.ops.descriptors import hamming_distance_matrix as jhamming
from plslam_tpu.parallel import dist_match as jdist
from plslam_tpu.parallel.mesh import make_mesh as jmesh
from plslam_tpu_torch.backend import pgo
from plslam_tpu_torch.convert import pose_graph_from_numpy
from plslam_tpu_torch.ops import matching as M
from plslam_tpu_torch.ops.descriptors import hamming_distance_matrix
from plslam_tpu_torch.parallel.launch import launch

from test_dist_match_pgo import _square_loop
from test_torch_helpers import one_torch_thread  # noqa: F401

N_DEV = 8
PGO_ITERS = 10
TESTS = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def descriptors():
    """test_dist_match_pgo.py's query and database sets."""
    rng = np.random.default_rng(3)
    nq, ndb = 64 * N_DEV, 300
    dq = rng.integers(0, 2**32, (nq, 8), dtype=np.uint32)
    ddb = rng.integers(0, 2**32, (ndb, 8), dtype=np.uint32)
    for i in range(0, ndb, 3):
        ddb[i] = dq[i % nq]
    return dict(dq=dq, vq=rng.random(nq) < 0.95, ddb=ddb, vdb=rng.random(ndb) < 0.95)


@pytest.fixture(scope="module")
def graph():
    return jax.tree.map(np.asarray, _square_loop())


@pytest.fixture(scope="module")
def port_runs(descriptors, graph):
    inputs = dict(descriptors, pgo_iters=PGO_ITERS)
    inputs.update({"g." + k: v for k, v in graph._asdict().items()})
    return launch("torch_dist_ranks:run_dist_match_pgo", N_DEV, inputs, timeout=240,
                  pythonpath=(TESTS,), device_type="cpu")


def test_matcher_masks_rows(descriptors):
    for k in ("vq", "vdb"):
        assert 0.9 < descriptors[k].mean() < 1.0


def test_dist_matcher_equals_single_device(descriptors, port_runs):
    d = {k: torch.from_numpy(v) for k, v in descriptors.items()}
    want = M.match_mutual_nnr(
        hamming_distance_matrix(d["dq"].view(torch.int32), d["ddb"].view(torch.int32)),
        d["vq"][:, None] & d["vdb"][None, :], 0.9)
    got = port_runs[0]
    np.testing.assert_array_equal(got["idx"], want.idx.numpy())
    np.testing.assert_array_equal(got["dist"], want.dist.numpy())
    assert (got["idx"] >= 0).sum() > 50


def test_dist_matcher_equals_jax_sharded(descriptors, port_runs):
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = jmesh(N_DEV)
    put = lambda x, spec: jax.device_put(x, NamedSharding(mesh, spec))  # noqa: E731
    idx, dist = jdist.make_dist_matcher(mesh, nnr=0.9)(
        put(descriptors["dq"], P("lm")), put(descriptors["vq"], P("lm")),
        put(descriptors["ddb"], P()), put(descriptors["vdb"], P()))
    np.testing.assert_array_equal(port_runs[0]["idx"], np.asarray(idx))
    np.testing.assert_array_equal(port_runs[0]["dist"], np.asarray(dist))
    # and JAX's own single-device matcher (x64 on)
    ref = JM.match_mutual_nnr(
        jhamming(jax.numpy.asarray(descriptors["dq"]), jax.numpy.asarray(descriptors["ddb"])),
        descriptors["vq"][:, None] & descriptors["vdb"][None, :], 0.9)
    np.testing.assert_array_equal(port_runs[0]["idx"], np.asarray(ref.idx))


def test_dist_pgo_matches_jax(graph, port_runs):
    mesh = jmesh(N_DEV)
    want = jdist.make_dist_pgo(mesh, iters=PGO_ITERS)(jdist.shard_posegraph(
        mesh, jax.tree.map(jax.numpy.asarray, graph)))
    np.testing.assert_allclose(port_runs[0]["T_w_k"], np.asarray(want.T_w_k), rtol=0, atol=1e-6)


def test_dist_pgo_matches_single_device(graph, port_runs):
    got = port_runs[0]["T_w_k"]
    want = pgo.optimize(pose_graph_from_numpy(graph, "cpu"), PGO_ITERS).T_w_k.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got.dtype == np.float64
    assert np.linalg.norm(got[-1, :3, 3] - got[0, :3, 3]) < 0.02


def test_every_rank_holds_the_same_result(port_runs):
    for out in port_runs[1:]:
        for k in out:
            np.testing.assert_array_equal(out[k], port_runs[0][k], err_msg=k)
