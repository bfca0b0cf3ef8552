"""The chunked GBA and the PGO in their trip form on the CPU (one LM or GN
iteration over static buffers, ``graphs.Trips``: the code the card
captures once and replays), against the JAX package on the same seeded
numpy inputs (tests/_program_inputs.py):

- ``ba.bundle_adjust_chunked`` against JAX ``bundle_adjust_chunked`` on
  a stacked problem of 2 chunks (K = 8), Plücker and endpoint lines, in
  float64 within 1e-7 (the tolerance of test_torch_ba.test_chunked_gba);
- ``pgo.optimize`` against JAX ``pgo.optimize`` on a ring closure's pose
  graph in float64 within 1e-9.

With a stand-in for ``graphs.Program`` that runs the capture's warm-ups
and counts its replays, as on the card: exactly ``iters1 + iters2`` GBA
trips and ``iters`` PGO iterations run, warm-ups included, split between
the warm-ups and the replays as on the card, and the results equal the
eager loop (``capture=False``) bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _program_inputs as pi
from plslam_tpu.backend import ba as jba
from plslam_tpu.backend import pgo as jpgo
from plslam_tpu.core.camera import StereoCamera as JCam
from plslam_tpu_torch import graphs
from plslam_tpu_torch.backend import ba, pgo
from plslam_tpu_torch.convert import ba_problem_from_numpy, pose_graph_from_numpy
from plslam_tpu_torch.core.camera import StereoCamera

from test_torch_helpers import bits_equal, one_torch_thread  # noqa: F401

JC = JCam.create(*pi.GBA_INTR, dtype=jnp.float64)
TC = StereoCamera.create(*pi.GBA_INTR)
GBA_TOL = 1e-7
PGO_TOL = 1e-9


class CountingProgram:
    """``graphs.Program`` as the card runs it: with ``capture`` its
    construction calls ``fn`` WARMUP times, and each later call stands for
    one replay.  Every instance is kept in ``built``."""

    built: list = []

    def __init__(self, fn, device, *, capture=True):
        self.fn, self.captured = fn, capture
        self.warmups = graphs.WARMUP if capture else 0
        self.replays = 0
        for _ in range(self.warmups):
            fn()
        CountingProgram.built.append(self)

    def __call__(self):
        self.replays += self.captured
        return self.fn()

    def pool_bytes(self) -> int:
        return 0

    def release(self) -> None:
        self.fn = None


@pytest.fixture
def counting(monkeypatch):
    """``graphs.Program`` replaced by ``CountingProgram``, and a tally of
    the iterations that really ran: each GBA trip solves its reduced
    camera system once, each PGO iteration its dense system once."""
    CountingProgram.built = []
    calls = {"solve_reduced": 0, "solve_spd": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(graphs, "Program", CountingProgram)
    monkeypatch.setattr(ba, "solve_reduced", counted("solve_reduced", ba.solve_reduced))
    monkeypatch.setattr(pgo.linalg, "solve_spd", counted("solve_spd", pgo.linalg.solve_spd))
    return calls


def _jax_problem(d: dict) -> jba.BAProblem:
    return jba.BAProblem(**{k: jnp.asarray(v.astype(np.int32) if v.dtype.kind in "iu" else v)
                            for k, v in d.items()})


def _gba(d: dict, cfg=ba.BAConfig(), **kw):
    report = {}
    res = ba.bundle_adjust_chunked(ba_problem_from_numpy(d, "cpu"), TC, cfg, report=report,
                                   **kw)
    return res, report


@pytest.mark.parametrize("endpoint", [False, True], ids=["plucker", "endpoint"])
def test_trip_gba_equals_jax(endpoint):
    d = pi.chunked_problem(seed=3, endpoint=endpoint)
    want = jax.jit(jba.bundle_adjust_chunked, static_argnums=(2, 3))(
        _jax_problem(d), JC, jba.BAConfig(), None)
    got, report = _gba(d)
    assert report == {"eager": 15, "replayed": 0, "captured": False, "pool_bytes": 0}
    np.testing.assert_array_equal(got.p_active.numpy(), np.asarray(want.p_active))
    np.testing.assert_array_equal(got.l_active.numpy(), np.asarray(want.l_active))
    fields = ("T_c_w", "points") if endpoint else ("T_c_w", "points", "lines_orth")
    for name in fields:
        np.testing.assert_allclose(getattr(got.problem, name).numpy(),
                                   np.asarray(getattr(want.problem, name)),
                                   rtol=0, atol=GBA_TOL, err_msg=name)
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=1e-7)
    # the solve moved, and down in cost under the final masks
    start = ba_problem_from_numpy(d, "cpu")
    assert np.abs(got.problem.T_c_w.numpy() - d["T_c_w"]).max() > 1e-3
    before = sum(float(ba.total_cost(ba._chunk(start, c, start.T_c_w, start.points[c],
                                               start.lines_orth[c]), TC, ba.BAConfig(),
                                     got.p_active[c], got.l_active[c])) for c in range(2))
    assert float(got.cost) < 0.5 * before


@pytest.mark.parametrize("iters", [(5, 10), (1, 3), (2, 1)])
def test_gba_trip_count(counting, iters):
    """``iters1 + iters2`` trips: the program is built at the first round
    of at least WARMUP trips (its warm-ups are trips of that round), and
    the rest replay; the poses, landmarks, masks and cost are those of the
    eager loop, bit for bit."""
    cfg = ba.BAConfig(iters1=iters[0], iters2=iters[1])
    d = pi.chunked_problem(seed=4, endpoint=True)
    got, report = _gba(d, cfg, capture=True)
    n = sum(iters)
    assert counting["solve_reduced"] == n
    (prog,) = CountingProgram.built
    before = 0 if iters[0] >= graphs.WARMUP else iters[0]   # trips before the program
    assert prog.replays == n - before - graphs.WARMUP
    assert report == {"eager": before + graphs.WARMUP, "replayed": n - before - graphs.WARMUP,
                      "captured": True, "pool_bytes": 0}
    assert prog.fn is None   # dropped at the end of the call
    counting["solve_reduced"] = 0
    want, eager = _gba(d, cfg, capture=False)
    assert counting["solve_reduced"] == n and eager["eager"] == n and not eager["replayed"]
    for a, b in ((got.problem.T_c_w, want.problem.T_c_w), (got.problem.points, want.problem.points),
                 (got.p_active, want.p_active), (got.l_active, want.l_active),
                 (got.cost, want.cost)):
        assert bits_equal(a, b)


def test_trip_pgo_equals_jax():
    d = pi.ring_pose_graph(seed=2, K=24)
    jg = jpgo.PoseGraph(**{k: jnp.asarray(v.astype(np.int32) if k in ("e_i", "e_j") else v)
                           for k, v in d.items()})
    tg = pose_graph_from_numpy(d, "cpu")
    for iters in (1, 25):
        want = np.asarray(jax.jit(jpgo.optimize, static_argnums=1)(jg, iters).T_w_k)
        report = {}
        got = pgo.optimize(tg, iters, report=report).T_w_k.numpy()
        assert report["eager"] == iters and not report["replayed"]
        np.testing.assert_allclose(got, want, rtol=0, atol=PGO_TOL)
        np.testing.assert_array_equal(got[0], d["T_w_k"][0])
    assert float(pgo.build_system(tg._replace(T_w_k=torch.from_numpy(got)))[2]) \
        < 0.1 * float(pgo.build_system(tg)[2])
    np.testing.assert_array_equal(tg.T_w_k.numpy(), d["T_w_k"])   # the input stays


@pytest.mark.parametrize("iters", [25, 3, 2, 1])
def test_pgo_iteration_count(counting, iters):
    """``iters`` iterations; a loop of at most WARMUP iterations is not
    captured (no replay would follow); the poses are the eager loop's bit
    for bit."""
    tg = pose_graph_from_numpy(pi.ring_pose_graph(seed=2, K=24), "cpu")
    report = {}
    got = pgo.optimize(tg, iters, capture=True, report=report).T_w_k
    assert counting["solve_spd"] == iters
    captured = iters > graphs.WARMUP
    replays = iters - graphs.WARMUP if captured else 0
    assert report == {"eager": iters - replays, "replayed": replays, "captured": captured,
                      "pool_bytes": 0}
    built = CountingProgram.built
    assert len(built) == (iters >= graphs.WARMUP)
    assert sum(p.replays for p in built) == replays
    assert bits_equal(got, pgo.optimize(tg, iters, capture=False).T_w_k)


def test_collective_forms_are_not_captured():
    d = pi.chunked_problem(seed=5, C=2, K=3, P=6, L=2)
    with pytest.raises(ValueError):
        ba.bundle_adjust_chunked(ba_problem_from_numpy(d, "cpu"), TC, ba.BAConfig(),
                                 gather=lambda x: x, capture=True)
    tg = pose_graph_from_numpy(pi.ring_pose_graph(K=6, band=2), "cpu")
    with pytest.raises(ValueError):
        pgo.optimize(tg, 3, allsum=lambda x: x, capture=True)
