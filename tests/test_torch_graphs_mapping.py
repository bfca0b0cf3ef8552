"""The mapper's per-keyframe programs on the CPU, through their static-buffer
code (``graphs.StagedProgram``: the code the card captures), against the
JAX package's jitted programs on the same seeded numpy inputs
(tests/_program_inputs.py: two ring keyframes, staged local-map
candidates, landmark links):

- the fused association ``_assoc_prog`` (KF2KF, the chi^2 gates, Map2KF,
  the packed features), in both line modes;
- the split association's ``_kf2kf_prog`` and ``_map2kf_prog``;
- the refinement's ``optimize_pose`` (JAX ``_refine_jit``), both line
  modes.

Exact: match indices, chi^2 flags, the packed features, the refinement's
good flag and inlier counts.  Within 1e-4 px: Map2KF's point and line
errors.  Within 1e-5: the refinement's DT (f32 Gauss-Newton on both
sides).  Also: a bucket change builds a second program, the LRU evicts
the least recent, a result survives the next call, and the local BA
through the shared helper with int32 index arrays keeps the bits of the
eager composition."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _program_inputs as pi
from _map_fixtures import make_camera
from plslam_tpu.backend import mapping as jmap
from plslam_tpu.frontend import features as jfeat
from plslam_tpu.frontend import tracker as jtracker
from plslam_tpu_torch.backend import mapping as tmap
from plslam_tpu_torch.convert import stereo_features_from_numpy

from test_torch_graphs import CAM as BA_CAM, _eager_solve, _np_problem
from test_torch_helpers import bits_equal, one_torch_thread  # noqa: F401

JCAM = make_camera()
TCAM = pi.port_camera()
N_CAND, N_CAND_L, NB, NBL = 150, 20, 256, 64
PX_TOL = 1e-4
DT_TOL = 1e-5


def _jfeats(f):
    return jfeat.StereoFeatures(
        points=jfeat.PointSet(**{k: jnp.asarray(v) for k, v in f["points"].items()}),
        lines=jfeat.LineSet(**{k: jnp.asarray(v) for k, v in f["lines"].items()}))


def _handlers(plucker=True):
    cfg = dict(plucker_lines=plucker, has_refinement=not plucker)
    return (jmap.MapHandler(JCAM, jmap.MapConfig(**cfg)),
            tmap.MapHandler(TCAM, tmap.MapConfig(**cfg), device="cpu"))


@pytest.fixture(scope="module")
def pair():
    return pi.keyframe_pair()


def _prev_record(T0, f0, pt_lm, ls_lm):
    rec = tmap.KeyframeRecord(0, T0, stereo_features_from_numpy(f0, "cpu"))
    rec.pt_lm, rec.ls_lm = pt_lm, ls_lm
    return rec


def _assoc_inputs(pair, seed, nb=NB, nbl=NBL, n_cand=N_CAND):
    return pi.assoc_inputs(pair, seed, nb, nbl, n_cand, N_CAND_L)


def _jax_assoc(jm, pair, inp, nb=NB, nbl=NBL):
    _, _, _, f0, f1 = pair
    Tm, cpack, dpack, cval, pt_lm, ls_lm, pf = inp
    return np.asarray(jm._assoc_prog(
        jnp.asarray(Tm), _jfeats(f0), _jfeats(f1), jnp.asarray(pt_lm, jnp.int32),
        jnp.asarray(ls_lm, jnp.int32), jnp.asarray(cpack), jnp.asarray(dpack.view(np.uint32)),
        jnp.asarray(cval), jnp.asarray(pf, jnp.int32), nb, nbl))


def _port_assoc(tm, pair, inp, nb=NB, nbl=NBL):
    _, T0, _, f0, f1 = pair
    Tm, cpack, dpack, cval, pt_lm, ls_lm, pf = inp
    return tm._assoc(_prev_record(T0, f0, pt_lm, ls_lm), stereo_features_from_numpy(f1, "cpu"),
                     Tm, cpack, dpack, cval, pf, nb, nbl)


def _assert_assoc_equal(got, want, n, nl, nb, nbl, use_lines=True):
    """[KF2KF idx, chi | Map2KF idx, err (, line idx, global idx, errs) |
    packed features]: indices, flags and features exact, errors to PX_TOL."""
    nk2 = 2 * n + (2 * nl if use_lines else 0)
    np.testing.assert_array_equal(got[:nk2], want[:nk2])
    m2, w2 = got[nk2:], want[nk2:]
    np.testing.assert_array_equal(m2[:nb], w2[:nb])
    np.testing.assert_allclose(m2[nb:2 * nb], w2[nb:2 * nb], rtol=0, atol=PX_TOL)
    end = 2 * nb
    if use_lines:
        np.testing.assert_array_equal(m2[2 * nb:2 * nb + 2 * nbl], w2[2 * nb:2 * nb + 2 * nbl])
        np.testing.assert_allclose(m2[2 * nb + 2 * nbl:2 * nb + 4 * nbl],
                                   w2[2 * nb + 2 * nbl:2 * nb + 4 * nbl], rtol=0, atol=PX_TOL)
        end = 2 * nb + 4 * nbl
    np.testing.assert_array_equal(m2[end:].view(np.uint32), w2[end:].view(np.uint32))
    # the inputs make real matches on both passes (KF2KF takes most of
    # the new keyframe's points, so Map2KF finds few free ones)
    assert (got[:n] >= 0).sum() > 20 and (m2[:nb] >= 0).sum() > 3


@pytest.mark.parametrize("plucker", [True, False])
def test_fused_association_equals_jax(pair, plucker):
    jm, tm = _handlers(plucker)
    inp = _assoc_inputs(pair, seed=1)
    got = _port_assoc(tm, pair, inp).numpy()
    n, nl = len(pair[3]["points"]["valid"]), len(pair[3]["lines"]["valid"])
    _assert_assoc_equal(got, _jax_assoc(jm, pair, inp), n, nl, NB, NBL)
    assert tm.graph_stats()["assoc"]["built"] == 1


def test_association_bucket_change_and_eviction(pair):
    """A second (nb, nbl) bucket builds a second program, each equal to JAX;
    with room for one program the first bucket is evicted and built again."""
    jm, tm = _handlers()
    n, nl = len(pair[3]["points"]["valid"]), len(pair[3]["lines"]["valid"])
    cache = tm.programs["assoc"]
    cache.size = 1
    for nb, n_cand in ((NB, N_CAND), (2 * NB, 300), (NB, N_CAND)):
        inp = _assoc_inputs(pair, seed=2, nb=nb, n_cand=n_cand)
        got = _port_assoc(tm, pair, inp, nb=nb).numpy()
        _assert_assoc_equal(got, _jax_assoc(jm, pair, inp, nb=nb), n, nl, nb, NBL)
    st = cache.stats()
    assert (st["built"], st["evicted"], st["buckets"]) == (3, 2, 1)


def test_association_result_survives_the_next_call(pair):
    _, tm = _handlers()
    out1 = _port_assoc(tm, pair, _assoc_inputs(pair, seed=3))
    keep = out1.clone()
    out2 = _port_assoc(tm, pair, _assoc_inputs(pair, seed=4))
    assert tm.graph_stats()["assoc"]["built"] == 1    # one bucket, called twice
    assert bits_equal(out1, keep) and not bits_equal(out1, out2)


def test_kf2kf_program_equals_jax(pair):
    world, T0, T1, f0, f1 = pair
    jm, tm = _handlers()
    T_rel = (np.linalg.inv(T1) @ T0).astype(np.float32)
    p, l = f0["points"], f0["lines"]
    k, kl = f1["points"], f1["lines"]
    want = np.asarray(jm._kf2kf_prog(
        jnp.asarray(T_rel), *(jnp.asarray(x) for x in (
            p["P"], p["desc"], p["valid"], k["desc"], k["uv"], k["valid"], l["desc"], l["sp"],
            l["ep"], l["valid"], kl["desc"], kl["sp"], kl["ep"], kl["valid"]))))
    prev = _prev_record(T0, f0, *pi.links(0, len(p["valid"]), len(l["valid"]), 1, 1)[:2])
    outs = [tm._kf2kf(prev, stereo_features_from_numpy(f, "cpu"), T_rel).numpy()
            for f in (f1, f0)]
    np.testing.assert_array_equal(outs[0], want)
    assert (want[:len(p["valid"])] >= 0).sum() > 20
    # the same widths, one program; the other keyframe pair's output differs
    assert tm.graph_stats()["kf2kf"]["built"] == 1 and not np.array_equal(outs[1], want)


def test_map2kf_program_equals_jax(pair):
    world, T0, T1, f0, f1 = pair
    jm, tm = _handlers()
    cpack, dpack, cval = pi.candidates(world, T1, 5, N_CAND, N_CAND_L, NB, NBL)
    vpack = np.concatenate([cval, pi.free_mask(5, f1)])
    T_c_w = np.linalg.inv(T1).astype(np.float32)
    k, kl = f1["points"], f1["lines"]
    want = np.asarray(jm._map2kf_prog(
        jnp.asarray(T_c_w), jnp.asarray(cpack), jnp.asarray(dpack.view(np.uint32)),
        jnp.asarray(vpack), *(jnp.asarray(x) for x in (k["desc"], k["uv"], kl["sp"], kl["ep"],
                                                      kl["desc"])), NB, NBL))
    got = tm._map2kf(stereo_features_from_numpy(f1, "cpu"), T_c_w, cpack, dpack, vpack,
                     NB, NBL).numpy()
    np.testing.assert_array_equal(got[:NB], want[:NB])
    np.testing.assert_allclose(got[NB:2 * NB], want[NB:2 * NB], rtol=0, atol=PX_TOL)
    np.testing.assert_array_equal(got[2 * NB:2 * NB + 2 * NBL], want[2 * NB:2 * NB + 2 * NBL])
    np.testing.assert_allclose(got[2 * NB + 2 * NBL:], want[2 * NB + 2 * NBL:], rtol=0,
                               atol=PX_TOL)
    assert (got[:NB] >= 0).sum() > 10


@pytest.mark.parametrize("plucker", [True, False])
def test_refinement_program_equals_jax(pair, plucker):
    """The 19 floats against the JAX package's ``_refine_jit`` (its
    ``optimize_pose`` jitted with the mapper's tracker configuration)."""
    world, T0, T1, f0, f1 = pair
    jm, tm = _handlers(plucker)
    arrays = pi.refine_arrays(7, f0, T0, T1)
    got = tm._refine(arrays).numpy()
    tcfg = jtracker.TrackerConfig()._replace(plucker_lines=plucker, use_lines=True)
    refine_jit = jax.jit(lambda p, l, cam: jtracker.optimize_pose(p, l, cam, tcfg))
    a = {k: jnp.asarray(v) for k, v in arrays.items()}
    pts = jfeat.TrackedPoints(P=a["P"], obs=a["obs"], sigma2=a["sigma2"], valid=a["valid"],
                              inlier=a["valid"])
    ls = jfeat.TrackedLines(sP=a["sP"], eP=a["eP"], sp=a["sp"], ep=a["ep"], NDc=a["NDc"],
                            sobs=a["sobs"], eobs=a["eobs"], le_obs=a["le"],
                            sigma2=a["ls_sigma2"], valid=a["lvalid"], inlier=a["lvalid"])
    est, pts_out, ls_out = refine_jit(pts, ls, JCAM)
    np.testing.assert_allclose(got[:16].reshape(4, 4), np.asarray(est.DT), rtol=0, atol=DT_TOL)
    assert got[16] == float(bool(est.good)) == 1.0
    assert got[17] == int(np.asarray(pts_out.inlier).sum()) > 50
    assert got[18] == int(np.asarray(ls_out.inlier).sum())
    # the solve recovers the keyframe motion the observations were made with
    np.testing.assert_allclose(got[:16].reshape(4, 4), np.linalg.inv(T1) @ T0, rtol=0, atol=5e-3)
    assert tm.graph_stats()["refine"]["built"] == 1


@pytest.mark.parametrize("plucker", [True, False])
def test_local_ba_int32_indices_keep_the_eager_bits(plucker):
    """The local BA through the shared staged-program helper: int32 index
    arrays are staged as int64, and the solve equals the eager composition
    bit for bit (tests/test_torch_graphs.py holds the int64 inputs)."""
    mapper = tmap.MapHandler(BA_CAM, tmap.MapConfig(), device="cpu")
    prob, meta = _np_problem(plucker=plucker)
    small = prob._replace(**{k: np.asarray(getattr(prob, k)).astype(np.int32)
                             for k in ("p_cam", "p_lm", "l_cam", "l_lm")})
    out, _ = mapper._solve_local(small, meta)
    assert bits_equal(out, _eager_solve(prob, meta, mapper.ba_cfg))
    again, _ = mapper._solve_local(prob, meta)     # int64 indices: the same bucket
    assert bits_equal(again, out) and mapper.graph_stats()["local_ba"]["built"] == 1
