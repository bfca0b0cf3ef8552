"""plslam_tpu_torch.backend.loop against plslam_tpu.backend.loop on the
12-keyframe drifting square loop of tests/test_loop.py, generated once
from a seed, the same arrays fed to both MapHandler + LoopCloser pairs:
the covisibility and essential pose graphs, the online vocabulary with
refreshes, and the shipped pretrained vocabulary.  Exact: the loop reports
(keyframe, candidate, fusion stats), the BoW and conf shapes, the
observation tables and landmark links.  Within 1e-6: the conf matrix.
Within 1e-5 m: keyframe poses and landmarks after the closure."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from plslam_tpu.backend import loop as jloop
from plslam_tpu.backend import mapping as jmap
from plslam_tpu.core import lie as jlie
from plslam_tpu.frontend.features import LineSet, PointSet, StereoFeatures
from plslam_tpu_torch.backend import loop as tloop
from plslam_tpu_torch.backend import mapping as tmap
from plslam_tpu_torch.convert import stereo_features_from_numpy

from test_torch_helpers import cams, one_torch_thread  # noqa: F401

JCAM, TCAM = cams()
N_PT = 96
N_LS = 24
VOCAB = os.path.join(os.path.dirname(__file__), "..", "configs", "vocab_orb_k10L3.yml.gz")
POS_TOL = 1e-5


def make_scenario(seed=17, lines=False):
    """Square loop of 12 steps with drifted odometry; KF i observes its own
    place (points, and segments with ``lines``), the 13th keyframe revisits
    place 0.  Returns (T_true, T_drift, per-keyframe JAX StereoFeatures)."""
    rng = np.random.default_rng(seed)
    xis = []
    for _ in range(4):
        for s in range(3):
            xi = np.zeros(6)
            xi[0] = 1.2
            if s == 2:
                xi[5] = np.pi / 2
            xis.append(xi)
    noisy = [x + rng.normal(size=6) * np.array([0.02] * 3 + [0.004] * 3) for x in xis]
    exp = jax.vmap(jlie.exp_se3)
    st, sd = np.asarray(exp(jnp.asarray(np.stack(xis)))), np.asarray(exp(jnp.asarray(np.stack(noisy))))
    T_true, T_drift = [np.eye(4)], [np.eye(4)]
    for a, b in zip(st, sd):
        T_true.append(T_true[-1] @ a)
        T_drift.append(T_drift[-1] @ b)
    places = []
    for T in T_true:
        local = np.stack([rng.uniform(-2.5, 2.5, N_PT), rng.uniform(-1.8, 1.8, N_PT),
                          rng.uniform(3.0, 9.0, N_PT)], -1)
        pl = [(T[:3, :3] @ local.T).T + T[:3, 3],
              rng.integers(0, 2 ** 32, (N_PT, 8), dtype=np.uint32)]
        if lines:
            a = np.stack([rng.uniform(-2.0, 2.0, N_LS), rng.uniform(-1.5, 1.5, N_LS),
                          rng.uniform(3.0, 8.0, N_LS)], -1)
            b = a + np.stack([rng.uniform(-1.2, 1.2, N_LS), rng.uniform(-1.2, 1.2, N_LS),
                              rng.uniform(-0.3, 0.3, N_LS)], -1)
            pl += [(T[:3, :3] @ a.T).T + T[:3, 3], (T[:3, :3] @ b.T).T + T[:3, 3],
                   rng.integers(0, 2 ** 32, (N_LS, 8), dtype=np.uint32)]
        places.append(pl)
    places[-1] = places[0]   # the revisit
    return T_true, T_drift, [_features(T, *pl) for T, pl in zip(T_true, places)]


def _project(T_c_w, Pw):
    Pc = (T_c_w[:3, :3] @ Pw.T).T + T_c_w[:3, 3]
    uv = np.stack([435.2 * Pc[:, 0] / Pc[:, 2] + 367.4, 435.2 * Pc[:, 1] / Pc[:, 2] + 252.2], -1)
    ok = (Pc[:, 2] > 0.3) & (uv[:, 0] > 0) & (uv[:, 0] < 752) & (uv[:, 1] > 0) \
        & (uv[:, 1] < 480)
    return Pc, uv, ok


def _features(T_w_c, pts_w, desc, ls_a=None, ls_b=None, ls_desc=None):
    T_c_w = np.linalg.inv(T_w_c)
    Pc, uv, valid = _project(T_c_w, pts_w)
    pts = PointSet(uv=jnp.asarray(uv, jnp.float32),
                   disp=jnp.asarray(435.2 * 0.110074 / Pc[:, 2], jnp.float32),
                   P=jnp.asarray(Pc, jnp.float32), desc=jnp.asarray(desc),
                   sigma2=jnp.ones(N_PT, jnp.float32), valid=jnp.asarray(valid))
    if ls_a is None:
        return StereoFeatures(points=pts, lines=LineSet.empty(8))
    aC, auv, aok = _project(T_c_w, ls_a)
    bC, buv, bok = _project(T_c_w, ls_b)
    le = np.cross(np.concatenate([auv, np.ones((N_LS, 1))], 1),
                  np.concatenate([buv, np.ones((N_LS, 1))], 1))
    le /= np.maximum(np.hypot(le[:, 0], le[:, 1]), 1e-9)[:, None]
    f32 = functools.partial(jnp.asarray, dtype=jnp.float32)
    lines = LineSet(sp=f32(auv), ep=f32(buv), sdisp=f32(np.ones(N_LS)),
                    edisp=f32(np.ones(N_LS)), sP=f32(aC), eP=f32(bC), le=f32(le),
                    angle=f32(np.arctan2(buv[:, 1] - auv[:, 1], buv[:, 0] - auv[:, 0])),
                    NDc=f32(np.concatenate([np.cross(aC, bC), bC - aC], -1)),
                    desc=jnp.asarray(ls_desc), sigma2=f32(np.ones(N_LS)),
                    valid=jnp.asarray(aok & bok))
    return StereoFeatures(points=pts, lines=lines)


SCENARIO = make_scenario()
SCENARIO_LINES = make_scenario(lines=True)


def _run(scenario=SCENARIO, use_lines=False, **loop_kw):
    T_true, T_drift, feats = scenario
    mkw = dict(use_lines=use_lines, plucker_lines=False, min_lm_cov_graph=10 ** 9)
    out = []
    for side in ("jax", "port"):
        if side == "jax":
            m = jmap.MapHandler(JCAM, jmap.MapConfig(**mkw))
            lc = jloop.LoopCloser(JCAM, m, jloop.LoopConfig(
                lc_kf_dist=8, lc_nkf_closest=1, min_pt_matches=12, vocab_k=6, vocab_depth=2,
                **loop_kw))
            fs = feats
        else:
            m = tmap.MapHandler(TCAM, tmap.MapConfig(**mkw), device="cpu")
            lc = tloop.LoopCloser(TCAM, m, tloop.LoopConfig(
                lc_kf_dist=8, lc_nkf_closest=1, min_pt_matches=12, vocab_k=6, vocab_depth=2,
                **loop_kw))
            fs = [stereo_features_from_numpy(f, "cpu") for f in feats]
        m.initialize(T_drift[0], fs[0])
        reports = [lc.on_new_keyframe()]
        for T, f in zip(T_drift[1:], fs[1:]):
            m.add_keyframe(T, f, run_ba=False)
            reports.append(lc.on_new_keyframe())
        out.append((m, lc, [r for r in reports if r]))
    return out


def _assert_same(j, t):
    (jm, jlc, jrep), (tm, tlc, trep) = j, t
    assert [(r["kf"], r["candidate"], r["fused"]) for r in trep] == \
        [(r["kf"], r["candidate"], r["fused"]) for r in jrep]
    np.testing.assert_allclose([r["correction"] for r in trep],
                               [r["correction"] for r in jrep], rtol=0, atol=POS_TOL)
    assert tlc.closed_at == jlc.closed_at
    assert len(tlc.bow) == len(jlc.bow) and tlc.conf.shape == jlc.conf.shape
    np.testing.assert_allclose(tlc.conf, jlc.conf, rtol=0, atol=1e-6)
    for a, b in zip(jlc.bow, tlc.bow):
        np.testing.assert_allclose(b["p"], a["p"], rtol=0, atol=1e-6)
        assert (a["n_pt"], a["n_ls"]) == (b["n_pt"], b["n_ls"])
    a, b = jm.map, tm.map
    for ta, tb in ((a.pobs, b.pobs), (a.lobs, b.lobs)):
        assert ta.n == tb.n
        for f in ("valid", "lm", "kf", "fi"):
            np.testing.assert_array_equal(getattr(ta, f)[: ta.n], getattr(tb, f)[: tb.n])
    np.testing.assert_array_equal(a.covis, b.covis)
    np.testing.assert_array_equal(a.pt_valid, b.pt_valid)
    np.testing.assert_array_equal(a.ls_valid, b.ls_valid)
    for ka, kb in zip(a.keyframes, b.keyframes):
        np.testing.assert_array_equal(ka.pt_lm, kb.pt_lm)
        np.testing.assert_array_equal(ka.ls_lm, kb.ls_lm)
    np.testing.assert_allclose(np.stack([k.T_w_k for k in b.keyframes]),
                               np.stack([k.T_w_k for k in a.keyframes]), rtol=0, atol=POS_TOL)
    np.testing.assert_allclose(b.pt_w, a.pt_w, rtol=0, atol=POS_TOL)
    np.testing.assert_allclose(b.ls_epw, a.ls_epw, rtol=0, atol=POS_TOL)
    np.testing.assert_allclose(b.ls_w, a.ls_w, rtol=0, atol=POS_TOL)


def _drift(m, scenario=SCENARIO):
    return np.linalg.norm(m.map.keyframes[-1].T_w_k[:3, 3] - scenario[0][-1][:3, 3])


@pytest.mark.parametrize("variant", ["covisibility", "essential", "refresh", "pretrained"])
def test_loop_closure_parity(variant):
    kw = {"covisibility": {}, "essential": dict(pgo_graph="essential"),
          "refresh": dict(vocab_refresh_kfs=4), "pretrained": dict(vocabulary_file=VOCAB)}
    j, t = _run(**kw[variant])
    _assert_same(j, t)
    tm, tlc, rep = t
    k = len(tm.map.keyframes)
    assert len(tlc.bow) == k and tlc.conf.shape == (k, k)
    np.testing.assert_array_equal(tlc.conf, tlc.conf.T)
    assert len(rep) == 1 and rep[0]["kf"] == 12 and rep[0]["candidate"] == 0, rep
    assert sum(rep[0]["fused"].values()) > 0
    drift_before = np.linalg.norm(SCENARIO[1][-1][:3, 3] - SCENARIO[0][-1][:3, 3])
    assert _drift(tm) < 0.5 * drift_before
    if variant == "pretrained":
        assert tlc.voc.num_words == 1000 and tlc.voc.word_weight is not None


def test_loop_closure_with_lines():
    """Endpoint lines in the map: line BoW, line verification (mutual NNR
    and the line ratio gates), the rigid endpoint correction and the line
    fusion cases, on both sides."""
    j, t = _run(SCENARIO_LINES, use_lines=True)
    _assert_same(j, t)
    tm, tlc, rep = t
    assert len(rep) == 1 and (rep[0]["kf"], rep[0]["candidate"]) == (12, 0), rep
    assert tlc.voc_l is not None and tlc.bow[-1]["l"] is not None
    assert tm.map.ls_valid.sum() > 0
    assert _drift(tm) < np.linalg.norm(SCENARIO_LINES[1][-1][:3, 3]
                                       - SCENARIO_LINES[0][-1][:3, 3])
