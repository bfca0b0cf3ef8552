"""The loop closer's BoW transform on the CPU, through its static-buffer
program (``graphs.StagedProgram``: the code the card captures), against
the JAX package's ``vocab.transform`` (its ``_tf`` / ``_tf_l`` jit) on the
same seeded descriptors (tests/_program_inputs.py): exact with a tf
vocabulary trained on both sides from the same draws; within 1e-6
relative with the shipped DBoW2 tf-idf vocabulary, whose normalizing sum
the two packages add in different orders.  Also: one program per
(vocabulary, N), a result that survives the next call, the LRU's
eviction, and a vocabulary retrain dropping the programs built on the old
vocabulary.

The verification's pose solve (``LoopCloser._solve_pose``, one program
per bucket) on two ring keyframes, points only and points with lines:
``_verify_candidate`` returns the same (ok, DT, pt_pairs, ls_pairs) with
``capture=False`` (every field bit for bit) and as the JAX
``LoopCloser._verify_candidate`` (its ``jax.jit(trk.optimize_pose)``):
the flags and index pairs exactly, DT within 1e-5 (f32 Gauss-Newton on
both sides)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _program_inputs as pi
from _map_fixtures import make_camera
from plslam_tpu.backend import loop as jloop
from plslam_tpu.backend import mapping as jmap
from plslam_tpu.backend import vocab as jvocab
from plslam_tpu.frontend import features as jfeat
from plslam_tpu_torch.backend import vocab as tvocab
from plslam_tpu_torch.backend.loop import LoopCloser, LoopConfig
from plslam_tpu_torch.backend.mapping import (GRAPH_BUCKETS, KeyframeRecord, MapConfig,
                                              MapHandler)
from plslam_tpu_torch.convert import stereo_features_from_numpy

from test_torch_helpers import bits_equal, one_torch_thread  # noqa: F401

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")
N_KF = 14
DT_TOL = 1e-5


def _jax_voc(voc: tvocab.Vocabulary) -> jvocab.Vocabulary:
    return jvocab.Vocabulary(
        levels=tuple(jnp.asarray(lv.numpy().view(np.uint32)) for lv in voc.levels),
        k=voc.k, depth=voc.depth,
        word_weight=None if voc.word_weight is None else jnp.asarray(voc.word_weight.numpy()))


@pytest.fixture(scope="module")
def closer():
    """A loop closer over N_KF ring keyframes' host records, its point
    vocabulary trained online (k 8, depth 3) and its line vocabulary
    (k 8, depth 2) from their descriptors."""
    world = pi.keyframe_pair()[0]
    rng = np.random.default_rng(0)
    mapper = MapHandler(pi.port_camera(), MapConfig(plucker_lines=False), device="cpu")
    for i in range(N_KF):
        T = world.pose_at(0.3 + 0.04 * i)
        f = pi.render_ring_features(world, T, pi.CAM_K, rng)
        mapper.map.keyframes.append(KeyframeRecord(i, T, stereo_features_from_numpy(f, "cpu")))
    mapper.map.expand_graphs()
    lc = LoopCloser(pi.port_camera(), mapper, LoopConfig(vocab_refresh_kfs=0))
    assert lc._ensure_vocab(N_KF - 1) and lc.voc_l is not None
    return lc


def test_bow_program_equals_jax_transform_tf(closer):
    """Points and lines through the closer's programs, exactly JAX's."""
    for which, voc in (("p", closer.voc), ("l", closer.voc_l)):
        desc, valid = pi.descriptors(1, 160 if which == "p" else 24, 100 if which == "p" else 20)
        got = closer._transform(which, desc, valid).numpy()
        jv = _jax_voc(voc)
        tf = jax.jit(lambda d, v: jvocab.transform(jv, d, v))   # the JAX closer's _tf
        want = np.asarray(tf(jnp.asarray(desc.view(np.uint32)), jnp.asarray(valid)))
        np.testing.assert_array_equal(got, want)
        assert got.sum() == pytest.approx(1.0) and (got > 0).sum() > 5


def test_bow_program_equals_jax_transform_tf_idf():
    """The shipped DBoW2 point vocabulary (tf-idf weights) on both sides."""
    path = os.path.join(CONFIGS, "vocab_orb_k10L3.yml.gz")
    voc = tvocab.load_dbow2_vocabulary(path)
    jvoc = jvocab.load_dbow2_vocabulary(path)
    mapper = MapHandler(pi.port_camera(), MapConfig(plucker_lines=False), device="cpu")
    lc = LoopCloser(pi.port_camera(), mapper, LoopConfig())
    lc.voc = voc
    desc, valid = pi.descriptors(2, 160, 120)
    got = lc._transform("p", desc, valid).numpy()
    want = np.asarray(jvocab.transform(jvoc, jnp.asarray(desc.view(np.uint32)),
                                       jnp.asarray(valid)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got > 0, want > 0)


def test_bow_programs_per_vocabulary_and_width(closer):
    """``_bow_of`` runs the point and the line program; a second keyframe
    replays them; a new width builds a third; each result survives the
    next call."""
    closer.programs.clear()
    base = closer.programs.stats()["built"]
    kfs = closer.mapper.map.keyframes
    a = closer._bow_of(kfs[0])
    keep = a["p"].copy()
    b = closer._bow_of(kfs[1])
    assert closer.programs.stats()["built"] - base == 2 and len(closer.programs) == 2
    assert np.array_equal(a["p"], keep) and not np.array_equal(a["p"], b["p"])
    d1, v1 = pi.descriptors(3, 160, 90)
    out1 = closer._transform("p", d1, v1)
    keep = out1.clone()
    closer._transform("p", *pi.descriptors(4, 160, 90))
    assert bits_equal(out1, keep)
    closer._transform("p", *pi.descriptors(5, 96, 50))
    assert closer.programs.stats()["built"] - base == 3


def test_bow_program_cache_evicts_the_least_recent(closer):
    closer.programs.clear()
    closer.programs.size = 1
    try:
        ev = closer.programs.stats()["evicted"]
        closer._bow_of(closer.mapper.map.keyframes[2])   # the point, then the line program
        assert closer.programs.stats()["evicted"] - ev == 1 and len(closer.programs) == 1
        assert next(iter(closer.programs))[0] == "l"
    finally:
        closer.programs.size = GRAPH_BUCKETS


def test_retrain_drops_the_old_vocabulary_programs(closer):
    """An online retrain re-encodes every keyframe on programs of the new
    vocabularies; those of the old ones are gone."""
    closer._bow_of(closer.mapper.map.keyframes[0])
    old_voc = closer.voc
    closer._retrain_vocabulary(N_KF - 1)
    assert closer.voc is not old_voc
    ids = {key[1] for key in closer.programs}
    assert ids <= {id(closer.voc), id(closer.voc_l)} and id(old_voc) not in ids
    assert len(closer.bow) == N_KF
    kf = closer.mapper.map.keyframes[0]
    want = tvocab.transform(closer.voc, torch.from_numpy(kf.pt_desc.copy()),
                            torch.from_numpy(kf.pt_valid.copy()))
    np.testing.assert_array_equal(closer.bow[0]["p"], want.numpy())


def _jfeats(f):
    return jfeat.StereoFeatures(
        points=jfeat.PointSet(**{k: jnp.asarray(v) for k, v in f["points"].items()}),
        lines=jfeat.LineSet(**{k: jnp.asarray(v) for k, v in f["lines"].items()}))


def _verifiers(use_lines: bool, capture: bool):
    """The port's and the JAX package's loop closers over the same two
    ring keyframes (tests/_program_inputs.py), keyframe 1 the candidate
    of keyframe 0's revisit."""
    _, T0, T1, f0, f1 = pi.keyframe_pair(seed=3, step=0.06)
    cfg = dict(plucker_lines=False, use_lines=use_lines)
    mapper = MapHandler(pi.port_camera(), MapConfig(**cfg), device="cpu", capture=capture)
    jm = jmap.MapHandler(make_camera(), jmap.MapConfig(**cfg))
    for i, (T, f) in enumerate(((T0, f0), (T1, f1))):
        mapper.map.keyframes.append(KeyframeRecord(i, T, stereo_features_from_numpy(f, "cpu")))
        jm.map.keyframes.append(jmap.KeyframeRecord(i, T, _jfeats(f)))
    return (LoopCloser(pi.port_camera(), mapper, LoopConfig()),
            jloop.LoopCloser(make_camera(), jm, jloop.LoopConfig()))


@pytest.mark.parametrize("use_lines", [False, True], ids=["points", "points_lines"])
def test_verification_program_equals_eager_and_jax(use_lines):
    runs = {}
    for capture in (True, False):
        lc, jlc = _verifiers(use_lines, capture)
        runs[capture] = (lc, lc._verify_candidate(1, 0))
    (lc, got), (_, eager) = runs[True], runs[False]
    want = jlc._verify_candidate(1, 0)
    assert got[0] and eager[0] and want[0]
    for a, b in zip(got[1:], eager[1:]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    assert (len(got[3]) > 0) == use_lines
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=DT_TOL)
    assert np.abs(got[1][:3, 3]).max() > 0.01   # the keyframes are apart
    # one program for the bucket, keyed by lines or none; a second
    # candidate of the bucket reuses it
    keys = [k for k in lc.programs if k[0] == "verify"]
    assert len(keys) == 1 and keys[0][1].use_lines == use_lines
    again = lc._verify_candidate(1, 0)
    assert lc.programs.stats()["built"] == 1 and np.array_equal(again[1], got[1])
    assert lc.solve_counts["solves"] == 2


def test_a_verification_keeps_its_result():
    """The solve's output is a copy: the next solve leaves it as it was."""
    lc, _ = _verifiers(True, True)
    kf = lc.mapper.map.keyframes
    n = len(kf[0].pt_valid)
    arrays = dict(P=kf[0].pt_P, obs=kf[1].pt_uv[:n], valid=kf[0].pt_valid & kf[1].pt_valid[:n])
    first = lc._solve_pose(arrays)
    keep = first.clone()
    lc._solve_pose(dict(arrays, obs=arrays["obs"] + np.float32(3.0)))
    assert bits_equal(first, keep) and first.shape == (54,)
