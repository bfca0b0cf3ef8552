"""plslam_tpu_torch.backend.vocab against plslam_tpu.backend.vocab: the
same seeded corpus trains bit-identical levels; BoW vectors agree within
1e-6 (tf and tf-idf); the two shipped DBoW2 vocabularies load into
identical levels and weights; save -> load round-trips; L1 scores agree."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam_tpu.backend import vocab as jvoc
from plslam_tpu_torch.backend import vocab as tvoc

from test_torch_helpers import one_torch_thread, t, words  # noqa: F401

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")
SHIPPED = ("vocab_orb_k10L3.yml.gz", "vocab_lbd_k10L3.yml.gz")


def _desc(n, seed):
    return np.random.default_rng(seed).integers(0, 2 ** 32, (n, 8), dtype=np.uint32)


def _assert_same_voc(jv, tv):
    assert (jv.k, jv.depth) == (tv.k, tv.depth)
    for a, b in zip(jv.levels, tv.levels):
        np.testing.assert_array_equal(words(np.asarray(a)), b.numpy())
    if jv.word_weight is None:
        assert tv.word_weight is None
    else:
        np.testing.assert_array_equal(np.asarray(jv.word_weight), tv.word_weight.numpy())


def _bow_pair(jv, tv, desc, valid):
    a = np.asarray(jvoc.transform(jv, jnp.asarray(desc), jnp.asarray(valid)))
    b = tvoc.transform(tv, t(desc), torch.from_numpy(valid)).numpy()
    return a, b


@pytest.mark.parametrize("k,depth,iters", [(6, 2, 4), (4, 3, 2)])
def test_train_bit_identical(k, depth, iters):
    corpus = _desc(900, 1)
    jv = jvoc.train_vocabulary(corpus, k=k, depth=depth, iters=iters)
    tv = tvoc.train_vocabulary(corpus.view(np.int32), k=k, depth=depth, iters=iters)
    _assert_same_voc(jv, tv)
    # the int32 corpus of the port and the uint32 one give the same levels
    _assert_same_voc(jv, tvoc.train_vocabulary(corpus, k=k, depth=depth, iters=iters))
    desc = _desc(150, 2)
    valid = np.random.default_rng(3).uniform(size=150) < 0.8
    a, b = _bow_pair(jv, tv, desc, valid)
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
    np.testing.assert_allclose(b.sum(), 1.0, atol=1e-6)


@pytest.mark.parametrize("name", SHIPPED)
def test_shipped_vocabulary(name):
    path = os.path.join(CONFIGS, name)
    jv, tv = jvoc.load_dbow2_vocabulary(path), tvoc.load_dbow2_vocabulary(path)
    _assert_same_voc(jv, tv)
    assert tv.num_words == 1000 and tv.word_weight is not None
    # tf-idf BoW vectors
    desc = _desc(300, 4)
    a, b = _bow_pair(jv, tv, desc, np.ones(300, bool))
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)


def test_save_load_round_trip(tmp_path):
    voc = tvoc.train_vocabulary(_desc(400, 5), k=5, depth=2, iters=2)
    voc = voc._replace(word_weight=torch.linspace(0.5, 2.0, voc.num_words))
    path = str(tmp_path / "voc.yml.gz")
    tvoc.save_dbow2_vocabulary(path, voc)
    back = tvoc.load_dbow2_vocabulary(path)
    for a, b in zip(voc.levels, back.levels):
        assert torch.equal(a, b)
    np.testing.assert_allclose(back.word_weight.numpy(), voc.word_weight.numpy(), rtol=1e-5)
    # and the JAX package reads the port's file into the same levels
    _assert_same_voc(jvoc.load_dbow2_vocabulary(path), back)


def test_l1_score():
    rng = np.random.default_rng(6)
    v = rng.uniform(size=(4, 30)).astype(np.float32)
    v /= v.sum(-1, keepdims=True)
    a = np.asarray(jvoc.score_against_database(jnp.asarray(v[0]), jnp.asarray(v),
                                               jnp.asarray([True, True, False, True])))
    b = tvoc.score_against_database(torch.from_numpy(v[0]), torch.from_numpy(v),
                                    torch.tensor([True, True, False, True])).numpy()
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
    assert b[2] == -1.0 and abs(b[0] - 1.0) < 1e-6
    np.testing.assert_allclose(tvoc.l1_score(torch.from_numpy(v[1]), torch.from_numpy(v[3])),
                               float(jvoc.l1_score(jnp.asarray(v[1]), jnp.asarray(v[3]))),
                               atol=1e-6)
