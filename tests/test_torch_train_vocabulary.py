"""``plslam_tpu_torch.train_vocabulary`` against
``scripts/train_vocabulary.py``: the same descriptors (seeded numpy words)
trained and saved by each package give files whose gunzipped bytes are
equal, for both modalities; and the port's command line at 1 scene x 2
frames on the CPU writes vocabularies that load back with the trained
word counts."""

import gzip
import os

import numpy as np
import pytest

from plslam_tpu_torch import train_vocabulary as T
from plslam_tpu_torch.backend import vocab as V
from test_torch_helpers import load_script, one_torch_thread  # noqa: F401

J = load_script("train_vocabulary")


def _bytes(path):
    with gzip.open(path, "rb") as f:
        return f.read()


def test_same_descriptors_same_files(tmp_path, capsys):
    rng = np.random.default_rng(7)
    # words with structure (a few shared prototypes plus bit noise), as
    # real descriptors cluster
    proto = rng.integers(0, 2**32, (30, 8), dtype=np.uint64).astype(np.uint32)
    pdesc = proto[rng.integers(0, 30, 1500)] ^ (rng.random((1500, 8, 32)) < 0.05).dot(
        1 << np.arange(32, dtype=np.uint64)).astype(np.uint32)
    ldesc = rng.integers(0, 2**32, (400, 8), dtype=np.uint64).astype(np.uint32)
    got = T.train_and_save(pdesc, ldesc, str(tmp_path / "port"))
    os.makedirs(tmp_path / "jax")
    for name, desc in zip(T.NAMES, (pdesc, ldesc)):
        voc = J.V.train_vocabulary(desc, k=J.K, depth=J.DEPTH)
        J.V.save_dbow2_vocabulary(str(tmp_path / "jax" / name), voc)
    assert [os.path.basename(p) for p in got] == list(T.NAMES)
    for p in got:
        a, b = _bytes(p), _bytes(tmp_path / "jax" / os.path.basename(p))
        assert len(a) > 10000 and a == b
    assert "1000 words" in capsys.readouterr().out


def test_command_line_writes_loadable_vocabularies(tmp_path):
    paths = T.main([str(tmp_path), "--scenes", "1", "--frames", "2", "--device", "cpu"])
    for p in paths:
        voc = V.load_dbow2_vocabulary(p)
        assert voc.num_words == T.K ** T.DEPTH


def test_out_dir_is_required():
    with pytest.raises(SystemExit):
        T.main([])
