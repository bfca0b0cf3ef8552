"""``plslam_tpu_torch.evaluate_ate`` against the JAX package's native tool
(``plslam_tpu/native/evaluate_ate.cpp``, built here with the Makefile's
flags into a temporary directory): the same ``n_pairs`` and an ATE within
1e-6 m of the tool's printed six decimals (its own rounding is 5e-7), with
and without ``--no-align`` and with ``--max-dt``; the port's printed line
has the tool's format."""

import json
import os
import shutil
import subprocess

import numpy as np
import pytest

from plslam_tpu_torch import evaluate_ate as A
from plslam_tpu_torch.io.trajectory import save_tum

SRC = os.path.join(os.path.dirname(__file__), "..", "plslam_tpu", "native", "evaluate_ate.cpp")


@pytest.fixture(scope="module")
def tool(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the native tool")
    out = str(tmp_path_factory.mktemp("native") / "evaluate_ate")
    subprocess.run(["g++", "-O3", "-march=native", "-std=c++17", "-Wall", SRC, "-o", out],
                   check=True)
    return out


def _traj(n, seed, drift=0.0):
    rng = np.random.default_rng(seed)
    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3, 3] = (np.cumsum(rng.normal(size=(n, 3)) * 0.1, axis=0)
                   + drift * np.arange(n)[:, None] * np.array([1, 0, 0]))
    return T


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tum")
    gt, est = _traj(60, 0), _traj(60, 0, drift=0.01)
    th = 0.3
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]])
    est[:, :3, 3] = est[:, :3, 3] @ R.T + np.array([1.0, -2.0, 0.5])
    t_gt = 0.05 * np.arange(60)
    # estimates at jittered times, some beyond 0.02 s of every ground truth
    t_est = t_gt + np.random.default_rng(3).uniform(-0.03, 0.03, 60)
    save_tum(str(d / "gt.txt"), t_gt, gt)
    save_tum(str(d / "est.txt"), t_est[::2], est[::2])
    return str(d / "est.txt"), str(d / "gt.txt")


@pytest.mark.parametrize("flags", [[], ["--no-align"], ["--max-dt", "0.01"],
                                   ["--max-dt", "0.025", "--no-align"]])
def test_matches_the_native_tool(tool, files, flags, capsys):
    want = json.loads(subprocess.run([tool, *files, *flags], capture_output=True, text=True,
                                     check=True).stdout)
    got = A.main([*files, *flags])
    printed = capsys.readouterr().out.strip()
    assert json.loads(printed) == pytest.approx(want, abs=1e-6)
    assert got["n_pairs"] == want["n_pairs"] > 5
    assert abs(got["ate_rmse"] - want["ate_rmse"]) <= 1e-6
    assert printed == f'{{"ate_rmse": {got["ate_rmse"]:.6f}, "n_pairs": {got["n_pairs"]}}}'


def test_reads_the_tools_formats(tmp_path):
    """Comments, commas, nanosecond times and 3x4 pose rows, as the tool."""
    p = tmp_path / "gt.csv"
    p.write_text("# header\n1403636579763555584,1.0,2.0,3.0,0,0,0,1\n\n"
                 "1403636579813555456,1.5,2.0,3.0,0,0,0,1\n")
    t, pos = A.read_tum(str(p))
    np.testing.assert_allclose(t, [1403636579.763555584, 1403636579.813555456])
    np.testing.assert_array_equal(pos, [[1.0, 2.0, 3.0], [1.5, 2.0, 3.0]])
    q = tmp_path / "poses.txt"
    q.write_text("1 0 0 4 0 1 0 5 0 0 1 6\n1 0 0 7 0 1 0 8 0 0 1 9\n")
    t, pos = A.read_tum(str(q))
    np.testing.assert_array_equal(t, [0.0, 1.0])
    np.testing.assert_array_equal(pos, [[4, 5, 6], [7, 8, 9]])


def test_too_few_pairs_exits_nonzero(tmp_path):
    save_tum(str(tmp_path / "a.txt"), [0.0, 1.0], _traj(2, 1))
    save_tum(str(tmp_path / "b.txt"), [5.0, 6.0], _traj(2, 1))
    with pytest.raises(SystemExit) as e:
        A.main([str(tmp_path / "a.txt"), str(tmp_path / "b.txt")])
    assert e.value.code == 1
