"""plslam_tpu_torch.bench_batch_vo (the port of scripts/bench_batch_vo.py)
on the CPU, at tests/test_batch_vo.py's size: 376x240 scenes (stream s
renders seed s with noise 1.0, as the JAX script's streams do), 512 point
and 128 line slots, fast_th 15; the sweep B in (1, 2), 1 warm-up and 3
timed frames.

- at B = 2 each stream equals single-stream ``VisualOdometry`` on its own
  frames to test_torch_batch_vo.py's bars: good flags, inlier counts and
  keyframe flags exactly, poses to 1e-4 m (the vmapped GN rounds apart
  from the single-stream one);
- at B = 2 against a JAX rendition of the script's ``bench_one``
  (plslam_tpu's BatchedVisualOdometry on the same frames): good flags
  equal, poses within 2e-2 m, inliers within +-6 (test_batch_vo.py's);
- every timed frame of every stream is good at every B, and CPU tensors
  launch no kernel;
- each JSON line carries exactly the JAX script's keys and metric name
  (read from its source text)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam_tpu import batch_vo as jbatch
from plslam_tpu.core.camera import StereoCamera as JCam
from plslam_tpu.frontend.frame import FrontendConfig as JFcfg
from plslam_tpu.frontend.tracker import TrackerConfig as JTcfg
from plslam_tpu.io.synthetic import SyntheticScene, circular_trajectory
from plslam_tpu_torch import bench, bench_batch_vo
from plslam_tpu_torch.frontend.frame import FrontendConfig
from plslam_tpu_torch.frontend.tracker import TrackerConfig
from plslam_tpu_torch.vo import VisualOdometry

from test_torch_helpers import assert_printed_like, json_literals, to_np
from test_torch_helpers import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = dict(n_points=300, n_lines=40, width=376, height=240, fx=217.6, fy=217.6, cx=183.7,
             cy=126.1)
WIDTHS = dict(n_points=512, n_lines=128, fast_th=15.0)
B_SWEEP = (1, 2)
N_WARMUP, N_FRAMES = 1, 3
N_POSES = 1 + N_WARMUP + N_FRAMES


@pytest.fixture(scope="module")
def streams():
    """Stream s: (left, right) numpy pairs of seed s."""
    out = []
    for s in range(max(B_SWEEP)):
        scene = SyntheticScene(seed=s, **SCENE)
        out.append([scene.render_stereo(T, noise=1.0)
                    for T in circular_trajectory(N_POSES, step_t=0.05)])
    return out


@pytest.fixture(scope="module")
def port(streams):
    return bench_batch_vo.run(streams, scene=dict(SCENE, seed=0), widths=WIDTHS,
                              b_sweep=B_SWEEP, n_warmup=N_WARMUP, n_frames=N_FRAMES,
                              device="cpu", say=print)


def _timed(results):
    return results[N_WARMUP:]


@pytest.fixture(scope="module")
def single(streams):
    """Each stream through single-stream VisualOdometry: its timed frames."""
    cam = bench.camera(SyntheticScene(seed=0, **SCENE))
    out = []
    for frames in streams:
        vo = VisualOdometry(cam, FrontendConfig(**WIDTHS), TrackerConfig(), device="cpu")
        vo.initialize(*(torch.from_numpy(x) for x in frames[0]))
        out.append(_timed([vo.process(*(torch.from_numpy(x) for x in f)) for f in frames[1:]]))
    return out


@pytest.fixture(scope="module")
def jax_b2(streams):
    """The JAX script's ``bench_one`` loop at B = 2: its timed results."""
    s = SyntheticScene(seed=0, **SCENE)
    cam = JCam.create(s.fx, s.fy, s.cx, s.cy, s.b, width=s.width, height=s.height)
    bvo = jbatch.BatchedVisualOdometry(2, cam, JFcfg(**WIDTHS), JTcfg())

    def stack(i, side):
        return jnp.stack([jnp.asarray(st[i][side]) for st in streams[:2]])

    bvo.initialize(stack(0, 0), stack(0, 1))
    out = [bvo.process(stack(i, 0), stack(i, 1)) for i in range(1, N_POSES)]
    _ = np.asarray(out[-1].err)
    return _timed(out)


def test_b2_streams_equal_single_stream_vo(port, single):
    for i, rb in enumerate(port["runs"][2]["results"]):
        for b in range(2):
            rs = single[b][i]
            assert bool(rb.good[b]) == bool(rs.good), (i, b)
            assert int(rb.n_inliers[b]) == int(rs.n_inliers), (i, b)
            assert bool(rb.is_kf[b]) == bool(rs.is_kf), (i, b)
            np.testing.assert_allclose(to_np(rb.T_f_w[b]), to_np(rs.T_f_w), rtol=0, atol=1e-4)


def test_b2_within_bars_of_jax(port, jax_b2):
    for rb, rj in zip(port["runs"][2]["results"], jax_b2):
        np.testing.assert_array_equal(to_np(rb.good), np.asarray(rj.good))
        np.testing.assert_allclose(to_np(rb.T_f_w), np.asarray(rj.T_f_w), rtol=0, atol=2e-2)
        assert np.abs(to_np(rb.n_inliers).astype(np.int64)
                      - np.asarray(rj.n_inliers, np.int64)).max() <= 6


def test_every_timed_frame_good_and_no_kernel_on_the_cpu(port):
    for B in B_SWEEP:
        r = port["runs"][B]
        assert r["good"].shape == (N_FRAMES, B) and r["good"].all(), B
        assert r["launches"] == dict.fromkeys(bench.KERNELS, 0.0)


def test_json_lines_have_the_jax_scripts_keys(port):
    lits = json_literals(os.path.join(ROOT, "scripts", "bench_batch_vo.py"))
    assert [ln["metric"] for ln in port["lines"]] == [f"batch_vo_frames_per_s_B{B}"
                                                      for B in B_SWEEP]
    for line in port["lines"]:
        assert_printed_like(line, lits)
    assert port["lines"][0]["per_stream_vs_single"] == 1.0
