"""BatchedVisualOdometry(sharding=) in 2 gloo rank processes: B = 4 streams
(scenes seed 3, 8, 11, 17 at 376x240; 512 points, 128 line slots, fast_th
15, tests/test_batch_vo.py's configuration), each rank tracking its 2
streams over 2 frames, the result gathered on every rank:

- against the port's unsharded BatchedVisualOdometry(4): good flags and
  inlier counts equal, poses within 1e-4 m (the batched-vs-single bar; a
  rank's vmapped step runs at B = 2, whose batched products may round
  apart from B = 4's);
- against JAX's sharded run (2 devices) on the same frames:
  test_batch_vo.py's sharded-vs-unsharded bars (good equal, poses within
  5e-3 m, inliers within 3);
- a batch the world does not divide raises ValueError."""

import concurrent.futures
import os

import jax
import numpy as np
import pytest
import torch

from plslam_tpu.batch_vo import BatchedVisualOdometry as JBatch
from plslam_tpu.core.camera import StereoCamera as JCam
from plslam_tpu.frontend.frame import FrontendConfig as JFcfg
from plslam_tpu.frontend.tracker import TrackerConfig as JTcfg
from plslam_tpu.io.synthetic import SyntheticScene, circular_trajectory
from plslam_tpu_torch.batch_vo import BatchedVisualOdometry
from plslam_tpu_torch.core.camera import StereoCamera
from plslam_tpu_torch.frontend.frame import FrontendConfig
from plslam_tpu_torch.frontend.tracker import TrackerConfig
from plslam_tpu_torch.parallel.launch import launch

from test_torch_helpers import one_torch_thread  # noqa: F401

WORLD = 2
SEEDS = (3, 8, 11, 17)
N_FRAMES = 2
FCFG = dict(n_points=512, n_lines=128, fast_th=15.0)
TESTS = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def frames():
    """(F, B, H, W) float32 left and right stacks and the intrinsics."""
    scenes = [SyntheticScene(seed=s) for s in SEEDS]
    poses = circular_trajectory(N_FRAMES)
    pairs = [[sc.render_stereo(T) for T in poses] for sc in scenes]
    stack = lambda side: np.stack([np.stack([p[i][side] for p in pairs])  # noqa: E731
                                   for i in range(N_FRAMES)]).astype(np.float32)
    sc = scenes[0]
    return stack(0), stack(1), (sc.fx, sc.fy, sc.cx, sc.cy, sc.b)


@pytest.fixture(scope="module")
def runs(frames):
    """(every rank's outputs, the unsharded results): the launch waits on
    its ranks in a thread while this process runs the unsharded batch."""
    left, right, intr = frames
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch, "torch_dist_ranks:run_batch_vo_sharded", WORLD,
                            dict(left=left, right=right, intrinsics=list(intr), fcfg=FCFG),
                            timeout=240, pythonpath=(TESTS,), device_type="cpu")
        cam = StereoCamera.create(*intr, width=left.shape[-1], height=left.shape[-2])
        bvo = BatchedVisualOdometry(len(SEEDS), cam, FrontendConfig(**FCFG), TrackerConfig(),
                                    device="cpu")
        bvo.initialize(torch.from_numpy(left[0]), torch.from_numpy(right[0]))
        unsharded = [bvo.process(torch.from_numpy(left[i]), torch.from_numpy(right[i]))
                     for i in range(1, N_FRAMES)]
        return ranks.result(), unsharded


@pytest.fixture(scope="module")
def port_runs(runs):
    return runs[0]


@pytest.fixture(scope="module")
def unsharded(runs):
    return runs[1]


def test_sharded_matches_unsharded(port_runs, unsharded):
    got = port_runs[0]
    assert int(got["local_B"]) == len(SEEDS) // WORLD
    for i, want in enumerate(unsharded):
        np.testing.assert_array_equal(got["good"][i], want.good.numpy())
        assert got["good"][i].all()
        np.testing.assert_array_equal(got["n_inliers"][i], want.n_inliers.numpy())
        np.testing.assert_allclose(got["T_f_w"][i], want.T_f_w.numpy(), rtol=0, atol=1e-4)


def test_sharded_matches_jax_sharded(frames, port_runs):
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    left, right, intr = frames
    mesh = Mesh(np.asarray(jax.local_devices(backend="cpu")[:WORLD]), ("seq",))
    jcam = JCam.create(*intr, width=left.shape[-1], height=left.shape[-2])
    jb = JBatch(len(SEEDS), jcam, JFcfg(**FCFG), JTcfg(), sharding=NamedSharding(mesh, P("seq")))
    jb.initialize(left[0], right[0])
    got = port_runs[0]
    for i in range(1, N_FRAMES):
        want = jb.process(left[i], right[i])
        np.testing.assert_array_equal(got["good"][i - 1], np.asarray(want.good))
        np.testing.assert_allclose(got["T_f_w"][i - 1], np.asarray(want.T_f_w), rtol=0, atol=5e-3)
        assert np.abs(got["n_inliers"][i - 1].astype(np.int64)
                      - np.asarray(want.n_inliers, np.int64)).max() <= 3


def test_ragged_batch_raises(port_runs):
    for out in port_runs:
        assert bool(out["ragged_raises"])


def test_every_rank_holds_the_gathered_result(port_runs):
    for out in port_runs[1:]:
        for k in ("T_f_w", "good", "n_inliers"):
            np.testing.assert_array_equal(out[k], port_runs[0][k], err_msg=k)
