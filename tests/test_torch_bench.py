"""plslam_tpu_torch.bench (the port of bench.py) on the CPU against a JAX
rendition of bench.py's loop built from plslam_tpu modules (bench.py's
``main`` hard-codes its 752x480 size).

The size: test_torch_vo.py's 188x120 scene (200 points, 20 lines), 128
point and 32 line slots; 1 warm-up frame and 3 timed frames in each of
bench.py's 3 windows (windows 2 and 3 re-initialize and re-warm).

- every frame's ``good`` is equal on both sides, in every window;
- in every window the port's ATE is within test_torch_vo.py's bar for a
  multi-frame run at this size, max(2x JAX's, 0.01 m) (at 188x120 a frame
  keeps under 20 inliers, where rounding moves a pose by millimetres, so
  the frames' poses are not held to the 1e-4 of one step from the same
  detections);
- the port's re-initialized windows repeat its first bit for bit;
- the JSON line carries exactly bench.py's keys and metric name (read
  from bench.py's source text), and CPU tensors launch no kernel."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from plslam_tpu import vo as jvo
from plslam_tpu.core.camera import StereoCamera as JCam
from plslam_tpu.frontend.frame import FrontendConfig as JFcfg
from plslam_tpu.frontend.tracker import TrackerConfig as JTcfg
from plslam_tpu.io.synthetic import SyntheticScene, circular_trajectory
from plslam_tpu.io.trajectory import ate_rmse
from plslam_tpu_torch import bench

from test_torch_helpers import SMALL_SCENE, assert_printed_like, json_literals, to_np
from test_torch_helpers import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = dict(SMALL_SCENE, n_points=200, n_lines=20)
WIDTHS = dict(n_points=128, n_lines=32)
N_WARMUP, N_FRAMES, WINDOWS = 1, 3, 3


@pytest.fixture(scope="module")
def frames():
    scene = SyntheticScene(**SCENE)
    return [scene.render_stereo(T, noise=1.0)
            for T in circular_trajectory(1 + N_WARMUP + N_FRAMES, step_t=0.05)]


@pytest.fixture(scope="module")
def port(frames):
    return bench.run(frames, scene=SCENE, widths=WIDTHS, n_warmup=N_WARMUP, n_frames=N_FRAMES,
                     windows=WINDOWS, device="cpu", say=print)


@pytest.fixture(scope="module")
def jax_windows(frames):
    """bench.py's main from its prewarm on: per window the timed frames'
    results."""
    s = SyntheticScene(**SCENE)
    cam = JCam.create(s.fx, s.fy, s.cx, s.cy, s.b, width=s.width, height=s.height)
    vo = jvo.VisualOdometry(cam, JFcfg(**WIDTHS), JTcfg())
    dev = [(jnp.asarray(il), jnp.asarray(ir)) for il, ir in frames]
    vo.prewarm(dev[0][0].shape, dev[0][0].dtype)
    out = []
    for w in range(WINDOWS):
        vo.initialize(*dev[0])
        for i in range(1, N_WARMUP + 1):
            res = vo.process(*dev[i])
        _ = float(res.err)
        out.append([vo.process(*dev[i]) for i in range(N_WARMUP + 1, N_WARMUP + 1 + N_FRAMES)])
        _ = float(out[-1][-1].err)
    return out


def test_good_frames_equal_jax(port, jax_windows):
    got = [[bool(r.good) for r in w] for w in port["results"]]
    want = [[bool(r.good) for r in w] for w in jax_windows]
    assert got == want
    assert port["good"] == sum(want[0]) == N_FRAMES


def test_poses_within_tolerance_of_jax(port, jax_windows):
    poses = circular_trajectory(1 + N_WARMUP + N_FRAMES, step_t=0.05)
    gt = np.stack([T[:3, 3] for T in poses[N_WARMUP + 1:]])
    for tw, jw in zip(port["results"], jax_windows):
        ate_t = ate_rmse(np.stack([to_np(r.T_f_w)[:3, 3] for r in tw]), gt, align=False)
        ate_j = ate_rmse(np.stack([np.asarray(r.T_f_w)[:3, 3] for r in jw]), gt, align=False)
        dT = max(float(np.abs(to_np(a.T_f_w) - np.asarray(b.T_f_w)).max()) for a, b in zip(tw, jw))
        print(f"ATE port {ate_t:.6f} m, JAX {ate_j:.6f} m; max |T_f_w diff| {dT:.3g}")
        assert ate_t <= max(2.0 * ate_j, 0.01), (ate_t, ate_j)


def test_reinitialized_windows_repeat_the_first(port):
    first = port["results"][0]
    for w in port["results"][1:]:
        for a, b in zip(w, first):
            for x, y in zip(a, b):
                assert np.array_equal(to_np(x), to_np(y))


def test_json_line_has_bench_py_keys(port):
    line = port["line"]
    assert_printed_like(line, json_literals(os.path.join(ROOT, "bench.py")))
    assert len(line["windows"]) == WINDOWS and line["value"] == max(line["windows"])
    assert line["vs_baseline"] == round(line["value"] / bench.BASELINE_FPS, 3)


def test_cpu_tensors_launch_no_kernel(port):
    assert port["launches"] == dict.fromkeys(bench.KERNELS, 0.0)
