"""plslam_tpu_torch.bench_slam (the port of bench_slam.py) on the CPU
against the JAX package.

- ``make_ba_problem_np`` draws tests/test_ba.make_problem's numbers, bit
  for bit, at bench_slam.py's K=8, P=512, L=64, and ``local_ba_problem``
  equals make_problem cast to f32 bit for bit, field by field (index
  fields by value: int64 on the port, int32 in JAX);
- ``lm_rounds`` with bench_slam.py's 10 trips: on the same problem in f64,
  solved with test_torch_ba.py's camera (intrinsics exact in f32, so the
  port's f32 line-projection matrix equals JAX's f64 one), the port's cost
  is within test_torch_ba.py's 1e-8 relative of JAX's; in
  f32 (the benchmark's dtype) both end under 1e-3 of the start, the bar
  chip_smoke.py holds the card to, and ``bench_ba_iters`` reports that cost;
- the SLAM loop (``bench_slam``) at a small size, test_torch_bench.py's
  188x120 scene with 128 point and 32 line slots, 2 warm-up and 3 timed
  frames, bench_slam.py's MapConfig: the keyframe count equals that of a
  JAX rendition of bench_slam.py's loop (plslam_tpu's PLSLAM), and every
  frame is good on both sides;
- both JSON lines carry exactly bench_slam.py's keys and metric names
  (read from its source text)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from plslam_tpu.backend import ba as jba
from plslam_tpu.backend.mapping import MapConfig as JMapConfig
from plslam_tpu.config import PLSLAMConfig as JConfig
from plslam_tpu.core.camera import StereoCamera as JCam
from plslam_tpu.io.synthetic import SyntheticScene, circular_trajectory
from plslam_tpu.pipeline import PLSLAM as JSLAM
from plslam_tpu_torch import bench_slam
from plslam_tpu_torch.backend import ba
from plslam_tpu_torch.convert import ba_problem_from_numpy
from plslam_tpu_torch.core.camera import StereoCamera

from test_ba import make_problem
from test_torch_ba import INTR
from test_torch_helpers import SMALL_SCENE, assert_printed_like, json_literals, to_np
from test_torch_helpers import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = dict(SMALL_SCENE, n_points=200, n_lines=20)
CONFIG = dict(bench_slam.CONFIG, orb_nfeatures=128, lsd_nfeatures=32)
N_WARMUP, N_FRAMES = 2, 3


@pytest.fixture(scope="module")
def jax_problem():
    prob, _, Pw, Lw = make_problem(**bench_slam.BA_SIZE)
    return prob, Pw, Lw


def _f32(prob):
    return jax.tree.map(lambda x: x.astype(jnp.float32) if x.dtype == jnp.float64 else x, prob)


def test_draws_equal_make_problem(jax_problem):
    prob, Pw, _ = jax_problem
    d = bench_slam.make_ba_problem_np(**bench_slam.BA_SIZE)
    np.testing.assert_array_equal(d["Pw"], np.asarray(Pw))
    np.testing.assert_array_equal(d["Pw"] + d["pert_P"], np.asarray(prob.points))


def test_local_ba_problem_equals_make_problem_in_f32(jax_problem):
    want = _f32(jax_problem[0])
    got = bench_slam.local_ba_problem("cpu", **bench_slam.BA_SIZE)
    for f in got._fields:
        a, b = to_np(getattr(got, f)), np.asarray(getattr(want, f))
        if a.dtype.kind == "i":
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_lm_rounds_cost_within_tolerance_of_jax_in_f64(jax_problem):
    prob = jax_problem[0]
    jcam = JCam.create(*INTR, dtype=jnp.float64)
    _, jcost = jax.jit(lambda p: jba.lm_rounds(p, jcam, jba.BAConfig(), p.p_valid, p.l_valid,
                                               bench_slam.LM_ITERS))(prob)
    tp = ba_problem_from_numpy(jax.tree.map(np.asarray, prob), "cpu")
    _, tcost, _ = ba.lm_rounds(tp, StereoCamera.create(*INTR), ba.BAConfig(), tp.p_valid,
                               tp.l_valid, bench_slam.LM_ITERS)
    np.testing.assert_allclose(float(tcost), float(jcost), rtol=1e-8, atol=1e-18)


def test_lm_rounds_converges_in_f32_on_both_sides(jax_problem):
    jcam = JCam.create(*bench_slam.LBA_CAM, dtype=jnp.float32)
    _, jcost = jax.jit(lambda p: jba.lm_rounds(p, jcam, jba.BAConfig(), p.p_valid, p.l_valid,
                                               bench_slam.LM_ITERS))(_f32(jax_problem[0]))
    got = bench_slam.bench_ba_iters(reps=1, device="cpu")
    print(f"f32 LM cost {got['cost0']:.6g} -> port {got['cost']:.6g}, JAX {float(jcost):.6g}")
    assert np.isfinite(got["cost"]) and got["cost"] < 1e-3 * got["cost0"]
    assert np.isfinite(float(jcost)) and float(jcost) < 1e-3 * got["cost0"]
    assert got["iters_per_s"] > 0


@pytest.fixture(scope="module")
def frames():
    scene = SyntheticScene(**SCENE)
    return [scene.render_stereo(T, noise=1.0)
            for T in circular_trajectory(N_WARMUP + N_FRAMES, step_t=0.05)]


@pytest.fixture(scope="module")
def port_slam(frames):
    return bench_slam.bench_slam(frames, scene=SCENE, config=CONFIG, n_warmup=N_WARMUP,
                                 n_frames=N_FRAMES, device="cpu")


@pytest.fixture(scope="module")
def jax_slam(frames):
    """bench_slam.py's ``bench_slam`` loop on the same frames and configs."""
    s = SyntheticScene(**SCENE)
    cam = JCam.create(s.fx, s.fy, s.cx, s.cy, s.b, width=s.width, height=s.height)
    slam = JSLAM(cam, JConfig(**CONFIG), JMapConfig(**bench_slam.MAP_CONFIG))
    dev = [(jnp.asarray(il), jnp.asarray(ir)) for il, ir in frames]
    for i in range(N_WARMUP):
        slam.process(*dev[i], timestamp=0.05 * i)
    slam.wait_until_idle()
    for i in range(N_WARMUP, N_WARMUP + N_FRAMES):
        slam.process(*dev[i], timestamp=0.05 * i)
    slam.wait_until_idle()
    n_kf = len(slam.mapper.map.keyframes)
    good = [lg.good for lg in slam.logs]
    slam.finish(run_gba=False)
    return n_kf, good


def test_keyframes_equal_jax(port_slam, jax_slam):
    n_kf, good = jax_slam
    print(f"keyframes: port {port_slam['n_kf']}, JAX {n_kf}")
    assert port_slam["n_kf"] == n_kf >= 3
    assert port_slam["good"] == good and all(good)
    assert port_slam["fps"] > 0


def test_json_lines_have_bench_slam_py_keys(port_slam):
    lits = json_literals(os.path.join(ROOT, "bench_slam.py"))
    lines = bench_slam.json_lines(port_slam["fps"], 1.0)
    assert [ln["metric"] for ln in lines] == ["full_slam_frames_per_s",
                                              "local_ba_lm_iterations_per_s"]
    for line in lines:
        assert_printed_like(line, lits)
