"""The VO slice end to end: plslam_tpu_torch.vo against plslam_tpu.vo.

- one fused step from the same (converted) VOState and the same detector
  outputs: pose to 1e-4;
- a 4-frame run at 188x120 on both sides: every frame tracks, and the
  port's ATE is within max(2x JAX's, 0.01 m) (end-to-end ATE is chaotic in
  the detected feature set, so this holds a floor, not equality);
- the port imports no jax, and CPU tensors never reach a kernel."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam_tpu import vo as jvo_mod
from plslam_tpu.core.camera import StereoCamera as JCam
from plslam_tpu.frontend.frame import FrontendConfig as JFcfg
from plslam_tpu.frontend.tracker import TrackerConfig as JTcfg
from plslam_tpu.io.synthetic import SyntheticScene, circular_trajectory
from plslam_tpu.io.trajectory import ate_rmse
from plslam_tpu_torch import convert, vo
from plslam_tpu_torch.core.camera import StereoCamera
from plslam_tpu_torch.frontend.frame import FrontendConfig
from plslam_tpu_torch.frontend.tracker import TrackerConfig
from plslam_tpu_torch.ops import cuda_fast, cuda_hamming, cuda_patches, fast, lines

from test_torch_helpers import SMALL_SCENE, t, to_np

N_POSES = 5   # initialize + 4 tracked frames
# test_vo_e2e's 188x120 camera with 200 points and 20 lines: its 80-point
# scene leaves 13-18 inliers a frame, where rounding decides whether a
# frame passes isGoodSolution (the JAX run itself loses one at fast_th=20)
SCENE = dict(SMALL_SCENE, n_points=200, n_lines=20)


@pytest.fixture(scope="module")
def sequence():
    scene = SyntheticScene(**SCENE)
    poses = circular_trajectory(N_POSES, step_t=0.05)
    frames = [scene.render_stereo(T, noise=1.0) for T in poses]
    return scene, poses, frames


@pytest.fixture(scope="module")
def jax_run(sequence):
    scene, poses, frames = sequence
    cam = JCam.create(scene.fx, scene.fy, scene.cx, scene.cy, scene.b,
                      width=scene.width, height=scene.height, dtype=jnp.float32)
    jv = jvo_mod.VisualOdometry(cam, JFcfg(n_points=128, n_lines=32), JTcfg())
    jv.initialize(*(jnp.asarray(x) for x in frames[0]))
    state0 = jv.state
    results = [jv.process(*(jnp.asarray(x) for x in f)) for f in frames[1:]]
    return jv, state0, results


def _port_vo(scene):
    cam = StereoCamera.create(scene.fx, scene.fy, scene.cx, scene.cy, scene.b,
                              width=scene.width, height=scene.height)
    return vo.VisualOdometry(cam, FrontendConfig(n_points=128, n_lines=32),
                             TrackerConfig(), device="cpu")


def test_fused_step_from_same_state_and_detections():
    """At test_vo_e2e's 376x240 configuration, where the pose solve is well
    conditioned (at 188x120 a frame has under 20 inliers and GN has not
    converged after its 5 + 10 trips, so rounding moves the pose by mm)."""
    scene = SyntheticScene(seed=3)
    frames = [scene.render_stereo(T) for T in circular_trajectory(2)]
    cam = JCam.create(scene.fx, scene.fy, scene.cx, scene.cy, scene.b,
                      width=scene.width, height=scene.height, dtype=jnp.float32)
    jv = jvo_mod.VisualOdometry(cam, JFcfg(n_points=512, n_lines=128, fast_th=15.0),
                                JTcfg())
    jv.initialize(*(jnp.asarray(x) for x in frames[0]))
    state0 = jv.state
    imgs = jnp.asarray(np.stack(frames[1]))
    kp, pdesc = jv._det_pts(imgs, state0.fast_th)
    seg, ldesc = jv._det_ls(imgs)
    want, wstate = jvo_mod._match_and_track((kp, pdesc), (seg, ldesc), state0, jv.cam,
                                            jv.fcfg, jv.tcfg, jv.params)

    pv = vo.VisualOdometry(
        StereoCamera.create(scene.fx, scene.fy, scene.cx, scene.cy, scene.b,
                            width=scene.width, height=scene.height),
        FrontendConfig(n_points=512, n_lines=128, fast_th=15.0), TrackerConfig(),
        device="cpu")
    state = convert.vo_state_from_numpy(to_np(state0), "cpu")
    tkp = fast.Keypoints(*(t(x) for x in to_np(kp)))
    tseg = lines.Segments(*(t(x) for x in to_np(seg)))
    got, gstate = vo.match_and_track((tkp, t(pdesc)), (tseg, t(ldesc)), state, pv.cam,
                                     pv.fcfg, pv.tcfg, pv.params)
    assert bool(want.good) and bool(got.good)
    assert int(want.n_inliers) >= 30
    assert int(got.n_inliers) == int(want.n_inliers)
    np.testing.assert_allclose(to_np(got.T_f_w), np.asarray(want.T_f_w), rtol=0, atol=1e-4)
    assert float(gstate.fast_th) == float(wstate.fast_th)
    assert bool(got.is_kf) == bool(want.is_kf)


def test_four_frame_run_against_jax(sequence, jax_run):
    scene, poses, frames = sequence
    _, _, jres = jax_run
    for fn in (cuda_patches.gather_patches_batch, cuda_fast.fast_score_nms_batch,
               cuda_hamming.hamming_distance_matrix_cuda):
        fn.launches = 0
    pv = _port_vo(scene)
    pv.initialize(*(torch.from_numpy(x) for x in frames[0]))
    tres = [pv.process(*(torch.from_numpy(x) for x in f)) for f in frames[1:]]
    assert all(bool(r.good) for r in jres), "JAX lost tracking"
    assert all(bool(r.good) for r in tres), [bool(r.good) for r in tres]
    gt = np.stack([p[:3, 3] for p in poses])
    ate_j = ate_rmse(np.stack([np.zeros(3)] + [np.asarray(r.T_f_w)[:3, 3] for r in jres]),
                     gt, align=False)
    ate_t = ate_rmse(np.stack([np.zeros(3)] + [to_np(r.T_f_w)[:3, 3] for r in tres]),
                     gt, align=False)
    print(f"ATE port {ate_t:.6f} m, JAX {ate_j:.6f} m")
    assert ate_t <= max(2.0 * ate_j, 0.01), (ate_t, ate_j)
    # CPU tensors take the plain versions: no kernel was launched
    assert cuda_patches.gather_patches_batch.launches == 0
    assert cuda_fast.fast_score_nms_batch.launches == 0
    assert cuda_hamming.hamming_distance_matrix_cuda.launches == 0


def test_port_imports_no_jax():
    code = ("import importlib, pkgutil, sys, plslam_tpu_torch\n"
            "for m in pkgutil.walk_packages(plslam_tpu_torch.__path__, 'plslam_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "import plslam_tpu_torch.vo\n"
            "assert 'jax' not in sys.modules, sorted(k for k in sys.modules if 'jax' in k)\n")
    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_wrappers_refuse_mixed_devices():
    """A wrapper never silently takes the plain path for a non-CPU tensor."""
    img = torch.zeros((1, 8, 8), device="meta")
    with pytest.raises(ValueError):
        cuda_patches.gather_patches_batch(img, torch.zeros((1, 2), dtype=torch.int32),
                                          torch.zeros((1, 2), dtype=torch.int32), 4)
    with pytest.raises(ValueError):
        cuda_fast.fast_score_nms_batch(img, torch.zeros(1))
    with pytest.raises(ValueError):
        cuda_hamming.hamming_distance_matrix_cuda(
            torch.zeros((2, 8), dtype=torch.int32, device="meta"),
            torch.zeros((2, 8), dtype=torch.int32))
