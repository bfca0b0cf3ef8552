"""RGB-D extraction: plslam_tpu_torch.frontend.rgbd against
plslam_tpu.frontend.rgbd on tests/test_rgbd.py's scene (seed 13, 376x240,
512 points, 64 line slots, fast_th 15, depth gate 0.3-30 m), the same
intensity and depth images into both packages on the CPU.

- points: valid and descriptors exactly, uv to 1e-4 px (the FAST
  tolerance of test_torch_detect_fullwidth.py: the two pyramids differ in
  the last bit, so a few sub-pixel offsets move by an ulp; here 3 of 512 by
  7.6e-6 px), disparity and 3D point to 1e-4 relative;
- lines: the detection tolerances of test_torch_detect_fullwidth.py (valid
  counts within 3, endpoints a median 0.02 px and at most 2% beyond 0.5 px
  from the nearest JAX segment);
- the depth stage alone, from the JAX package's own detections of the
  image: the depth gates exactly, disparities, 3D points and endpoints,
  image lines and Pluecker lines to 1e-5 relative (the segments' endpoints
  sit on depth edges, so end to end a 1e-3 px endpoint difference moves a
  disparity by 1.5e-4);
- the two-frame RGB-D track recovers the motion within 0.02 m, as
  test_rgbd.py holds the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam_tpu.core.camera import StereoCamera as JCam
from plslam_tpu.frontend import frame as jframe
from plslam_tpu.frontend.frame import FrontendConfig as JFcfg
from plslam_tpu.frontend.rgbd import extract_rgbd_features as jextract
from plslam_tpu.io.synthetic import SyntheticScene
from plslam_tpu_torch.core import lie
from plslam_tpu_torch.core.camera import StereoCamera
from plslam_tpu_torch.frontend import f2f, rgbd
from plslam_tpu_torch.frontend.frame import FrontendConfig
from plslam_tpu_torch.frontend.rgbd import extract_rgbd_features
from plslam_tpu_torch.frontend.tracker import TrackerConfig, optimize_pose
from plslam_tpu_torch.ops import cuda_fast, cuda_patches, fast, lines

from test_rgbd import render_depth
from test_torch_helpers import one_torch_thread, t, to_np  # noqa: F401

CFG = dict(n_points=512, n_lines=64, fast_th=15.0)
XI = np.asarray([0.02, -0.01, 0.1, 0.005, -0.008, 0.01])


@pytest.fixture(scope="module")
def frames():
    scene = SyntheticScene(seed=13)
    T1 = lie.exp_se3(torch.from_numpy(XI)).numpy()
    out = []
    for T in (np.eye(4), T1):
        il, _ = scene.render_stereo(T)
        out.append((il, render_depth(scene, T)))
    return scene, T1, out


def _cams(scene):
    args = (scene.fx, scene.fy, scene.cx, scene.cy, scene.b)
    kw = dict(width=scene.width, height=scene.height)
    return JCam.create(*args, **kw, dtype=jnp.float32), StereoCamera.create(*args, **kw)


@pytest.fixture(scope="module")
def both(frames):
    scene, _, fr = frames
    jcam, tcam = _cams(scene)
    ex = jax.jit(lambda im, dp: jextract(im, dp, jcam, JFcfg(**CFG), max_depth=30.0))
    il, d = fr[0]
    want = ex(jnp.asarray(il), jnp.asarray(d))
    got = extract_rgbd_features(t(il), t(d), tcam, FrontendConfig(**CFG), max_depth=30.0)
    return to_np(want), to_np(got)


def test_points_match_jax(both):
    want, got = both
    w, g = want.points, got.points
    np.testing.assert_allclose(g.uv, np.asarray(w.uv), rtol=0, atol=1e-4)
    assert (g.uv != np.asarray(w.uv)).any(-1).mean() <= 0.01
    np.testing.assert_array_equal(g.valid, np.asarray(w.valid))
    assert g.valid.sum() > 80
    np.testing.assert_allclose(g.disp, w.disp, rtol=1e-4)
    np.testing.assert_allclose(g.P, w.P, rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(g.desc.view(np.uint32), np.asarray(w.desc))


def test_lines_match_jax(both):
    want, got = both
    w, g = want.lines, got.lines
    assert abs(int(w.valid.sum()) - int(g.valid.sum())) <= 3
    seg_w = np.concatenate([w.sp, w.ep], -1)
    seg_g = np.concatenate([g.sp, g.ep], -1)
    d = np.abs(seg_g[:, None, :] - seg_w[None, :, :]).max(-1)   # (port, JAX) slots
    nearest, j = d.min(1), d.argmin(1)
    sel = np.asarray(g.valid)
    assert sel.sum() > 5
    assert np.median(nearest[sel]) <= 0.02
    assert (nearest[sel] > 0.5).mean() <= 0.02


def test_depth_stage_from_jax_detections(frames):
    scene, _, fr = frames
    jcam, tcam = _cams(scene)
    jcfg, tcfg = JFcfg(**CFG), FrontendConfig(**CFG)
    il, d = fr[0]
    (kp, desc), (seg, ldesc) = to_np(jax.jit(lambda im: (
        jframe._detect_describe_points(im, jcfg),
        jframe._detect_describe_lines(im, jcfg)))(jnp.asarray(il)))
    want = to_np(jax.jit(lambda im, dp: jextract(im, dp, jcam, jcfg, max_depth=30.0))(
        jnp.asarray(il), jnp.asarray(d)))
    points = rgbd.rgbd_points(fast.Keypoints(*(t(x) for x in kp)), t(desc), t(d), tcam,
                              0.3, 30.0)
    line_set = rgbd.rgbd_lines(lines.Segments(*(t(x) for x in seg)), t(ldesc), t(d), tcam,
                               tcfg, 0.3, 30.0)
    for got, w in ((to_np(points), want.points), (to_np(line_set), want.lines)):
        np.testing.assert_array_equal(got.valid, np.asarray(w.valid))
        assert got.valid.sum() > 20
        for k, v in w._asdict().items():
            if k not in ("valid", "desc"):
                np.testing.assert_allclose(getattr(got, k), np.asarray(v), rtol=1e-5,
                                           atol=1e-6, err_msg=k)


def test_rgbd_two_frame_tracking(frames):
    scene, T1, fr = frames
    _, tcam = _cams(scene)
    for fn in (cuda_fast.fast_score_nms_batch, cuda_patches.gather_patches_batch):
        fn.launches = 0
    f0, f1 = (extract_rgbd_features(t(il), t(d), tcam, FrontendConfig(**CFG), max_depth=30.0)
              for il, d in fr)
    assert int(f0.points.valid.sum()) > 80
    pts, ls, _, _ = f2f.track_frame_to_frame(f0, f1)
    est, _, _ = optimize_pose(pts, ls, tcam, TrackerConfig(use_lines=False))
    assert bool(est.good)
    err = np.abs(to_np(est.DT) - np.linalg.inv(T1))
    assert err[:3, 3].max() < 0.02, err
    # CPU tensors take the plain versions
    assert cuda_fast.fast_score_nms_batch.launches == 0
    assert cuda_patches.gather_patches_batch.launches == 0
