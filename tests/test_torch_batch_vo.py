"""Batched multi-stream VO: plslam_tpu_torch.batch_vo against plslam_tpu.batch_vo
and against the port's own single-stream VisualOdometry, at
tests/test_batch_vo.py's configuration (scenes seed 3 and 8, 376x240, 512
points, 128 line slots, fast_th 15, 4 frames).

- port batch vs port single stream: the flat (2B, H, W) detection and the
  stereo matching are bit-identical; the tracked poses agree to 1e-4 m, good
  flags and inlier counts exactly.  Not bit for bit: under vmap the GN's
  Gram and solves run as batched products, which round differently from the
  single-stream ones (measured: <= 6e-6 m on an x86-64 CPU);
- port batch vs JAX batch: good equal, poses within 2e-2 m, inliers within
  +-6 (test_batch_vo.py's tolerances: score ties break per machine);
- one step from the JAX batch's own state and detections, converted: poses
  to 1e-4 m;
- mark_keyframe(mask) resets only the masked streams, sharding= raises, and
  no op of the step drops into functorch's per-example fallback."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam_tpu import batch_vo as jbatch
from plslam_tpu.core.camera import StereoCamera as JCam
from plslam_tpu.frontend.frame import FrontendConfig as JFcfg
from plslam_tpu.frontend.tracker import TrackerConfig as JTcfg
from plslam_tpu.io.synthetic import SyntheticScene, circular_trajectory
from plslam_tpu_torch import convert
from plslam_tpu_torch.batch_vo import BatchedVisualOdometry
from plslam_tpu_torch.core.camera import StereoCamera
from plslam_tpu_torch.frontend.frame import FrontendConfig
from plslam_tpu_torch.frontend.tracker import TrackerConfig
from plslam_tpu_torch.ops import fast, lines
from plslam_tpu_torch.vo import VisualOdometry

from test_torch_helpers import one_torch_thread, t, to_np  # noqa: F401

N_FRAMES = 4
SEEDS = (3, 8)
FCFG = dict(n_points=512, n_lines=128, fast_th=15.0)
FALLBACK = "There is a performance drop"


def _stack(frames, i, side):
    return np.stack([fr[i][side] for fr in frames])


@pytest.fixture(scope="module")
def scenes():
    out = []
    for s in SEEDS:
        scene = SyntheticScene(seed=s)
        out.append((scene, [scene.render_stereo(T) for T in circular_trajectory(N_FRAMES)]))
    return out


@pytest.fixture(scope="module")
def cam(scenes):
    sc = scenes[0][0]
    return StereoCamera.create(sc.fx, sc.fy, sc.cx, sc.cy, sc.b, width=sc.width,
                               height=sc.height)


def _port_batch(cam):
    return BatchedVisualOdometry(len(SEEDS), cam, FrontendConfig(**FCFG), TrackerConfig(),
                                 device="cpu")


@pytest.fixture(scope="module")
def port_runs(scenes, cam):
    """(single-stream results, single-stream initial features, batched
    results, batch initial features)."""
    frames = [fr for _, fr in scenes]
    single, init = [], []
    for fr in frames:
        vo = VisualOdometry(cam, FrontendConfig(**FCFG), TrackerConfig(), device="cpu")
        init.append(vo.initialize(*(torch.from_numpy(x) for x in fr[0])))
        single.append([vo.process(*(torch.from_numpy(x) for x in f)) for f in fr[1:]])
    bvo = _port_batch(cam)
    feats = bvo.initialize(t(_stack(frames, 0, 0)), t(_stack(frames, 0, 1)))
    batched = [bvo.process(t(_stack(frames, i, 0)), t(_stack(frames, i, 1)))
               for i in range(1, N_FRAMES)]
    return single, init, batched, feats


@pytest.fixture(scope="module")
def jax_run(scenes):
    sc = scenes[0][0]
    jcam = JCam.create(sc.fx, sc.fy, sc.cx, sc.cy, sc.b, width=sc.width, height=sc.height,
                       dtype=jnp.float32)
    frames = [fr for _, fr in scenes]
    jb = jbatch.BatchedVisualOdometry(len(SEEDS), jcam, JFcfg(**FCFG), JTcfg())
    jb.initialize(_stack(frames, 0, 0), _stack(frames, 0, 1))
    state0 = jb.state
    res = [jb.process(_stack(frames, i, 0), _stack(frames, i, 1)) for i in range(1, N_FRAMES)]
    return jb, state0, res


def test_no_vmap_fallback(scenes, cam):
    """functorch's fallback warning, turned on and into an error, over an
    initialize and a step of the batch."""
    from torch._C import _functorch

    frames = [fr for _, fr in scenes]
    _functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message=FALLBACK)
            bvo = _port_batch(cam)
            bvo.initialize(t(_stack(frames, 0, 0)), t(_stack(frames, 0, 1)))
            res = bvo.process(t(_stack(frames, 1, 0)), t(_stack(frames, 1, 1)))
    finally:
        _functorch._set_vmap_fallback_warning_enabled(False)
    assert bool(res.good.all())


def test_batched_detection_is_single_stream_detection(port_runs):
    """The flat (2B, H, W) detection and the vmapped stereo match give each
    stream exactly its single-stream features."""
    _, init, _, feats = port_runs
    for b, want in enumerate(init):
        for side in ("points", "lines"):
            for k, w in getattr(want, side)._asdict().items():
                got = getattr(getattr(feats, side), k)[b]
                assert torch.equal(got, w), (b, side, k)


def test_batch_matches_single_stream(port_runs):
    single, _, batched, _ = port_runs
    for i, rb in enumerate(batched):
        for b in range(len(SEEDS)):
            rs = single[b][i]
            assert bool(rb.good[b]) == bool(rs.good), (i, b)
            assert int(rb.n_inliers[b]) == int(rs.n_inliers), (i, b)
            np.testing.assert_allclose(to_np(rb.T_f_w[b]), to_np(rs.T_f_w), rtol=0, atol=1e-4)
            assert bool(rb.is_kf[b]) == bool(rs.is_kf)


def test_batch_matches_jax_batch(port_runs, jax_run):
    _, _, batched, _ = port_runs
    _, _, jres = jax_run
    for rb, rj in zip(batched, jres):
        np.testing.assert_array_equal(to_np(rb.good), np.asarray(rj.good))
        assert bool(rb.good.all())
        np.testing.assert_allclose(to_np(rb.T_f_w), np.asarray(rj.T_f_w), rtol=0, atol=2e-2)
        assert np.abs(to_np(rb.n_inliers).astype(np.int64)
                      - np.asarray(rj.n_inliers, np.int64)).max() <= 6


def test_step_from_the_jax_batch_state(scenes, cam, jax_run):
    """Both sides start from one state: the JAX batch's state after
    initialize and its detections of frame 1, converted, through the port's
    vmapped step."""
    jb, state0, jres = jax_run
    frames = [fr for _, fr in scenes]
    imgs = jnp.stack([jnp.asarray(_stack(frames, 1, 0)), jnp.asarray(_stack(frames, 1, 1))],
                     axis=1)
    kp_pair, seg_pair = jb._detect(imgs, state0.fast_th)
    state = convert.batch_vo_state_from_numpy(to_np(state0), "cpu")
    assert state.T_f_w.shape == (2, 4, 4) and state.fast_th.dtype == torch.float32
    kp, pdesc = kp_pair
    seg, ldesc = seg_pair
    bvo = _port_batch(cam)
    got, gstate = bvo._step((fast.Keypoints(*(t(x) for x in to_np(kp))), t(pdesc)),
                            (lines.Segments(*(t(x) for x in to_np(seg))), t(ldesc)), state)
    want = jres[0]
    np.testing.assert_array_equal(to_np(got.good), np.asarray(want.good))
    np.testing.assert_array_equal(to_np(got.n_inliers), np.asarray(want.n_inliers))
    np.testing.assert_allclose(to_np(got.T_f_w), np.asarray(want.T_f_w), rtol=0, atol=1e-4)
    assert gstate.fast_th.shape == (2,) and (gstate.frames_since_kf == 1).all()


def test_batch_state_rejects_ragged_streams(jax_run):
    _, state0, _ = jax_run
    st = to_np(state0)._replace(fast_th=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="stream axis"):
        convert.batch_vo_state_from_numpy(st, "cpu")


def test_mark_keyframe_resets_only_masked_streams(scenes, cam):
    frames = [fr for _, fr in scenes]
    bvo = _port_batch(cam)
    bvo.initialize(t(_stack(frames, 0, 0)), t(_stack(frames, 0, 1)))
    bvo.process(t(_stack(frames, 1, 0)), t(_stack(frames, 1, 1)))
    before = bvo.state
    assert (before.frames_since_kf == 1).all() and not before.prev_was_kf.any()
    bvo.mark_keyframe(np.array([False, True]))
    after = bvo.state
    assert after.frames_since_kf.tolist() == [1, 0]
    assert after.prev_was_kf.tolist() == [False, True]
    assert torch.equal(after.T_prevKF[1], before.T_f_w[1])
    assert torch.equal(after.T_prevKF[0], before.T_prevKF[0])
    assert torch.equal(after.cov_prevKF_accum[0], before.cov_prevKF_accum[0])
    assert not after.cov_prevKF_accum[1].any()
    with pytest.raises(ValueError):
        bvo.mark_keyframe([True])


def test_sharding_raises(cam):
    with pytest.raises(NotImplementedError, match="distribution"):
        BatchedVisualOdometry(2, cam, sharding=object(), device="cpu")


def test_entry_point_defaults_to_the_card(cam):
    bvo = BatchedVisualOdometry(2, cam)
    assert bvo.device.type == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="must be on cuda"):
            bvo.initialize(torch.zeros(2, 120, 188), torch.zeros(2, 120, 188))
