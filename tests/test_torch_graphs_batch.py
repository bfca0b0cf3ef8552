"""``BatchedVisualOdometry`` at B = 2 over static buffers on the CPU (the
function the card captures, ``plslam_tpu_torch.graphs``): it equals the
functional detection and vmapped step bit for bit across a masked
``mark_keyframe``; a JAX batch state assigned to ``state`` continues to the
JAX package's poses; what a frame hands out does not change when the next
frame runs.  376x240, 4 frames."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam_tpu import batch_vo as jbatch
from plslam_tpu.core.camera import StereoCamera as JCam
from plslam_tpu.frontend.frame import FrontendConfig as JFcfg
from plslam_tpu.frontend.tracker import TrackerConfig as JTcfg
from plslam_tpu.io.synthetic import SyntheticScene, circular_trajectory
from plslam_tpu_torch import convert, graphs
from plslam_tpu_torch.batch_vo import BatchedVisualOdometry
from plslam_tpu_torch.frontend.frame import FrontendConfig
from plslam_tpu_torch.frontend.tracker import TrackerConfig

from test_torch_helpers import (ate_within_jax, mark_keyframe_fn,  # noqa: F401
                                one_torch_thread, port_cam, results_equal, to_np,
                                tree_equal, tt)

N_FRAMES = 4
FCFG = dict(n_points=256, n_lines=64)
KF_AT = 1          # mark_keyframe of stream 1 after this frame


def _bstack(frames_by_stream, i, side):
    return tt(np.stack([fr[i][side] for fr in frames_by_stream]))


@pytest.fixture(scope="module")
def two_streams():
    out = []
    for seed in (3, 4):
        scene = SyntheticScene(seed=seed)
        out.append([scene.render_stereo(T, noise=1.0)
                    for T in circular_trajectory(N_FRAMES, step_t=0.05)])
    return SyntheticScene(seed=3), out


@pytest.fixture(scope="module")
def batch_run(two_streams):
    scene, fr = two_streams
    bvo = BatchedVisualOdometry(2, port_cam(scene), FrontendConfig(**FCFG), TrackerConfig(),
                                device="cpu")
    bvo.initialize(_bstack(fr, 0, 0), _bstack(fr, 0, 1))
    state0 = bvo.state
    results, feats, kept = [], [], []
    for i in range(1, N_FRAMES):
        r = bvo.process(_bstack(fr, i, 0), _bstack(fr, i, 1))
        f = bvo.current_features
        results.append(r)
        feats.append(f)
        kept.append((graphs.tree_clone(r), graphs.tree_clone(f)))
        if i == KF_AT:
            bvo.mark_keyframe(np.array([False, True]))
    return bvo, state0, results, feats, kept


def test_static_batch_equals_the_functional_step(two_streams, batch_run):
    _, fr = two_streams
    bvo, state, results, _, _ = batch_run
    for i in range(1, N_FRAMES):
        flat = torch.stack([_bstack(fr, i, 0), _bstack(fr, i, 1)], dim=1).reshape(
            (4,) + fr[0][0][0].shape)
        want, state = bvo._step(*bvo._detect(flat, state.fast_th), state)
        assert results_equal(results[i - 1], want), i
        if i == KF_AT:
            m = torch.tensor([False, True])
            state = state._replace(**{
                k: torch.where(m.reshape((-1,) + (1,) * (v.dim() - 1)), getattr(mark_keyframe_fn(state), k), v)
                for k, v in state._asdict().items() if k != "features"})
    assert tree_equal(bvo.state, state)
    assert bool(torch.stack([r.good for r in results]).all())


def test_batch_results_and_features_are_not_aliased(batch_run):
    _, _, results, feats, kept = batch_run
    for r, f, (r0, f0) in zip(results, feats, kept):
        assert results_equal(r, r0)
        assert tree_equal(f, f0)
    assert batch_run[0].frame_scalars.shape == (2, 21)


def test_jax_batch_state_continues_to_the_jax_poses(two_streams):
    """The JAX batch's state after frame 1, converted and assigned, tracks
    frames 2-4 of each stream as the JAX batch does (the same bar)."""
    scene, fr = two_streams
    jcam = JCam.create(scene.fx, scene.fy, scene.cx, scene.cy, scene.b,
                       width=scene.width, height=scene.height, dtype=jnp.float32)
    jb = jbatch.BatchedVisualOdometry(2, jcam, JFcfg(**FCFG), JTcfg())

    def stack(i, side):
        return np.stack([f[i][side] for f in fr])

    jb.initialize(stack(0, 0), stack(0, 1))
    jb.process(stack(1, 0), stack(1, 1))
    bvo = BatchedVisualOdometry(2, port_cam(scene), FrontendConfig(**FCFG), TrackerConfig(),
                                device="cpu")
    bvo.state = convert.batch_vo_state_from_numpy(to_np(jb.state), "cpu")
    got, want = [], []
    for i in range(2, N_FRAMES):
        want.append(jb.process(stack(i, 0), stack(i, 1)))
        got.append(bvo.process(tt(stack(i, 0)), tt(stack(i, 1))))
        np.testing.assert_array_equal(to_np(got[-1].good), np.asarray(want[-1].good))
    poses = circular_trajectory(N_FRAMES, step_t=0.05)[2:]
    for b in range(2):
        ate_within_jax([r.T_f_w[b] for r in got], [r.T_f_w[b] for r in want], poses)
