"""Checkpoints between the packages and the port's auto-checkpoint/resume.

A map with loop-closer state (endpoint lines, the shipped vocabularies)
saved by the JAX package loads into the port's MapHandler and LoopCloser
and the port's state then holds every array of the file (descriptor words
as bit views); the port continues the map exactly as the JAX package does.
The reverse direction too.  And the port's PLSLAM auto-checkpoints at
keyframe cadence and resumes from the newest file (the scale of
tests/test_checkpoint.py)."""

import os

import numpy as np
import pytest

from _map_fixtures import RingWorld, make_camera, render_ring_features
from plslam_tpu.backend import loop as jloop
from plslam_tpu.backend import mapping as jmap
from plslam_tpu.io import checkpoint as jckpt
from plslam_tpu.io.synthetic import SyntheticScene, circular_trajectory
from plslam_tpu.io.trajectory import ate_rmse
from plslam_tpu_torch.backend import loop as tloop
from plslam_tpu_torch.backend import mapping as tmap
from plslam_tpu_torch.config import PLSLAMConfig
from plslam_tpu_torch.convert import map_state_from_numpy, stereo_features_from_numpy
from plslam_tpu_torch.core.camera import StereoCamera
from plslam_tpu_torch.io import checkpoint as tckpt
from plslam_tpu_torch.pipeline import PLSLAM

from test_torch_helpers import one_torch_thread  # noqa: F401

JCAM = make_camera()
TCAM = StereoCamera.create(458.0, 457.0, 376.0, 240.0, 0.11, width=752, height=480)
CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")
VOC = dict(vocabulary_file=os.path.join(CONFIGS, "vocab_orb_k10L3.yml.gz"),
           vocabulary_file_l=os.path.join(CONFIGS, "vocab_lbd_k10L3.yml.gz"))
MAP_KW = dict(plucker_lines=False, ba_points=2048, ba_pobs=8192, ba_lobs=2048)
WORLD = RingWorld(n_pts=1500, n_ls=150)
POSES = [WORLD.pose_at(th) for th in np.arange(6) * 0.04]
FEATS = [render_ring_features(WORLD, T, JCAM) for T in POSES]


def _jax_pair():
    m = jmap.MapHandler(JCAM, jmap.MapConfig(**MAP_KW))
    return m, jloop.LoopCloser(JCAM, m, jloop.LoopConfig(**VOC))


def _port_pair():
    m = tmap.MapHandler(TCAM, tmap.MapConfig(**MAP_KW), device="cpu")
    return m, tloop.LoopCloser(TCAM, m, tloop.LoopConfig(**VOC))


def _build(pair, n, port):
    m, lc = pair
    for i in range(n):
        f = stereo_features_from_numpy(FEATS[i], "cpu") if port else FEATS[i]
        if i == 0:
            m.initialize(POSES[0], f)
        else:
            m.add_keyframe(POSES[i], f)
        lc.on_new_keyframe(i)
    m.flush_ba()
    return pair


def _file(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _assert_same_state(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.shape == y.shape, k
        if x.dtype == np.uint32 or y.dtype == np.uint32:
            assert x.dtype == y.dtype == np.uint32, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.fixture(scope="module")
def jax_saved(tmp_path_factory):
    pair = _build(_jax_pair(), 5, port=False)
    path = str(tmp_path_factory.mktemp("ckpt") / "jax_map.npz")
    jckpt.save_map(path, *pair)
    return pair, path


def test_jax_map_loads_into_port(jax_saved):
    (jm, jlc), path = jax_saved
    tm, tlc = _port_pair()
    tckpt.load_map(path, tm, loop_closer=tlc)
    _assert_same_state(tckpt.map_state(tm, tlc), _file(path))
    assert tlc.voc.num_words == 1000 and tlc.voc_l is not None
    assert tm.map.pt_desc.dtype == np.int32 and tm.map.keyframes[0].pt_desc.dtype == np.int32
    # convert.map_state_from_numpy takes the same state from a dict
    tm2, tlc2 = _port_pair()
    map_state_from_numpy(_file(path), tm2, tlc2)
    _assert_same_state(tckpt.map_state(tm2, tlc2), _file(path))
    # the port continues the JAX map as the JAX package does
    jm.add_keyframe(POSES[5], FEATS[5])
    tm.add_keyframe(POSES[5], stereo_features_from_numpy(FEATS[5], "cpu"))
    jlc.on_new_keyframe(5)
    tlc.on_new_keyframe(5)
    jm.flush_ba()
    tm.flush_ba()
    a, b = jm.map, tm.map
    for ta, tb in ((a.pobs, b.pobs), (a.lobs, b.lobs)):
        for f in ("valid", "lm", "kf", "fi"):
            np.testing.assert_array_equal(getattr(ta, f)[: ta.n], getattr(tb, f)[: tb.n])
    np.testing.assert_array_equal(a.covis, b.covis)
    np.testing.assert_allclose(np.stack([k.T_w_k for k in b.keyframes]),
                               np.stack([k.T_w_k for k in a.keyframes]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tlc.conf, jlc.conf, rtol=0, atol=1e-6)


def test_port_map_loads_into_jax(tmp_path):
    pair = _build(_port_pair(), 5, port=True)
    path = str(tmp_path / "port_map.npz")
    tckpt.save_map(path, *pair)
    want = _file(path)
    assert want["pt_desc"].dtype == np.uint32 and want["lc_voc_p_level0"].dtype == np.uint32
    jm, jlc = _jax_pair()
    jckpt.load_map(path, jm, loop_closer=jlc)
    back = str(tmp_path / "again.npz")
    jckpt.save_map(back, jm, loop_closer=jlc)
    _assert_same_state(_file(back), want)
    assert jlc.voc.num_words == 1000 and len(jlc.bow) == 5
    np.testing.assert_array_equal(jlc.conf, pair[1].conf)


def test_pipeline_autocheckpoint_and_resume(tmp_path):
    """Auto-checkpoint every 2 keyframes, resume the newest into a fresh
    pipeline, run the GBA, and keep tracking from the restored map."""
    scene = SyntheticScene(seed=5)
    cam = StereoCamera.create(scene.fx, scene.fy, scene.cx, scene.cy, scene.b,
                              width=scene.width, height=scene.height)
    cfg = PLSLAMConfig(orb_nfeatures=512, lsd_nfeatures=128, orb_fast_th=15,
                       min_entropy_ratio=0.99, multithread_slam=False, checkpoint_every_kf=2,
                       checkpoint_dir=str(tmp_path / "ckpt"))
    mc = tmap.MapConfig(local_ba_kf=8, ba_points=2048, ba_lines=256, ba_pobs=8192,
                        ba_lobs=2048)
    slam = PLSLAM(cam, cfg, mc, device="cpu")
    poses = circular_trajectory(8, step_t=0.12, step_r=0.015)
    for i, T in enumerate(poses[:6]):
        slam.process(*scene.render_stereo(T), timestamp=0.05 * i)
    slam.finish(run_gba=False)
    ckpts = sorted((tmp_path / "ckpt").glob("map_kf*.npz"))
    assert len(ckpts) >= 1
    newest = ckpts[-1]
    n_saved = int(newest.stem[len("map_kf"):])
    assert n_saved == int(_file(str(newest))["n_kf"])

    slam2 = PLSLAM(cam, PLSLAMConfig(orb_nfeatures=512, lsd_nfeatures=128, orb_fast_th=15,
                                     min_entropy_ratio=0.99, multithread_slam=False),
                   mc, device="cpu")
    slam2.load_checkpoint(str(newest))
    assert len(slam2.mapper.map.keyframes) == n_saved >= 2
    if n_saved >= 3:
        slam2.global_bundle_adjustment()
    # resume: the next frames extend the restored map from its last pose
    last = slam.kf_timestamps[n_saved - 1]
    start = int(round(last / 0.05))
    for i in range(start, len(poses)):
        slam2.process(*scene.render_stereo(poses[i]), timestamp=0.05 * i)
    traj = slam2.finish(run_gba=False)
    assert len(traj) > n_saved
    gt = np.stack([poses[int(round(t / 0.05))][:3, 3]
                   for t in slam.kf_timestamps[:n_saved] + slam2.kf_timestamps])
    est = np.stack([T[:3, 3] for T in traj])
    assert np.isfinite(est).all()
    assert ate_rmse(est, gt, align=True) < 0.05
