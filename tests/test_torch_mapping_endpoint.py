"""Endpoint-line mapping (``MapConfig(plucker_lines=False)``) and the
keyframe pose refinement (``has_refinement``) of
plslam_tpu_torch.backend.mapping against plslam_tpu.backend.mapping on the
same feature-level keyframes (tests/_map_fixtures): a lateral World
sequence and a RingWorld arc with the local BA on, then the chunked GBA.
Exact: observation tables, covisibility, per-keyframe landmark links,
landmark validity.  Within 1e-4 m (f32): keyframe poses, points and the
world line endpoints ``ls_epw``.  The capacity rules and the refinement
on drifted poses are in test_torch_mapping_endpoint_caps.py."""

import numpy as np
import pytest

from _map_fixtures import (RingWorld, World, lateral_poses, make_camera, render_features,
                           render_ring_features)
from plslam_tpu.backend import mapping as jmap
from plslam_tpu_torch.backend import mapping as tmap
from plslam_tpu_torch.convert import stereo_features_from_numpy
from plslam_tpu_torch.core.camera import StereoCamera

from test_torch_helpers import one_torch_thread  # noqa: F401

JCAM = make_camera()
TCAM = StereoCamera.create(458.0, 457.0, 376.0, 240.0, 0.11, width=752, height=480)
MAP_KW = dict(ba_points=2048, ba_pobs=8192, ba_lobs=2048, plucker_lines=False)
TOL = 1e-4


def _run(poses, feats, gba=True, **cfg_kw):
    kw = dict(MAP_KW, **cfg_kw)
    jm = jmap.MapHandler(JCAM, jmap.MapConfig(**kw))
    tm = tmap.MapHandler(TCAM, tmap.MapConfig(**kw), device="cpu")
    jm.initialize(poses[0], feats[0])
    tm.initialize(poses[0], stereo_features_from_numpy(feats[0], "cpu"))
    for T, f in zip(poses[1:], feats[1:]):
        jm.add_keyframe(T, f)
        tm.add_keyframe(T, stereo_features_from_numpy(f, "cpu"))
    jm.flush_ba()
    tm.flush_ba()
    _assert_same(jm, tm)
    if gba:
        jm.global_bundle_adjustment()
        tm.global_bundle_adjustment()
        _assert_same(jm, tm)
    return jm, tm


def _assert_same(jm, tm):
    a, b = jm.map, tm.map
    assert len(a.keyframes) == len(b.keyframes)
    np.testing.assert_array_equal(a.pt_valid, b.pt_valid)
    np.testing.assert_array_equal(a.ls_valid, b.ls_valid)
    for ta, tb in ((a.pobs, b.pobs), (a.lobs, b.lobs)):
        assert ta.n == tb.n
        for f in ("valid", "lm", "kf", "fi"):
            np.testing.assert_array_equal(getattr(ta, f)[: ta.n], getattr(tb, f)[: tb.n],
                                          err_msg=f)
    np.testing.assert_array_equal(a.covis, b.covis)
    for ka, kb in zip(a.keyframes, b.keyframes):
        np.testing.assert_array_equal(ka.pt_lm, kb.pt_lm)
        np.testing.assert_array_equal(ka.ls_lm, kb.ls_lm)
    Ta = np.stack([k.T_w_k for k in a.keyframes])
    Tb = np.stack([k.T_w_k for k in b.keyframes])
    np.testing.assert_allclose(Tb, Ta, rtol=0, atol=TOL)
    np.testing.assert_allclose(b.pt_w[b.pt_valid], a.pt_w[a.pt_valid], rtol=0, atol=TOL)
    np.testing.assert_allclose(b.ls_epw[b.ls_valid], a.ls_epw[a.ls_valid], rtol=0, atol=TOL)
    np.testing.assert_allclose(b.ls_w[b.ls_valid], a.ls_w[a.ls_valid], rtol=0, atol=10 * TOL)


def _lateral():
    world = World(n_pts=120, n_ls=12)
    poses = lateral_poses(5, 0.05)
    return poses, [render_features(world, T, JCAM) for T in poses]


def _ring(n=6):
    world = RingWorld(n_pts=1500, n_ls=150)
    poses = [world.pose_at(th) for th in np.arange(n) * 0.04]
    return poses, [render_ring_features(world, T, JCAM) for T in poses]


@pytest.mark.parametrize("scene", ["lateral", "ring"])
@pytest.mark.parametrize("refine", [False, True], ids=["fused", "has_refinement"])
def test_endpoint_mapping(scene, refine):
    poses, feats = _lateral() if scene == "lateral" else _ring()
    jm, tm = _run(poses, feats, has_refinement=refine)
    assert tm.n_local_ba_applied == len(poses) - 1
    mp = tm.map
    assert mp.ls_valid.sum() > 0
    # lines really were re-observed, so the endpoint rows had work to do
    assert int((mp.ls_nobs[mp.ls_valid] >= 2).sum()) > 3
    # the refreshed Pluecker form lies on the optimized endpoints
    L, ep = mp.ls_w[mp.ls_valid], mp.ls_epw[mp.ls_valid]
    np.testing.assert_allclose(np.cross(ep[:, 0], L[:, 3:]), L[:, :3], atol=1e-6)
