"""plslam_tpu_torch.backend.mapping against plslam_tpu.backend.mapping on
the same feature-level keyframes (tests/_map_fixtures): a lateral World
sequence and a RingWorld arc, where feature slots change per keyframe and
Map2KF re-observes landmarks, go through both MapHandlers with the local
BA on.  Exact: keyframe count, landmark validity, the observation tables
(kf, lm, fi), covisibility, the local keyframe set.  Within 1e-4 (m; f32):
keyframe poses, points and line directions after the local BAs and after
the global BA; line positions within 5e-4 m (see _assert_same_geometry).
Also the split association, the divergence guard and descriptor
re-election."""

import dataclasses
import logging

import numpy as np
import pytest

from _map_fixtures import (RingWorld, World, lateral_poses, make_camera, render_features,
                           render_ring_features)
from plslam_tpu.backend import mapping as jmap
from plslam_tpu_torch.backend import mapping as tmap
from plslam_tpu_torch.convert import stereo_features_from_numpy, stereo_features_to_numpy
from plslam_tpu_torch.core.camera import StereoCamera

from test_torch_helpers import one_torch_thread  # noqa: F401

JCAM = make_camera()
TCAM = StereoCamera.create(458.0, 457.0, 376.0, 240.0, 0.11, width=752, height=480)
MAP_KW = dict(ba_points=2048, ba_pobs=8192, ba_lobs=2048)
POS_TOL = 1e-4
LINE_TOL = 5e-4


def _tfeat(feats):
    return stereo_features_from_numpy(feats, "cpu")


def _pair(**cfg_kw):
    return (jmap.MapHandler(JCAM, jmap.MapConfig(**MAP_KW, **cfg_kw)),
            tmap.MapHandler(TCAM, tmap.MapConfig(**MAP_KW, **cfg_kw), device="cpu"))


def _feed(pair, poses, feats, run_ba=True):
    jm, tm = pair
    jm.initialize(poses[0], feats[0])
    tm.initialize(poses[0], _tfeat(feats[0]))
    for T, f in zip(poses[1:], feats[1:]):
        jm.add_keyframe(T, f, run_ba=run_ba)
        tm.add_keyframe(T, _tfeat(f), run_ba=run_ba)
    jm.flush_ba()
    tm.flush_ba()


def _assert_same_topology(jm, tm):
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
    np.testing.assert_array_equal(a.pt_desc.view(np.int32), b.pt_desc)
    np.testing.assert_array_equal(a.local_kf_set(), b.local_kf_set())
    for ka, kb in zip(a.keyframes, b.keyframes):
        np.testing.assert_array_equal(ka.pt_lm, kb.pt_lm)
        np.testing.assert_array_equal(ka.ls_lm, kb.ls_lm)


def _assert_same_geometry(jm, tm, tol=POS_TOL):
    a, b = jm.map, tm.map
    Ta = np.stack([k.T_w_k for k in a.keyframes])
    Tb = np.stack([k.T_w_k for k in b.keyframes])
    np.testing.assert_allclose(Tb, Ta, rtol=0, atol=tol)
    np.testing.assert_allclose(b.pt_w[b.pt_valid], a.pt_w[a.pt_valid], rtol=0, atol=tol)
    # lines: unit direction, and the distance (m) of the JAX package's
    # snapped endpoints to the port's line.  The JAX package's own f32
    # error is larger here than the port's (its orth maps compute cos as a
    # shifted sin): on the ring map, JAX f32 lies 2.7e-4 m and the port
    # f32 8.1e-5 m from the port's float64 solve, so the distance bound is
    # LINE_TOL.
    La, Lb = a.ls_w[a.ls_valid], b.ls_w[b.ls_valid]
    np.testing.assert_allclose(Lb[:, 3:], La[:, 3:], rtol=0, atol=tol)
    x = a.ls_epw[a.ls_valid]                                  # (n, 2, 3)
    dist = np.linalg.norm(np.cross(x, Lb[:, None, 3:]) - Lb[:, None, :3], axis=-1)
    assert dist.max() < LINE_TOL, dist.max()


@pytest.fixture(scope="module")
def lateral():
    world = World(n_pts=120, n_ls=12)
    poses = lateral_poses(5, 0.05)
    pair = _pair()
    _feed(pair, poses, [render_features(world, T, JCAM) for T in poses])
    return pair


@pytest.fixture(scope="module")
def ring():
    world = RingWorld(n_pts=1500, n_ls=150)
    poses = [world.pose_at(th) for th in np.arange(6) * 0.04]
    pair = _pair()
    _feed(pair, poses, [render_ring_features(world, T, JCAM) for T in poses])
    return pair


def test_lateral_local_ba(lateral):
    jm, tm = lateral
    assert tm.n_local_ba_applied == len(tm.map.keyframes) - 1
    _assert_same_topology(jm, tm)
    _assert_same_geometry(jm, tm)


def test_ring_map2kf_reobservation(ring):
    jm, tm = ring
    _assert_same_topology(jm, tm)
    _assert_same_geometry(jm, tm)
    # a landmark seen by two keyframes that are not neighbours was
    # re-observed through Map2KF (KF2KF links only consecutive keyframes)
    tb = tm.map.pobs
    live = tb.valid[: tb.n]
    lm, kf = tb.lm[: tb.n][live], tb.kf[: tb.n][live]
    span = np.zeros(tm.map.n_pt, np.int64)
    lo = np.full(tm.map.n_pt, 1 << 30)
    np.maximum.at(span, lm, kf)
    np.minimum.at(lo, lm, kf)
    assert ((span - lo) >= 2).sum() > 20


@pytest.mark.parametrize("scene", ["lateral", "ring"])
def test_global_ba(scene, request):
    jm, tm = request.getfixturevalue(scene)
    jm.global_bundle_adjustment()
    tm.global_bundle_adjustment()
    _assert_same_topology(jm, tm)
    _assert_same_geometry(jm, tm)


def test_split_association():
    """_match_kf2kf + _match_map2kf (the host-gated split association) on
    both sides from the same map."""
    world = World(n_pts=120, n_ls=12)
    poses = lateral_poses(4, 0.05)
    feats = [render_features(world, T, JCAM) for T in poses]
    jm, tm = pair = _pair()
    _feed(pair, poses[:3], feats[:3], run_ba=False)
    for m, f in ((jm, feats[3]), (tm, _tfeat(feats[3]))):
        cls = jmap.KeyframeRecord if m is jm else tmap.KeyframeRecord
        kf = cls(len(m.map.keyframes), poses[3], f)
        m.map.keyframes.append(kf)
        m.map.expand_graphs()
        m._match_kf2kf(kf)
        m._match_map2kf(kf)
        m._spawn_landmarks(kf)
    _assert_same_topology(jm, tm)


def test_divergence_guard(caplog):
    world = World(n_pts=120, n_ls=12)
    poses = lateral_poses(5, 0.05)
    tm = tmap.MapHandler(TCAM, tmap.MapConfig(**MAP_KW), device="cpu")
    tm.initialize(poses[0], _tfeat(render_features(world, poses[0], JCAM)))
    for T in poses[1:]:
        tm.add_keyframe(T, _tfeat(render_features(world, T, JCAM)), run_ba=False)
    before = np.stack([k.T_w_k for k in tm.map.keyframes])
    old = tm.cfg
    tm.cfg = dataclasses.replace(old, lba_max_jump=1e-12)
    try:
        with caplog.at_level(logging.WARNING, logger="plslam"):
            tm.local_bundle_adjustment()
    finally:
        tm.cfg = old
    assert any("divergence guard" in m for m in caplog.messages)
    np.testing.assert_array_equal(before, np.stack([k.T_w_k for k in tm.map.keyframes]))
    # with the default bound the same solve is applied
    tm.local_bundle_adjustment()
    assert tm.n_local_ba_applied == 1


def test_descriptor_reelection():
    """refresh_landmark_descriptors on both sides: the elected descriptor
    minimizes the summed Hamming distance to the others."""
    world = World(n_pts=8, n_ls=4)
    poses = lateral_poses(3, step=0.04)
    base = np.zeros(8, np.uint32)
    drift = base.copy()
    drift[0] = 0b111
    outlier = np.full(8, 0xFFFFFFFF, np.uint32)
    elected = []
    for side in ("jax", "port"):
        if side == "jax":
            m = jmap.MapHandler(JCAM, jmap.MapConfig())
            kfs = [jmap.KeyframeRecord(i, poses[i], render_features(world, poses[i], JCAM))
                   for i in range(3)]
            descs = (outlier, base, drift)
        else:
            m = tmap.MapHandler(TCAM, tmap.MapConfig(), device="cpu")
            kfs = [tmap.KeyframeRecord(i, poses[i],
                                       _tfeat(render_features(world, poses[i], JCAM)))
                   for i in range(3)]
            descs = tuple(d.view(np.int32) for d in (outlier, base, drift))
        m.map.keyframes.extend(kfs)
        m.map.expand_graphs()
        for kf, d in zip(kfs, descs):
            kf.pt_desc = kf.pt_desc.copy()
            kf.pt_desc[0] = d
        lm = m.map.new_points(world.pts[0][None], descs[0][None], 0, np.asarray([0]))[0]
        m.map.add_point_obs([lm], 1, [0])
        m.map.add_point_obs([lm], 2, [0])
        m.refresh_landmark_descriptors()
        elected.append(np.asarray(m.map.pt_desc[lm]).view(np.uint32))
    np.testing.assert_array_equal(elected[0], elected[1])
    # brute-force oracle: argmin of the summed pairwise Hamming distances
    descs = np.stack([outlier, base, drift])
    D = np.unpackbits((descs[:, None] ^ descs[None, :]).view(np.uint8), axis=-1).sum(-1)
    np.testing.assert_array_equal(elected[1], descs[D.sum(1).argmin()])


def test_feature_round_trip():
    """Fixture features -> port tensors -> numpy reproduces every field,
    the descriptor words as uint32."""
    feats = render_ring_features(RingWorld(n_pts=300, n_ls=30), np.eye(4), JCAM)
    back = stereo_features_to_numpy(_tfeat(feats))
    for side in ("points", "lines"):
        for k, v in getattr(feats, side)._asdict().items():
            np.testing.assert_array_equal(back[side][k], np.asarray(v), err_msg=k)
    assert back["points"]["desc"].dtype == np.uint32
