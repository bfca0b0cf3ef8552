"""The port's PLSLAM (tracking, mapping worker thread, local BA, chunked
GBA) on test_pipeline_threads' synthetic scene (376x240, 8 frames, a
keyframe nearly every frame): the threaded and the inline mapper build the
same map, the keyframe ATE stays under max(2x the JAX package's, 0.01 m),
errors on the worker surface at finish(), overlays and the live scene
export are written, and a mesh= that is not a DeviceMesh raises.
With loop closure (endpoint lines): the loop-closure thread never blocks
the keyframe queue, and a feature replay closes a loop through both
threads."""

import json
import threading

import numpy as np
import pytest

from _map_fixtures import World, lateral_poses, make_camera, render_features
from plslam_tpu.io.synthetic import SyntheticScene, circular_trajectory
from plslam_tpu.io.trajectory import ate_rmse
from plslam_tpu_torch.backend.mapping import MapConfig
from plslam_tpu_torch.config import PLSLAMConfig
from plslam_tpu_torch.convert import stereo_features_from_numpy
from plslam_tpu_torch.core.camera import StereoCamera
from plslam_tpu_torch.ops import cuda_hamming
from plslam_tpu_torch.pipeline import PLSLAM

from test_torch_helpers import one_torch_thread  # noqa: F401

N_FRAMES = 8
# Keyframe ATE (m, aligned) of the JAX package's PLSLAM on the same 8
# frames with finish(run_gba=True), measured once on CPU
# (JAX_PLATFORMS=cpu): SyntheticScene(seed=7), PLSLAMConfig(orb_nfeatures=512,
# lsd_nfeatures=128, orb_fast_th=15, min_entropy_ratio=0.99),
# MapConfig(local_ba_kf=8, ba_points=2048, ba_lines=256, ba_pobs=8192,
# ba_lobs=2048), circular_trajectory(8, step_t=0.12, step_r=0.015),
# keyframes matched to ground truth by timestamp, ate_rmse(align=True).
JAX_CPU_ATE = 0.02381158349513792
MAP_CFG = dict(local_ba_kf=8, ba_points=2048, ba_lines=256, ba_pobs=8192, ba_lobs=2048)


def _cam(scene):
    return StereoCamera.create(scene.fx, scene.fy, scene.cx, scene.cy, scene.b,
                               width=scene.width, height=scene.height)


def _run(multithread: bool):
    scene = SyntheticScene(seed=7)
    cfg = PLSLAMConfig(orb_nfeatures=512, lsd_nfeatures=128, orb_fast_th=15,
                       min_entropy_ratio=0.99, multithread_slam=multithread)
    slam = PLSLAM(_cam(scene), cfg, MapConfig(**MAP_CFG), device="cpu")
    poses = circular_trajectory(N_FRAMES, step_t=0.12, step_r=0.015)
    for i, T in enumerate(poses):
        slam.process(*scene.render_stereo(T), timestamp=0.05 * i)
    traj = slam.finish(run_gba=True)
    return slam, poses, traj


@pytest.fixture(scope="module")
def both_runs():
    return _run(False), _run(True)


def test_threaded_and_inline_build_the_same_map(both_runs):
    (s0, _, t0), (s1, _, t1) = both_runs
    m0, m1 = s0.mapper.map, s1.mapper.map
    assert len(m0.keyframes) == len(m1.keyframes) >= 3
    for a, b in ((m0.pobs, m1.pobs), (m0.lobs, m1.lobs)):
        assert a.n == b.n
        for f in ("valid", "lm", "kf", "fi"):
            np.testing.assert_array_equal(getattr(a, f)[: a.n], getattr(b, f)[: b.n])
    np.testing.assert_array_equal(m0.covis, m1.covis)
    np.testing.assert_allclose(np.stack(t0), np.stack(t1), rtol=0, atol=1e-6)
    assert s1._map_thread is None and s1._map_errors == []


def test_keyframe_ate_against_jax(both_runs):
    _, (slam, poses, traj) = both_runs
    assert all(lg.good for lg in slam.logs)
    assert slam.mapper.n_local_ba_applied >= 1
    gt = np.stack([poses[int(round(t / 0.05))][:3, 3] for t in slam.kf_timestamps])
    ate = ate_rmse(np.stack([T[:3, 3] for T in traj]), gt, align=True)
    assert ate < max(2.0 * JAX_CPU_ATE, 0.01), (ate, JAX_CPU_ATE)


def test_exports(both_runs, tmp_path):
    _, (slam, _, _) = both_runs
    slam.save_trajectory_tum(str(tmp_path / "traj.txt"))
    lines = (tmp_path / "traj.txt").read_text().strip().splitlines()
    assert len(lines) == len(slam.mapper.map.keyframes)
    assert all(len(ln.split()) == 8 for ln in lines)
    slam.save_logs_jsonl(str(tmp_path / "log.jsonl"))
    logs = [json.loads(ln) for ln in (tmp_path / "log.jsonl").read_text().splitlines()]
    assert len(logs) == N_FRAMES - 1 and all(lg["good"] for lg in logs)


def _feature_slam(**cfg_kw):
    cam = make_camera()
    world = World(n_pts=120, n_ls=12)
    poses = lateral_poses(4, step=0.04)
    feats = [stereo_features_from_numpy(render_features(world, T, cam), "cpu")
             for T in poses]
    tcam = StereoCamera.create(458.0, 457.0, 376.0, 240.0, 0.11)
    return PLSLAM(tcam, PLSLAMConfig(**cfg_kw), MapConfig(**MAP_CFG), device="cpu"), \
        poses, feats


def test_worker_error_surfaces_at_finish():
    slam, poses, feats = _feature_slam()
    assert slam._map_thread.name == "plslam-mapper"

    def boom(*a, **k):
        raise RuntimeError("mapping failed")

    slam.mapper.add_keyframe = boom
    slam.insert_keyframe_features(poses[0], feats[0])
    slam.insert_keyframe_features(poses[1], feats[1], timestamp=0.1)
    with pytest.raises(RuntimeError, match="mapping failed"):
        slam.finish(run_gba=False)


def test_feature_replay_through_the_worker():
    slam, poses, feats = _feature_slam()
    for i, (T, f) in enumerate(zip(poses, feats)):
        slam.insert_keyframe_features(T, f, timestamp=0.1 * i)
    slam.wait_until_idle()
    assert len(slam.mapper.map.keyframes) == len(poses)
    traj = slam.finish(run_gba=True)
    gt = np.stack([T[:3, 3] for T in poses])
    assert ate_rmse(np.stack([T[:3, 3] for T in traj]), gt, align=False) < 0.01
    # CPU tensors never reach a kernel, on any thread
    assert cuda_hamming.hamming_distance_matrix_cuda.launches == 0


def test_plucker_with_loop_closure_raises():
    cam = StereoCamera.create(200.0, 200.0, 160.0, 120.0, 0.11)
    with pytest.raises(ValueError):
        PLSLAM(cam, PLSLAMConfig(use_line_plucker=True, use_loop_closure=True), device="cpu")


@pytest.mark.parametrize("cfg_kw", [
    dict(use_line_plucker=False), dict(has_refinement=True),
    dict(use_line_plucker=False, use_loop_closure=True), dict(checkpoint_every_kf=1),
    dict(overlay_every=1), dict(viz_every_kf=1)])
def test_formerly_refused_configs_build(cfg_kw):
    """Endpoint lines, the keyframe refinement, loop closure,
    auto-checkpoints, overlays and the live scene export are ported: the
    pipeline builds with each."""
    cam = StereoCamera.create(200.0, 200.0, 160.0, 120.0, 0.11)
    slam = PLSLAM(cam, PLSLAMConfig(multithread_slam=False, **cfg_kw), device="cpu")
    assert (slam.loop_closer is not None) == bool(cfg_kw.get("use_loop_closure"))
    assert slam.mapper.cfg.plucker_lines == cfg_kw.get("use_line_plucker", True)


def test_overlay_and_live_scene(tmp_path):
    """overlay_every renders every other frame's overlay and residual record
    (tests/test_viz_frame.py's scene), viz_every_kf rewrites the scene HTML
    from the mapping worker; tracking and mapping are unaffected."""
    pytest.importorskip("matplotlib")
    scene = SyntheticScene(n_points=260, n_lines=32, seed=2)
    html = str(tmp_path / "live.html")
    cfg = PLSLAMConfig(orb_nfeatures=512, lsd_nfeatures=64, orb_fast_th=15,
                       min_entropy_ratio=0.99, overlay_every=2,
                       overlay_dir=str(tmp_path / "ov"), viz_every_kf=1, viz_path=html)
    slam = PLSLAM(_cam(scene), cfg, MapConfig(**MAP_CFG), device="cpu")
    for i, T in enumerate(circular_trajectory(4, step_t=0.05)):
        slam.process(*scene.render_stereo(T, noise=1.0), timestamp=0.05 * i)
    slam.finish(run_gba=False)
    assert slam._map_errors == [] and all(lg.good for lg in slam.logs)
    assert [p.name for p in (tmp_path / "ov").iterdir() if p.suffix == ".png"] == \
        ["overlay_000002.png"]
    recs = [json.loads(ln) for ln in (tmp_path / "ov" / "residuals.jsonl").read_text().splitlines()]
    assert [r["frame"] for r in recs] == [2]
    inl = [v for r in recs for (_, v, ok) in r["pt"] if ok]
    assert inl and all(np.isfinite(v) for v in inl)
    assert len(slam.mapper.map.keyframes) >= 2
    assert "const DATA" in open(html).read()


def test_overlay_failure_never_stops_tracking(tmp_path, caplog):
    scene = SyntheticScene(n_points=80, n_lines=12, seed=0, width=188, height=120,
                           fx=100.0, fy=100.0, cx=94.0, cy=60.0)
    cfg = PLSLAMConfig(orb_nfeatures=256, lsd_nfeatures=64, multithread_slam=False,
                       overlay_every=1, overlay_dir=str(tmp_path / "ov"))
    slam = PLSLAM(_cam(scene), cfg, MapConfig(**MAP_CFG), device="cpu")

    def boom(*a, **k):
        raise RuntimeError("render failed")

    import plslam_tpu_torch.viz_frame as vf
    old = vf.render_frame_overlay
    vf.render_frame_overlay = boom
    try:
        for i, T in enumerate(circular_trajectory(3, step_t=0.05)):
            slam.process(*scene.render_stereo(T, noise=1.0), timestamp=0.05 * i)
    finally:
        vf.render_frame_overlay = old
    slam.finish(run_gba=False)
    assert len(slam.logs) == 2
    assert caplog.text.count("overlay render failed") == 2


def test_scene_export_failure_never_stops_mapping(tmp_path, caplog):
    slam, poses, feats = _feature_slam(multithread_slam=False, viz_every_kf=1,
                                       viz_path=str(tmp_path / "missing" / "scene.html"))
    for i, (T, f) in enumerate(zip(poses, feats)):
        slam.insert_keyframe_features(T, f, timestamp=0.1 * i)
    slam.finish(run_gba=False)
    assert len(slam.mapper.map.keyframes) == len(poses)
    assert caplog.text.count("live scene export failed") == len(poses) - 1


def test_distributed_gba_raises():
    """mesh= takes a DeviceMesh (the distributed GBA runs in
    test_torch_dist_gba.py's ranks); anything else raises."""
    slam, poses, feats = _feature_slam(multithread_slam=False)
    for i, (T, f) in enumerate(zip(poses, feats)):
        slam.insert_keyframe_features(T, f, timestamp=0.1 * i)
    with pytest.raises(TypeError, match="DeviceMesh"):
        slam.finish(mesh=object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        slam.global_bundle_adjustment(mesh=object())


def test_checkpoint_round_trip(tmp_path):
    """save_checkpoint mid-run, load_checkpoint into a fresh pipeline: the
    same keyframes, tables and trajectory."""
    slam, poses, feats = _feature_slam()
    for i, (T, f) in enumerate(zip(poses, feats)):
        slam.insert_keyframe_features(T, f, timestamp=0.1 * i)
    path = str(tmp_path / "map.npz")
    slam.save_checkpoint(path)
    fresh, _, _ = _feature_slam(multithread_slam=False)
    fresh.load_checkpoint(path)
    a, b = slam.mapper.map, fresh.mapper.map
    assert len(b.keyframes) == len(poses)
    np.testing.assert_array_equal(a.covis, b.covis)
    assert a.pt_obs == b.pt_obs and a.ls_obs == b.ls_obs
    np.testing.assert_array_equal(a.pt_desc, b.pt_desc)
    np.testing.assert_array_equal(np.stack(slam.keyframe_trajectory()),
                                  np.stack(fresh.keyframe_trajectory()))
    slam.finish(run_gba=False)


def _loop_slam(multithread=True):
    """The drifting square loop of test_torch_loop (points and endpoint
    lines) as a feature replay through PLSLAM with loop closure."""
    from test_torch_loop import SCENARIO_LINES, VOCAB

    cfg = PLSLAMConfig(use_line_plucker=False, use_loop_closure=True,
                       multithread_slam=multithread, lc_kf_dist=8, lc_nkf_closest=1,
                       vocabulary_p=VOCAB, min_lm_cov_graph=10 ** 9)
    tcam = StereoCamera.create(435.2, 435.2, 367.4, 252.2, 0.110074)
    mcfg = MapConfig(plucker_lines=False, min_lm_cov_graph=10 ** 9, local_ba_kf=4,
                     **{k: MAP_CFG[k] for k in ("ba_points", "ba_pobs")})
    slam = PLSLAM(tcam, cfg, mcfg, device="cpu")
    T_true, T_drift, feats = SCENARIO_LINES
    return slam, T_true, T_drift, [stereo_features_from_numpy(f, "cpu") for f in feats]


def test_loop_closure_feature_replay():
    """Endpoint mapping with local BA on the mapping thread and loop
    closure on the loop-closure thread: the revisit closes against KF 0
    and pulls the last keyframe towards the truth."""
    slam, T_true, T_drift, feats = _loop_slam()
    assert slam._lc_thread.name == "plslam-loopcloser"
    for i, (T, f) in enumerate(zip(T_drift, feats)):
        slam.insert_keyframe_features(T, f, timestamp=0.1 * i)
    slam.wait_until_idle()
    assert len(slam.loop_closer.bow) == len(feats)
    assert [(r["kf"], r["candidate"]) for r in slam.loop_reports] == [(12, 0)]
    assert sum(slam.loop_reports[0]["fused"].values()) > 0
    traj = slam.finish(run_gba=False)
    assert slam._lc_thread is None and slam._map_errors == []
    err = np.linalg.norm(traj[-1][:3, 3] - T_true[-1][:3, 3])
    assert err < 0.5 * np.linalg.norm(T_drift[-1][:3, 3] - T_true[-1][:3, 3])


def test_loop_closure_runs_off_the_mapping_worker():
    """A slow loop closure must not back-pressure the bounded keyframe
    queue: the mapping worker keeps inserting keyframes while the
    loop-closure thread is stuck, and every queued job runs by idle."""
    slam, _, T_drift, feats = _loop_slam()
    done = []
    lc_blocked, lc_release = threading.Event(), threading.Event()

    def blocking_lc(kf_id=None):
        done.append(kf_id)
        if kf_id == 1:
            lc_blocked.set()
            assert lc_release.wait(timeout=120)
        return None

    slam.loop_closer.on_new_keyframe = blocking_lc
    n = 8
    slam.insert_keyframe_features(T_drift[0], feats[0])
    slam.insert_keyframe_features(T_drift[1], feats[1], timestamp=0.1)
    assert lc_blocked.wait(timeout=120)

    def feed_rest():
        for i in range(2, n):
            slam.insert_keyframe_features(T_drift[i], feats[i], timestamp=0.1 * i)
        slam._kf_queue.join()

    t = threading.Thread(target=feed_rest, daemon=True)
    t.start()
    t.join(timeout=120)
    stalled = t.is_alive()
    lc_release.set()
    assert not stalled, "keyframe feed wedged behind the loop closure"
    assert len(slam.mapper.map.keyframes) == n
    slam.wait_until_idle()
    assert sorted(done) == list(range(n)), done
    slam.finish(run_gba=False)


def test_loop_worker_error_surfaces_at_finish():
    slam, _, T_drift, feats = _loop_slam()

    def boom(kf_id=None):
        raise RuntimeError("loop closure failed")

    slam.loop_closer.on_new_keyframe = boom
    slam.insert_keyframe_features(T_drift[0], feats[0])
    with pytest.raises(RuntimeError, match="loop closure failed"):
        slam.finish(run_gba=False)


def test_launch_counter_is_thread_safe():
    """The launch counter's total and its per-thread counts stay exact
    under concurrent counting from several threads, four of which share
    one name (and so one count: a read-modify-write without the lock
    would lose updates)."""
    import sys

    fn = cuda_hamming.hamming_distance_matrix_cuda
    fn.launches = 0
    n_threads, n_each = 8, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [fn.count() for _ in range(n_each)],
                                    name="shared" if i < 4 else f"counter-{i}")
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert fn.launches == n_threads * n_each
    want = {f"counter-{i}": n_each for i in range(4, n_threads)}
    assert fn.launches_by_thread() == dict(want, shared=4 * n_each)
    fn.launches = 0
    assert fn.launches == 0 and fn.launches_by_thread() == {}
    with pytest.raises(ValueError):
        fn.launches = 3
