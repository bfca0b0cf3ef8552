"""The port's spans and counters (``plslam_tpu_torch.utils.profiling``)
and what the program counts with them:

- ``span`` is a ``record_function`` range under a CPU profiler, on the
  main thread and, with ``profile_all_threads``, on a thread started
  before the profiler; nothing when the profiler is off;
- ``timed`` counts a call that raises; ``counters()`` is per thread;
  ``per_call_ms`` and ``added`` read the difference of two snapshots, and
  ``profile_slam.window`` prints both with the GN trips used and the GN
  launches per tracked frame;
- a collector pass under the profiler is a ``host.gc`` range;
- ``graphs.stats()`` with a released ``Program`` still alive, and
  ``graphs.captures()`` without the allocator's snapshot;
- a short CPU ``PLSLAM`` run: one ``pipeline.process`` call a frame, one
  ``pipeline.keyframes`` a keyframe the logs flag, 15 GN trips unrolled a
  tracked frame, the mapper's keyframes on its own thread;
- uint8 frames track bit for bit as their float32 twins, and count as
  cast on the device."""

import gc
import threading

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from plslam_tpu_torch import graphs
from plslam_tpu_torch.backend.mapping import MapConfig
from plslam_tpu_torch.config import PLSLAMConfig
from plslam_tpu_torch.core.camera import StereoCamera
from plslam_tpu_torch.io.synthetic import SyntheticScene, circular_trajectory
from plslam_tpu_torch.pipeline import PLSLAM
from plslam_tpu_torch.profile_slam import window
from plslam_tpu_torch.utils.profiling import add, added, counters, per_call_ms, span, timed

from test_torch_helpers import one_torch_thread  # noqa: F401


def _names(prof) -> list:
    return [e.name for e in prof.events()]


def _mine(name: str = None) -> dict:
    return counters().get(name or threading.current_thread().name, {})


def test_span_is_a_range_under_the_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert autograd_profiler._is_profiler_enabled
        with span("pipeline.test_span"):
            torch.ones(4).add_(1)
    assert not autograd_profiler._is_profiler_enabled
    assert _names(prof).count("pipeline.test_span") == 1


def test_span_records_nothing_with_the_profiler_off():
    with span("pipeline.test_off") as s:
        assert s._rf is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(4).add_(1)
    assert "pipeline.test_off" not in _names(prof)


def test_span_on_a_thread_started_before_the_profiler():
    go, done = threading.Event(), threading.Event()

    def work():
        go.wait()
        with span("mapper.test_thread"):
            torch.ones(4).add_(1)
        done.set()

    th = threading.Thread(target=work, name="test-worker")
    th.start()
    cfg = _ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU], experimental_config=cfg) as prof:
        go.set()
        assert done.wait(30)
    th.join()
    assert "mapper.test_thread" in _names(prof)


def test_timed_counts_a_call_that_raises():
    before = _mine()
    with pytest.raises(KeyError):
        with timed("pipeline.test_raise"):
            raise KeyError("x")
    with timed("pipeline.test_raise"):
        pass
    after = _mine()
    assert after["pipeline.test_raise.calls"] - before.get("pipeline.test_raise.calls", 0) == 2
    assert after["pipeline.test_raise.ns"] > before.get("pipeline.test_raise.ns", 0)


def test_timed_is_a_span_too():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timed("pipeline.test_timed_span"):
            pass
    assert "pipeline.test_timed_span" in _names(prof)


def test_counters_are_per_thread():
    def work():
        add("vo.test_thread_count", 3)
        with timed("vo.test_thread_timed"):
            pass

    add("vo.test_main_count")
    th = threading.Thread(target=work, name="test-counter-thread")
    th.start()
    th.join()
    snap = counters()
    assert snap["test-counter-thread"]["vo.test_thread_count"] == 3
    assert snap["test-counter-thread"]["vo.test_thread_timed.calls"] == 1
    assert "vo.test_thread_count" not in snap[threading.current_thread().name]
    assert "vo.test_main_count" not in snap["test-counter-thread"]
    # a snapshot is a copy
    snap["test-counter-thread"]["vo.test_thread_count"] = 0
    assert counters()["test-counter-thread"]["vo.test_thread_count"] == 3


def test_per_call_ms_reads_the_difference_of_two_snapshots():
    before = {"T": {"a.ns": 1_000_000, "a.calls": 1, "b.ns": 5, "b.calls": 1}}
    after = {"T": {"a.ns": 7_000_000, "a.calls": 4, "b.ns": 5, "b.calls": 1, "n": 9},
             "U": {"c.ns": 2_000_000, "c.calls": 1}}
    assert per_call_ms(before, after) == {"T": {"a": (2.0, 3)}, "U": {"c": (2.0, 1)}}


def test_added_reads_the_plain_counters_of_two_snapshots():
    before = {"T": {"a.ns": 1, "a.calls": 1, "n": 2, "m": 5}}
    after = {"T": {"a.ns": 9, "a.calls": 2, "n": 7, "m": 5}, "U": {"k": 3, "c.calls": 1}}
    assert added(before, after) == {"T": {"n": 5}, "U": {"k": 3}}


def test_profile_slam_window_prints_the_blocks_the_counts_and_the_trips_used():
    before = {"trk": {"pipeline.process.ns": 0, "pipeline.process.calls": 0,
                      "vo.gn_trips_used": 10, "vo.gn_trips_unrolled": 30}}
    after = {"trk": {"pipeline.process.ns": 8_000_000, "pipeline.process.calls": 4,
                     "vo.gn_trips_used": 40, "vo.gn_trips_unrolled": 90,
                     "pipeline.keyframes": 2, "kernels.gn_launches": 8},
             "map": {"mapper.keyframe.ns": 6_000_000, "mapper.keyframe.calls": 2}}
    assert window(before, after) == {
        "ms_calls": {"map mapper.keyframe": [3.0, 2], "trk pipeline.process": [2.0, 4]},
        "counts": {"trk kernels.gn_launches": 8, "trk pipeline.keyframes": 2,
                   "trk vo.gn_trips_unrolled": 60, "trk vo.gn_trips_used": 30},
        "gn_trips_used_pct": 50.0, "gn_launches_per_vo_frame": {"trk": 2.0}}
    assert window(after, after)["gn_trips_used_pct"] is None
    assert window(after, after)["gn_launches_per_vo_frame"] == {}


def test_a_collector_pass_is_a_host_gc_range():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        gc.collect()
    gc.collect()   # and none outside the profiler
    assert _names(prof).count("host.gc") >= 1


def test_graph_stats_with_a_released_program_alive(monkeypatch):
    """A released program is skipped, and with no graph held no snapshot
    of the allocator is taken."""
    prog = graphs.Program(lambda: torch.ones(2), "cpu")
    graphs._live.add(prog)
    try:
        prog.release()
        assert prog.graph is None

        def no_snapshot():
            raise AssertionError("memory_snapshot taken with no graph held")

        monkeypatch.setattr(torch.cuda, "memory_snapshot", no_snapshot)
        st = graphs.stats()
        assert st["live"] == 0 and st["pool_bytes"] == 0
    finally:
        graphs._live.discard(prog)


def test_graph_captures_take_no_allocator_snapshot(monkeypatch):
    """``graphs.captures()`` is ``stats()["captures"]``, and takes no
    snapshot of the allocator while a graph is held."""
    held = type("Held", (), {"graph": type("G", (), {"pool": lambda self: (0, 1)})()})()
    n = graphs.stats()["captures"]

    def no_snapshot():
        raise AssertionError("memory_snapshot taken")

    graphs._live.add(held)
    try:
        monkeypatch.setattr(torch.cuda, "memory_snapshot", no_snapshot)
        assert graphs.captures() == n
        monkeypatch.setitem(graphs._counts, "captures", n + 2)
        assert graphs.captures() == n + 2
        with pytest.raises(AssertionError):
            graphs.stats()
    finally:
        graphs._live.discard(held)


N_FRAMES = 4


def _small_slam(scene):
    cam = StereoCamera.create(scene.fx, scene.fy, scene.cx, scene.cy, scene.b,
                              width=scene.width, height=scene.height)
    cfg = PLSLAMConfig(orb_nfeatures=256, lsd_nfeatures=64, orb_fast_th=15,
                       min_entropy_ratio=0.99)
    return PLSLAM(cam, cfg, MapConfig(local_ba_kf=8, ba_points=2048, ba_lines=256,
                                      ba_pobs=8192, ba_lobs=2048), device="cpu")


def test_plslam_counts_frames_keyframes_and_gn_trips():
    scene = SyntheticScene(seed=7)
    slam = _small_slam(scene)
    main = threading.current_thread().name
    before = counters()
    for i, T in enumerate(circular_trajectory(N_FRAMES, step_t=0.12, step_r=0.015)):
        slam.process(*scene.render_stereo(T), timestamp=0.05 * i)
    slam.finish(run_gba=False)
    after = counters()

    def delta(name, thread=main):
        return after.get(thread, {}).get(name, 0) - before.get(thread, {}).get(name, 0)

    tracked = len(slam.logs)
    assert tracked == N_FRAMES - 1
    kfs = sum(lg.is_kf for lg in slam.logs)
    assert kfs >= 1
    assert delta("pipeline.process.calls") == N_FRAMES
    assert delta("pipeline.upload.calls") == N_FRAMES
    assert delta("pipeline.scalars.wait.calls") == tracked
    assert delta("pipeline.keyframes") == kfs
    assert delta("pipeline.kf_queue.wait.calls") == kfs
    assert delta("vo.gn_trips_unrolled") == 15 * tracked
    assert 2 * tracked <= delta("vo.gn_trips_used") <= 15 * tracked
    # the mapper's keyframes are timed on its own thread
    assert delta("mapper.keyframe.calls", "plslam-mapper") == kfs
    assert delta("mapper.keyframe.calls") == 0
    assert delta("mapper.fetch.wait.calls", "plslam-mapper") >= kfs
    # a frame's logged time is that of its process call, on the same clock
    ns = delta("pipeline.process.ns")
    assert sum(lg.t_total for lg in slam.logs) * 1e9 <= ns


def _upload_run(frames):
    """A CPU ``PLSLAM`` over ``frames``: (logs without their times, each
    frame's pose or None, the keyframe trajectory, the main thread's
    counters' increase)."""
    slam = _small_slam(SyntheticScene(seed=7))
    main = threading.current_thread().name
    before = counters().get(main, {})
    poses = []
    for i, (il, ir) in enumerate(frames):
        res = slam.process(il, ir, timestamp=0.05 * i)
        poses.append(None if res is None else res.T_f_w.clone())
    slam.finish(run_gba=False)
    after = counters().get(main, {})
    logs = [{k: v for k, v in vars(lg).items() if k != "t_total"} for lg in slam.logs]
    return logs, poses, slam.keyframe_trajectory(), \
        {k: after.get(k, 0) - before.get(k, 0) for k in after}


def test_uint8_frames_cast_on_the_device_track_as_their_float_twins():
    """The same frames, rounded to uint8, handed as uint8 and as float32:
    every log field but the time, every pose and the keyframe trajectory
    bit for bit; the uint8 images count as cast on the device (not copied
    asynchronously: there is no card), the float ones do not."""
    scene = SyntheticScene(seed=7)
    u8 = [tuple(np.clip(np.rint(x), 0, 255).astype(np.uint8) for x in scene.render_stereo(T))
          for T in circular_trajectory(N_FRAMES, step_t=0.12, step_r=0.015)]
    f32 = [tuple(x.astype(np.float32) for x in pair) for pair in u8]
    (lu, pu, tu, cu), (lf, pf, tf, cf) = _upload_run(u8), _upload_run(f32)
    assert len(lu) == N_FRAMES - 1 and lu == lf
    assert pu[0] is None and pf[0] is None
    assert all(torch.equal(a, b) for a, b in zip(pu[1:], pf[1:]))
    assert len(tu) >= 2 and all(np.array_equal(a, b) for a, b in zip(tu, tf))
    assert cu.get("pipeline.upload.on_card_cast", 0) == 2 * N_FRAMES
    assert cf.get("pipeline.upload.on_card_cast", 0) == 0
    assert cu.get("pipeline.upload.async", 0) == cf.get("pipeline.upload.async", 0) == 0
    assert cu["pipeline.upload.calls"] == cf["pipeline.upload.calls"] == N_FRAMES
