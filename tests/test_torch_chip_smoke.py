"""chip_smoke.py on the CPU: its numpy ring world and renderer (the card's
machine has no jax, so the script cannot import tests/_map_fixtures) give
the same arrays as the fixtures for the same world, poses and descriptor
noise stream; the script refuses to run without CUDA; and phase 9 (the
disk path) runs on the CPU at a small size."""

import importlib.util
import os

import numpy as np
import pytest
import torch

import _map_fixtures as fx

SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(SPEC)
SPEC.loader.exec_module(chip_smoke)


def test_ring_world_matches_fixture():
    a, b = fx.RingWorld(n_pts=3000, n_ls=300, seed=5), chip_smoke.RingWorld(3000, 300, 5)
    for f in ("pts", "pt_desc", "ls_A", "ls_B", "ls_desc"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f)
    for th in (0.0, 1.3, 5.9):
        np.testing.assert_array_equal(b.pose_at(th), a.pose_at(th))


def test_ring_renderer_matches_fixture():
    world = fx.RingWorld(n_pts=3000, n_ls=300, seed=5)
    cam = fx.make_camera()
    cam_k = tuple(float(getattr(cam, k)) for k in ("fx", "fy", "cx", "cy", "b"))
    # both noise streams from the start: the fixture's is a module global,
    # put back afterwards so other tests in this process see their stream
    saved, fx._RING_DESC_RNG = fx._RING_DESC_RNG, np.random.default_rng(1234)
    rng = np.random.default_rng(1234)
    thetas = np.linspace(0.0, 2 * np.pi * 156 / 140.0, 156, endpoint=False)
    try:
        for th in thetas[::13]:
            T = world.pose_at(th)
            want = fx.render_ring_features(world, T, cam)
            got = chip_smoke.render_ring_features(world, T, cam_k, rng)
            for side in ("points", "lines"):
                w = getattr(want, side)._asdict()
                assert set(got[side]) == set(w)
                for k, v in w.items():
                    v = np.asarray(v)
                    assert got[side][k].dtype == v.dtype, (side, k)
                    np.testing.assert_array_equal(got[side][k], v, err_msg=f"{side}.{k}")
    finally:
        fx._RING_DESC_RNG = saved


def test_refuses_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        chip_smoke.main()
    assert e.value.code not in (0, None)


def test_bounds_of_the_vo_frame():
    """Phase 3's bounds at one VO frame's shapes: Hamming 2 x 1200^2 +
    2 x 256^2 and the ORB + LBD patch gathers are bytes over 3.35 TB/s;
    FAST's operations count at their own issue rates."""
    ham = sum(2 * chip_smoke.bound((n + n) * 32 + n * n * 4,
                                   (2.0 * n * n * 256, chip_smoke.INT8_OPS_PER_S))[0]
              for n in (1200, 256))
    assert ham == pytest.approx(3.651e-3, rel=1e-3)
    assert chip_smoke.bound(1200 * 1200 * 4, (2.0 * 1200 * 1200 * 256,
                                              chip_smoke.INT8_OPS_PER_S))[1] == "bytes"
    orb = 2 * 480 * 752 * 4 + 2 * 2 * 1200 * 4 + 2 * 1200 * 48 * 48 * 4
    lbd = 4 * 480 * 752 * 4 + 2 * 4 * 1536 * 4 + 4 * 1536 * 48 * 48 * 4
    assert chip_smoke.bound(orb)[0] + chip_smoke.bound(lbd)[0] == pytest.approx(26.11e-3, rel=1e-3)
    # FAST with every pixel a candidate: 16 differences at 33.5e12/s and
    # 136 min/max/compares at 16.75e12/s per pixel outrun the 12 bytes
    t, by = chip_smoke.bound(12, (16, chip_smoke.F32_ADD_PER_S),
                             (136, chip_smoke.F32_MINMAX_PER_S))
    assert sum(chip_smoke.FAST_PX_OPS) + sum(chip_smoke.FAST_CANDIDATE_OPS) == 16 + 136
    assert by == "operations" and t == pytest.approx((16 / 33.5e12 + 136 / 16.75e12) * 1e3)


def test_fast_ops_count_the_compass_candidates():
    """Only pixels whose compass points pass the test pay the window folds
    (zero outside the image, as the kernel pads)."""
    thr = torch.tensor([20.0])
    dark = torch.zeros((1, 12, 14))
    px = dark.numel()
    (adds, _), (minmax, _) = chip_smoke.fast_ops(dark, thr)
    assert (adds, minmax) == (4 * px, 19 * px)
    # bright pixels 3 px from (6, 7) on both axes: (6, 7) and the four
    # pixels at (6 +-3, 7 +-3) pass the bright test, the four bright ones
    # the dark test, and no other pixel passes
    img = dark.clone()
    for dy, dx in ((-3, 0), (3, 0), (0, -3), (0, 3)):
        img[0, 6 + dy, 7 + dx] = 150.0
    (adds, _), (minmax, _) = chip_smoke.fast_ops(img, thr)
    assert (adds, minmax) == (4 * px + 12 * 9, 19 * px + 117 * 9)
    # a bright border makes the pixels beside it candidates
    (adds, _), _ = chip_smoke.fast_ops(torch.full((1, 12, 14), 50.0), thr)
    assert adds > 4 * px


def test_main_path_corners():
    """Phase 3 times the patch gather on the VO frame's own inputs: ORB's
    (2, 1200) and LBD's (4, 1536) corners, nearly all wholly inside."""
    from plslam_tpu_torch.io import SyntheticScene, circular_trajectory
    from plslam_tpu_torch.ops.image import build_pyramid

    scene = SyntheticScene(n_points=600, n_lines=60, seed=0, width=752, height=480,
                           fx=435.2, fy=435.2, cx=367.4, cy=252.2)
    T = circular_trajectory(1, step_t=0.05)[0]
    pair = torch.stack([torch.from_numpy(x) for x in scene.render_stereo(T, noise=1.0)])
    got = chip_smoke.main_path_corners(build_pyramid(pair, 4, 1.2), pair)
    for name, B, N in (("orb", 2, 1200), ("lbd", 4, 1536)):
        imgs, y0, x0 = got[name]
        assert imgs.shape == (B, 480, 752) and imgs.is_contiguous()
        assert y0.shape == x0.shape == (B, N) and y0.dtype == torch.int32
        inside = (y0 >= 0) & (y0 <= 480 - 48) & (x0 >= 0) & (x0 <= 752 - 48)
        assert inside.float().mean() > 0.9


def test_refuses_modules_of_the_jax_package(monkeypatch):
    import sys
    import types

    # this process loaded JAX for the parity tests: check on a clean table
    clean = {k: v for k, v in sys.modules.items()
             if k.split(".")[0] not in ("jax", "jaxlib", "plslam_tpu")}
    monkeypatch.setattr(sys, "modules", clean)
    chip_smoke.assert_no_jax()
    clean["plslam_tpu.io.synthetic"] = types.ModuleType("plslam_tpu.io.synthetic")
    with pytest.raises(AssertionError, match="plslam_tpu.io.synthetic"):
        chip_smoke.assert_no_jax()


def test_disk_phase_on_the_cpu(tmp_path, monkeypatch):
    """Phase 9 rehearsed on the CPU at the mini fixture's size (376x240, 9
    frames, diagnostics of frames 4 and 8): the CLI run and every check but
    the kernels' launch counts, the device timers and the card itself."""
    import subprocess
    import sys

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "graph_ms", lambda fn, *a: (fn(), 0.0)[1])
    monkeypatch.setattr(chip_smoke, "median_ms", lambda fn, *a: (fn(), 0.0)[1])
    monkeypatch.setattr(chip_smoke, "KERNEL_WRAPPERS", ())
    # this process loaded JAX for the parity tests (the check is tested above)
    monkeypatch.setattr(chip_smoke, "assert_no_jax", lambda: None)
    monkeypatch.setattr(chip_smoke, "DISK_FRAMES", 9)
    monkeypatch.setattr(chip_smoke, "DISK_OVERLAY_EVERY", 4)
    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib" else find_spec(name, *a))
    fixture = str(tmp_path / "disk")
    writer = subprocess.Popen([sys.executable, "-m", "plslam_tpu_torch.io.mini_euroc", fixture,
                               "--frames", "9"], cwd=chip_smoke.ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
    chip_smoke.wait_disk_fixture(writer)
    by_thread, fps, ate, remap_us = chip_smoke.phase_disk(torch.device("cpu"), "CPU", fixture)
    assert fps > 0 and ate <= chip_smoke.DISK_ATE_FLOOR and remap_us == 0.0
    assert set(by_thread) == set(chip_smoke._wrappers())
    with open(os.path.join(fixture, "residuals.jsonl")) as f:
        assert len(f.readlines()) == 2


def test_render_depth_matches_fixture():
    """Phase 10's numpy copy of tests/test_rgbd.render_depth."""
    from plslam_tpu.io.synthetic import SyntheticScene as JScene
    from test_rgbd import render_depth

    scene = JScene(seed=13)
    T = np.eye(4)
    T[:3, 3] = (0.02, -0.01, 0.1)
    np.testing.assert_array_equal(chip_smoke.render_depth(scene, T), render_depth(scene, T))


def test_batch_phase_on_the_cpu(monkeypatch):
    """Phase 10 rehearsed on the CPU at 376x240 (2 streams, 512 points,
    128 line slots, 1 + 1 + 2 frames, B in 1 and 2, the ATE floors at
    B = 2 against generous stand-ins): the worker-process render, the
    sweep, the single-stream agreement and the RGB-D track; not the
    kernels' launch counts, the device timers or the card."""
    import sys

    monkeypatch.setitem(sys.modules, "chip_smoke", chip_smoke)   # the workers import it
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "KERNEL_WRAPPERS", ())
    monkeypatch.setattr(chip_smoke, "BATCH_SIZES", (1, 2))
    monkeypatch.setattr(chip_smoke, "BATCH_WARMUP", 1)
    monkeypatch.setattr(chip_smoke, "BATCH_FRAMES", 2)
    monkeypatch.setattr(chip_smoke, "BATCH_SCENE", dict(n_points=300, n_lines=40, width=376,
                                                       height=240, fx=217.6, fy=217.6,
                                                       cx=183.7, cy=126.1))
    monkeypatch.setattr(chip_smoke, "BATCH_WIDTHS", dict(n_points=512, n_lines=128))
    monkeypatch.setattr(chip_smoke, "BATCH_ATE_B", 2)
    monkeypatch.setattr(chip_smoke, "JAX_CPU_BATCH_ATE", (0.05, 0.05))
    monkeypatch.setattr(chip_smoke, "RENDER_WORKERS", 2)
    streams = chip_smoke.wait_batch_render(chip_smoke.start_batch_render())
    assert len(streams) == 2 and streams[0].shape == (4, 2, 240, 376)
    launches, rows, ates = chip_smoke.phase_batch(torch.device("cpu"), "CPU", streams)
    assert set(launches) == set(chip_smoke._wrappers()) and set(rows) == {1, 2}
    assert rows[2]["good"] == rows[2]["frames"] == 6 and len(ates) == 2
    launches, err = chip_smoke.phase_rgbd(torch.device("cpu"), "CPU")
    assert err < 0.02 and not any(launches.values())


# phase 11 at CPU sizes: the dry run's programs cut small, 2 streams at
# 376x240 and one frame after initialize
SMALL_DIST = dict(ba=dict(K=8, P=256, L=32, obs_k=4), iters=2, q=160, masked=0.05, pgo_k=32,
                  pgo_iters=5, ring=dict(rng_seed=3, n_kf=16, n_pts=800, n_ls=80, pose_noise=0.01,
                                         lm_noise=0.03),
                  b=2, frames=1, widths=dict(n_points=512, n_lines=128),
                  scene=dict(n_points=300, n_lines=40, width=376, height=240, fx=217.6,
                             fy=217.6, cx=183.7, cy=126.1))


def test_dist_phase_on_the_cpu():
    """Phase 11 rehearsed on the CPU with gloo at world 1 (SMALL_DIST):
    every program against its single-device counterpart, the sharded batch
    bit-identical to the unsharded one; not the kernels' launch counts or
    the card."""
    streams = [chip_smoke.render_stream(s, 2, SMALL_DIST["scene"]) for s in range(2)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        launches, ms = chip_smoke.phase_dist(torch.device("cpu"), "CPU", streams, SMALL_DIST)
    finally:
        torch.set_num_threads(threads)
    assert set(launches) == set(chip_smoke._wrappers()) and not any(launches.values())
    assert {"dist_ba", "dist_ba_2d", "dist_match", "dist_pgo", "dist_gba 1-axis",
            "dist_gba 2-axis", "dist_batch_vo", "batch_vo"} <= set(ms)
    assert not torch.distributed.is_initialized()
