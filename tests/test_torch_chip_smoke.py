"""chip_smoke.py on the CPU: the numpy ring world and renderer it replays
(``plslam_tpu_torch/io/ring_world.py``; the card's machine has no jax, so
the script cannot import tests/_map_fixtures) give the same arrays as the
fixtures for the same world, poses and descriptor noise stream; the
script refuses to run without CUDA; and the helpers its phases share.
The phase rehearsals on the CPU have a file each
(``tests/test_torch_chip_smoke_{batch,disk,dist,eval}.py``)."""

import numpy as np
import pytest
import torch

import _map_fixtures as fx
from plslam_tpu_torch.io import ring_world
from test_torch_helpers import load_chip_smoke

chip_smoke = load_chip_smoke()


def test_ring_world_matches_fixture():
    a, b = fx.RingWorld(n_pts=3000, n_ls=300, seed=5), ring_world.RingWorld(3000, 300, 5)
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
            got = ring_world.render_ring_features(world, T, cam_k, rng)
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


def test_render_depth_matches_fixture():
    """Phase 10's numpy copy of tests/test_rgbd.render_depth."""
    from plslam_tpu.io.synthetic import SyntheticScene as JScene
    from test_rgbd import render_depth

    scene = JScene(seed=13)
    T = np.eye(4)
    T[:3, 3] = (0.02, -0.01, 0.1)
    np.testing.assert_array_equal(chip_smoke.render_depth(scene, T), render_depth(scene, T))
