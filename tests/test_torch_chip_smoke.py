"""chip_smoke.py on the CPU: its numpy ring world and renderer (the card's
machine has no jax, so the script cannot import tests/_map_fixtures) give
the same arrays as the fixtures for the same world, poses and descriptor
noise stream; and the script refuses to run without CUDA."""

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
