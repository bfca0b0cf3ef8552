"""plslam_tpu_torch.parallel.multihost in 8 gloo rank processes laid out as
2 hosts x 4 devices (tests/test_multihost.py's mesh):

- the mesh is host-major, named ("dcn", "ici"): ranks 0-3 form host 0;
- the 2-axis landmark-sharded BA on test_multihost.py's toy problem (6
  poses, 64 points, 4-keyframe windows; float64, 3 fixed LM trips) equals
  the 1-axis run and the port's single-device ``lm_rounds`` within 1e-6
  (test_multihost.py's bar);
- the 2-axis kf-block GBA on test_multihost.py's map (12 lateral
  keyframes, 260 points, perturbed) halves the median point error and
  leaves finite poses, the same on every rank."""

import os

import jax
import numpy as np
import pytest

from _map_fixtures import World, lateral_poses, make_camera, render_features
from plslam_tpu_torch.backend import ba
from plslam_tpu_torch.backend.mapping import MapConfig, MapHandler
from plslam_tpu_torch.convert import ba_problem_from_numpy, stereo_features_from_numpy
from plslam_tpu_torch.core.camera import StereoCamera
from plslam_tpu_torch.io.checkpoint import save_map
from plslam_tpu_torch.parallel.launch import launch

from test_multihost import _toy_problem
from test_torch_helpers import one_torch_thread  # noqa: F401

N_DEV = 8
ITERS = 3
TOY_INTR = (435.2, 435.2, 367.4, 252.2, 0.110074)
MAP_INTR = (458.0, 457.0, 376.0, 240.0, 0.11)
MAP_CFG = dict(ba_points=512, ba_lines=64, ba_pobs=8192, ba_lobs=512)
TESTS = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def toy():
    _, prob, _ = _toy_problem(P=64)
    return jax.tree.map(np.asarray, prob)


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    """test_multihost.py's map on the port's MapHandler, points perturbed;
    (checkpoint path, eligible rows, their truth, their start)."""
    cam = make_camera()
    world = World(n_pts=260, n_ls=12, seed=9)
    mapper = MapHandler(StereoCamera.create(*MAP_INTR), MapConfig(**MAP_CFG), device="cpu")
    poses = lateral_poses(12, step=0.04)
    mapper.initialize(poses[0], stereo_features_from_numpy(render_features(world, poses[0], cam),
                                                           "cpu"))
    for T in poses[1:]:
        mapper.add_keyframe(T, stereo_features_from_numpy(render_features(world, T, cam), "cpu"),
                            run_ba=False)
    mp = mapper.map
    rng = np.random.default_rng(1)
    eligible = np.where(mp.pt_valid & (mp.pt_nobs >= 2))[0]
    truth = mp.pt_w[eligible].copy()
    mp.pt_w[eligible] = truth + rng.normal(0, 0.03, truth.shape)
    path = str(tmp_path_factory.mktemp("ring") / "map.npz")
    save_map(path, mapper)
    return path, eligible, truth, mp.pt_w[eligible].copy()


@pytest.fixture(scope="module")
def port_runs(toy, ring):
    inputs = {"intrinsics": list(TOY_INTR), "iters": ITERS, "map": ring[0],
              "map_cfg": MAP_CFG, "map_intrinsics": list(MAP_INTR)}
    inputs.update({"toy." + k: v for k, v in toy._asdict().items()})
    inputs["toy.p_lm"] = toy.p_lm % (64 // N_DEV)
    return launch("torch_dist_ranks:run_multihost", N_DEV, inputs, timeout=240,
                  pythonpath=(TESTS,), device_type="cpu")


def test_mesh_layout(port_runs):
    for r, out in enumerate(port_runs):
        assert out["names"].tolist() == ["dcn", "ici"]
        assert out["shape"].tolist() == [2, 4]
        assert out["coord"].tolist() == [r // 4, r % 4]


def test_dist_ba_2d_matches_1d_and_single_device(toy, port_runs):
    got = port_runs[0]
    np.testing.assert_allclose(got["2d.T_c_w"], got["1d.T_c_w"], rtol=0, atol=1e-6)
    prob = ba_problem_from_numpy(toy, "cpu")
    ref, cost, _ = ba.lm_rounds(prob, StereoCamera.create(*TOY_INTR),
                                ba.BAConfig(early_exit=False), prob.p_valid, prob.l_valid, ITERS)
    np.testing.assert_allclose(got["2d.T_c_w"], ref.T_c_w.numpy(), rtol=0, atol=1e-6)
    assert np.isfinite(got["2d.cost"])
    np.testing.assert_allclose(float(got["2d.cost"]), float(cost), rtol=1e-6)


def test_dist_gba_2d_on_real_map(ring, port_runs):
    _, eligible, truth, start = ring
    got = port_runs[0]
    assert int(got["map.n_blocks"]) == N_DEV
    pre = np.median(np.linalg.norm(start - truth, axis=1))
    post = np.median(np.linalg.norm(got["map.pt_w"][eligible] - truth, axis=1))
    assert post < 0.5 * pre, (pre, post)
    assert np.isfinite(got["map.T_w_k"]).all()
    for out in port_runs[1:]:
        for k in ("map.T_w_k", "map.pt_w", "2d.T_c_w", "2d.cost"):
            np.testing.assert_array_equal(out[k], got[k], err_msg=k)


def test_launch_raises_with_the_failing_rank():
    with pytest.raises(RuntimeError, match=r"rank\(s\) \[1\] failed(.|\n)*on purpose"):
        launch("torch_dist_ranks:raise_on_rank", 2, {"rank": 1}, timeout=60,
               pythonpath=(TESTS,), device_type="cpu")


def test_launch_times_out():
    with pytest.raises(RuntimeError, match="timed out after 2 s"):
        launch("torch_dist_ranks:sleep", 2, {"seconds": 60}, timeout=2, pythonpath=(TESTS,),
               device_type="cpu")


def test_initialize_distributed_joins_a_file_group(tmp_path):
    outs = launch("torch_dist_ranks:reinitialize", 2, {"path": str(tmp_path / "init")},
                  timeout=60, pythonpath=(TESTS,), device_type="cpu")
    for out in outs:
        assert out["shape"].tolist() == [1, 2] and out["sum"].tolist() == [3.0]


def test_chip_smoke_phase_11_over_four_ranks():
    """chip_smoke's phase 11 over four ranks (test_torch_gpu_dist.py's path
    over four cards) rehearsed in 4 gloo ranks (test_torch_helpers'
    SMALL_DIST, 4 streams: one per rank): every program against its
    single-device form on each rank, a (2, 2) mesh, the kf-block GBA bit
    for bit the chunked GBA on the same partition, the sharded batch within
    phase 10's bars of the unsharded one."""
    from test_torch_helpers import SMALL_DIST

    outs = launch("torch_dist_ranks:run_chip_smoke_phase_11", 4,
                  {"device": "cpu", "smi": "CPU", "cfg": dict(SMALL_DIST, b=4)}, timeout=240,
                  pythonpath=(TESTS,), device_type="cpu")
    assert len(outs) == 4
    lines = "\n".join(outs[0]["lines"])
    assert "world 4, meshes (4,) and (2, 2)" in lines and "dT=" in lines
    assert "against the unsharded batch bitwise" in lines
    assert lines.count("bit-identical to the chunked GBA on the same partition True") == 2
    assert "chunked GBA float64" in lines
    for out in outs[1:]:
        assert "against the unsharded batch" not in "\n".join(out["lines"])
