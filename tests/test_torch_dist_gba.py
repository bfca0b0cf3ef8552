"""plslam_tpu_torch.parallel.dist_gba in 8 gloo rank processes against
plslam_tpu.parallel.dist_gba on the conftest's 8-device CPU mesh, on the
maps of tests/test_dist_gba.py (_build: 16 lateral keyframes over a
300-point, 16-line World, no local BA; _perturb: points, lines and poses
moved off the truth), Pluecker and endpoint.  Both packages build the map
from the same feature-level keyframes; the port's map goes to the ranks as
a checkpoint (io/checkpoint.py), and each rank routes the GBA through
``PLSLAM.global_bundle_adjustment(mesh=)``.

- the partition equals JAX's ``partition_map`` exactly, and every landmark
  lies in exactly one chunk;
- after the GBA, Pluecker mode: keyframe poses and points within 1e-4 m
  of JAX's distributed GBA, lines within 5e-4 m (test_torch_mapping.py's
  bars: the JAX package's f32 line error is the larger).  Endpoint mode:
  poses within 2e-4 m, points within 2e-3 m, the error to the truth
  within 1.25x of JAX's.  Its f32 solve on this map moves by millimetres
  with the order of its sums; the bars sit just above this test's
  readings on an x86-64 CPU (poses 7.7e-5 m, points 1.14e-3 m at most,
  2.1e-4 m median, error to the truth 1.07x JAX's);
- the ranks' GBA equals the port's chunked GBA run in one process on the
  same partition, bit for bit;
- against the port's single-device GBA on an identical map (other chunks),
  JAX's own bars (test_dist_gba.py): poses within 5e-3, points within
  2e-2, the error to the truth within 1.25x;
- every rank's map is identical after the write-back;
- the chunked GBA in float64 does not move with its chunk split: in f32
  it moves by millimetres through rounding alone."""

import os

import numpy as np
import pytest

from _map_fixtures import World, lateral_poses, make_camera, render_features
from plslam_tpu.backend import mapping as jmap
from plslam_tpu.parallel import dist_gba as jdist
from plslam_tpu.parallel.mesh import make_mesh as jmesh
from plslam_tpu_torch.backend import ba
from plslam_tpu_torch.backend import mapping as tmap
from plslam_tpu_torch.convert import ba_problem_from_numpy, stereo_features_from_numpy
from plslam_tpu_torch.core.camera import StereoCamera
from plslam_tpu_torch.io.checkpoint import load_map, save_map
from plslam_tpu_torch.parallel import dist_gba
from plslam_tpu_torch.parallel.launch import launch
from plslam_tpu_torch.pipeline import PLSLAM

from test_dist_gba import _perturb
from test_torch_helpers import one_torch_thread  # noqa: F401

N_DEV = 8
JCAM = make_camera()
INTR = (458.0, 457.0, 376.0, 240.0, 0.11)
TESTS = os.path.dirname(os.path.abspath(__file__))
MODES = {"plucker": True, "endpoint": False}
POS_TOL = 1e-4
LINE_TOL = 5e-4
EP_POSE_TOL = 2e-4
EP_POINT_TOL = 2e-3


def _cfg(plucker: bool) -> dict:
    return dict(ba_points=512, ba_lines=64, ba_pobs=8192, ba_lobs=512, plucker_lines=plucker)


def _build_pair(plucker: bool):
    """test_dist_gba._build and _perturb on both packages' MapHandlers,
    from the same feature-level keyframes."""
    world = World(n_pts=300, n_ls=16, seed=9)
    poses = lateral_poses(16, step=0.04)
    jm = jmap.MapHandler(JCAM, jmap.MapConfig(**_cfg(plucker)))
    tm = tmap.MapHandler(StereoCamera.create(*INTR), tmap.MapConfig(**_cfg(plucker)),
                         device="cpu")
    for i, T in enumerate(poses):
        f = render_features(world, T, JCAM)
        if i == 0:
            jm.initialize(T, f)
            tm.initialize(T, stereo_features_from_numpy(f, "cpu"))
        else:
            jm.add_keyframe(T, f, run_ba=False)
            tm.add_keyframe(T, stereo_features_from_numpy(f, "cpu"), run_ba=False)
    truth = _perturb(jm, lines=True)
    _perturb(tm, lines=True)
    return jm, tm, truth


@pytest.fixture(scope="module")
def maps(tmp_path_factory):
    d = tmp_path_factory.mktemp("maps")
    out = {}
    for mode, plucker in MODES.items():
        jm, tm, truth = _build_pair(plucker)
        path = str(d / f"{mode}.npz")
        save_map(path, tm)
        out[mode] = dict(jax=jm, port=tm, truth=truth, path=path,
                         pre=dict(pt_w=tm.map.pt_w.copy(), ls_epw=tm.map.ls_epw.copy(),
                                  T=np.stack([k.T_w_k[:3, 3] for k in tm.map.keyframes])))
    return out


@pytest.fixture(scope="module")
def port_runs(maps):
    inputs = {"maps": list(MODES), "intrinsics": list(INTR)}
    for mode, m in maps.items():
        inputs[mode] = m["path"]
        inputs[mode + "_cfg"] = _cfg(MODES[mode])
    return launch("torch_dist_ranks:run_dist_gba", N_DEV, inputs, timeout=240,
                  pythonpath=(TESTS,), device_type="cpu")


@pytest.fixture(scope="module")
def jax_runs(maps):
    """JAX's partition of each map, then its distributed GBA (in place)."""
    mesh = jmesh(N_DEV, axis="kf")
    out = {}
    for mode, m in maps.items():
        out[mode] = jdist.partition_map(m["jax"], N_DEV)
        jdist.distributed_global_bundle_adjustment(m["jax"], mesh)
    return out


@pytest.fixture(scope="module")
def single_runs(maps):
    """The port's single-device GBA on a copy of each map."""
    out = {}
    for mode, m in maps.items():
        mapper = tmap.MapHandler(StereoCamera.create(*INTR), tmap.MapConfig(**_cfg(MODES[mode])),
                                 device="cpu")
        load_map(m["path"], mapper)
        mapper.global_bundle_adjustment()
        out[mode] = mapper
    return out


@pytest.fixture(scope="module")
def chunked_runs(maps):
    """The port's chunked GBA (``ba.bundle_adjust_chunked``) in this process
    on the ranks' partition of a copy of each map, written back as the
    ranks write theirs."""
    out = {}
    for mode, m in maps.items():
        mapper = tmap.MapHandler(StereoCamera.create(*INTR), tmap.MapConfig(**_cfg(MODES[mode])),
                                 device="cpu")
        load_map(m["path"], mapper)
        blk = dist_gba.partition_map(mapper, N_DEV)
        res = ba.bundle_adjust_chunked(ba_problem_from_numpy(blk.prob, "cpu"), mapper.cam,
                                       mapper.ba_cfg)
        p = res.problem
        assert dist_gba.write_back(mapper, blk, (p.T_c_w, p.points, p.lines_orth,
                                                 p.lines_scale, res.p_active, res.l_active))
        out[mode] = mapper.map
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_partition_equals_jax(port_runs, jax_runs, mode):
    want, got = jax_runs[mode], port_runs[0]
    p = mode + "."
    np.testing.assert_array_equal(got[p + "kf_ids"], np.asarray(want.kf_ids))
    np.testing.assert_array_equal(got[p + "block_kf_ids"], np.concatenate(want.block_kfs))
    np.testing.assert_array_equal(got[p + "block_kfs"], [len(b) for b in want.block_kfs])
    for f in ("pt_gid", "own_pt", "ls_gid", "own_ls"):
        np.testing.assert_array_equal(got[p + f], getattr(want, f), err_msg=f)
    np.testing.assert_array_equal(got[p + "p_valid"], np.asarray(want.prob.p_valid))
    # every landmark (and in endpoint mode every endpoint row) in one chunk
    sel = got[p + "own_pt"] & (got[p + "pt_gid"] >= 0)
    owned = np.bincount(got[p + "pt_gid"][sel])
    n = len(want.pt_ids_glob) + (0 if want.plucker else 2 * len(want.ls_ids_glob))
    assert len(owned) == n and (owned == 1).all()


def _pt_err(pts, truth):
    eligible, want, _, _ = truth
    return np.median(np.linalg.norm(pts[eligible] - want, axis=1))


@pytest.mark.parametrize("mode", list(MODES))
def test_gba_matches_jax(maps, port_runs, jax_runs, mode):
    got, p = port_runs[0], mode + "."
    assert bool(got[p + "routed"])
    jm = maps[mode]["jax"].map
    T_jax = np.stack([k.T_w_k for k in jm.keyframes])
    np.testing.assert_array_equal(got[p + "pobs_valid"], jm.pobs.valid[: jm.pobs.n])
    np.testing.assert_array_equal(got[p + "lobs_valid"], jm.lobs.valid[: jm.lobs.n])
    if mode == "endpoint":
        np.testing.assert_allclose(got[p + "T_w_k"], T_jax, rtol=0, atol=EP_POSE_TOL)
        valid = jm.pt_valid
        np.testing.assert_allclose(got[p + "pt_w"][valid], jm.pt_w[valid], rtol=0,
                                   atol=EP_POINT_TOL)
        truth = maps[mode]["truth"]
        assert _pt_err(got[p + "pt_w"], truth) < 1.25 * _pt_err(jm.pt_w, truth) + 1e-4
        return
    np.testing.assert_allclose(got[p + "T_w_k"], T_jax, rtol=0, atol=POS_TOL)
    valid = jm.pt_valid
    np.testing.assert_allclose(got[p + "pt_w"][valid], jm.pt_w[valid], rtol=0, atol=POS_TOL)
    lv = jm.ls_valid
    Lb = got[p + "ls_w"][lv]
    np.testing.assert_allclose(Lb[:, 3:], jm.ls_w[lv][:, 3:], rtol=0, atol=POS_TOL)
    # the JAX package's endpoints lie on the port's lines
    x = jm.ls_epw[lv]
    dist = np.linalg.norm(np.cross(x, Lb[:, None, 3:]) - Lb[:, None, :3], axis=-1)
    assert dist.max() < LINE_TOL, dist.max()


@pytest.mark.parametrize("mode", list(MODES))
def test_gba_matches_single_device(maps, port_runs, single_runs, mode):
    got, p = port_runs[0], mode + "."
    single = single_runs[mode].map
    eligible, _, l_eligible, l_truth = maps[mode]["truth"]
    pre = maps[mode]["pre"]
    dpose = np.abs(got[p + "T_w_k"] - np.stack([k.T_w_k for k in single.keyframes])).max()
    assert dpose < 5e-3, dpose
    if mode == "plucker":
        dx = np.abs(got[p + "pt_w"][eligible] - single.pt_w[eligible]).max()
        assert dx < 2e-2, dx
    t = maps[mode]["truth"]
    post = _pt_err(got[p + "pt_w"], t)
    assert post < 0.5 * _pt_err(pre["pt_w"], t)
    assert post < 1.25 * _pt_err(single.pt_w, t) + 1e-4
    gt = np.stack([T[:3, 3] for T in lateral_poses(16, step=0.04)])
    assert (np.linalg.norm(got[p + "T_w_k"][:, :3, 3] - gt, axis=1).mean()
            < np.linalg.norm(pre["T"] - gt, axis=1).mean())
    if mode == "endpoint":
        lerr = lambda e: np.linalg.norm(  # noqa: E731
            (e[l_eligible] - l_truth).reshape(len(l_eligible), -1), axis=1)
        assert np.median(lerr(got[p + "ls_epw"])) < np.median(lerr(pre["ls_epw"]))
        d = got[p + "ls_w"][l_eligible][:, 3:]
        assert np.allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-6)


@pytest.mark.parametrize("mode", list(MODES))
def test_gba_matches_the_chunked_gba_on_the_same_partition(port_runs, chunked_runs, mode):
    """The ranks' GBA equals ``ba.bundle_adjust_chunked`` run in one process
    on the same chunks, bit for bit: the chunk partials are summed in
    chunk order on every rank (a dropped rank's or chunk's partials would
    show at once)."""
    got, p, want = port_runs[0], mode + ".", chunked_runs[mode]
    for k, w in (("T_w_k", np.stack([k.T_w_k for k in want.keyframes])), ("pt_w", want.pt_w),
                 ("ls_w", want.ls_w), ("ls_epw", want.ls_epw),
                 ("pobs_valid", want.pobs.valid[: want.pobs.n]),
                 ("lobs_valid", want.lobs.valid[: want.lobs.n])):
        np.testing.assert_array_equal(got[p + k], w, err_msg=k)


def test_every_rank_holds_the_same_map(port_runs):
    for out in port_runs[1:]:
        for k in out:
            np.testing.assert_array_equal(out[k], port_runs[0][k], err_msg=k)


def test_pipeline_routes_gba_to_mesh(monkeypatch):
    """Without a mesh the single-device GBA runs; a mesh of more than one
    rank went to the distributed GBA in every rank above (``routed``)."""
    calls = []

    class FakeMapper:
        def global_bundle_adjustment(self):
            calls.append("single")
            return "single"

    monkeypatch.setattr("plslam_tpu_torch.pipeline.distributed_global_bundle_adjustment",
                        lambda mapper, mesh: calls.append("dist"))
    slam = PLSLAM.__new__(PLSLAM)
    slam.mapper = FakeMapper()
    assert slam.global_bundle_adjustment() == "single"
    with pytest.raises(TypeError, match="DeviceMesh"):
        slam.global_bundle_adjustment(mesh=object())
    assert calls == ["single"]


def test_ring_map_matches_the_dry_run():
    """io/ring_map.build_ring_map (chip_smoke phase 11's map) holds the
    tables of the JAX package's multichip dry-run map, at a small size."""
    from __graft_entry__ import _build_ring_map
    from plslam_tpu_torch.io.ring_map import build_ring_map

    kw = dict(rng_seed=3, n_kf=8, n_pts=600, n_ls=60, pose_noise=0.01, lm_noise=0.03)
    jm, (jT, jtruth) = _build_ring_map(**kw)
    tm, (tT, ttruth) = build_ring_map(**kw, device="cpu")
    np.testing.assert_array_equal(tT, jT)
    np.testing.assert_array_equal(ttruth, jtruth)
    a, b = jm.map, tm.map
    np.testing.assert_array_equal(np.stack([k.T_w_k for k in b.keyframes]),
                                  np.stack([k.T_w_k for k in a.keyframes]))
    for f in ("pt_w", "pt_valid", "ls_w", "ls_epw", "ls_valid", "covis"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f)
    for ta, tb in ((a.pobs, b.pobs), (a.lobs, b.lobs)):
        assert ta.n == tb.n
        for f in ("valid", "lm", "kf", "fi"):
            np.testing.assert_array_equal(getattr(tb, f)[: tb.n], getattr(ta, f)[: ta.n])
    for ka, kb in zip(a.keyframes, b.keyframes):
        np.testing.assert_array_equal(kb.pt_lm, ka.pt_lm)
        np.testing.assert_array_equal(kb.ls_lm, ka.ls_lm)
        np.testing.assert_array_equal(kb.pt_uv, np.asarray(ka.pt_uv))
    assert tm.cfg.ba_pobs == jm.cfg.ba_pobs and tm.ba_cfg.iters1 == jm.ba_cfg.iters1 == 3


def test_chunked_gba_does_not_move_with_the_chunk_split_in_f64(maps):
    """The chunked GBA's chunk split changes only the order of its f32
    sums: in float64, 1, 2 and 4 chunks of the Pluecker map agree to
    1e-9 m (in f32 they differ by millimetres, chip_smoke phase 11 on the
    32-keyframe ring)."""
    mapper = tmap.MapHandler(StereoCamera.create(*INTR), tmap.MapConfig(**_cfg(True)),
                             device="cpu")
    load_map(maps["plucker"]["path"], mapper)
    out = []
    for n in (1, 2, 4):
        blk = dist_gba.partition_map(mapper, n)
        assert len(blk.metas) == n
        prob = ba_problem_from_numpy(blk.prob, "cpu")
        prob = prob._replace(**{f: v.double() for f, v in prob._asdict().items()
                                if v is not None and v.is_floating_point()})
        res = ba.bundle_adjust_chunked(prob, mapper.cam, mapper.ba_cfg)
        pts = np.zeros((len(blk.pt_ids_glob), 3))
        own = blk.own_pt & (blk.pt_gid >= 0)
        pts[blk.pt_gid[own]] = res.problem.points.numpy()[own]
        out.append((res.problem.T_c_w.numpy(), pts))
    for T, pts in out[1:]:
        np.testing.assert_allclose(T, out[0][0], rtol=0, atol=1e-9)
        np.testing.assert_allclose(pts, out[0][1], rtol=0, atol=1e-9)
