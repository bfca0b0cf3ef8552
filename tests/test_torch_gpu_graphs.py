"""The captured programs on the card (``plslam_tpu_torch.graphs``): graphed
and eager (``capture=False``) VO, batched VO, local BA, the mapper's
per-keyframe programs (the fused association, KF2KF, Map2KF, the
refinement), the loop closer's BoW transform and verification pose solve,
and the programs captured one trip at a time (the chunked GBA on a
problem of 3 chunks and on phase 5's SLAM map, the PGO on a ring
closure's pose graph) bit for bit, the launch accounting of replays, a
capture that fails raising instead of running eagerly, a capture after
the caching allocator's cache has filled the card, ``graphs.stats()``
with a released program alive, and PLSLAM fed uint8 pairs from pinned
memory bit for bit as fed their float32 twins.

Marked ``gpu``; each test skips when no CUDA device is present.  On a
machine with one (``--noconftest``: its tests/conftest.py imports jax):
    python -m pytest -m gpu --noconftest tests/test_torch_gpu_graphs.py
"""

import copy
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _program_inputs as pi
from plslam_tpu_torch import graphs
from plslam_tpu_torch.backend import ba, pgo, vocab
from plslam_tpu_torch.backend.loop import LoopCloser, LoopConfig
from plslam_tpu_torch.backend.mapping import KeyframeRecord, MapConfig, MapHandler
from plslam_tpu_torch.convert import (ba_problem_from_numpy, pose_graph_from_numpy,
                                      stereo_features_from_numpy)
from plslam_tpu_torch.batch_vo import BatchedVisualOdometry
from plslam_tpu_torch.bench_slam import LBA_CAM, local_ba_problem
from plslam_tpu_torch.core.camera import StereoCamera
from plslam_tpu_torch.frontend.frame import FrontendConfig
from plslam_tpu_torch.frontend.tracker import TrackerConfig
from plslam_tpu_torch.io import SyntheticScene, circular_trajectory
from plslam_tpu_torch.ops import cuda_hamming
from plslam_tpu_torch.pipeline import PLSLAM
from plslam_tpu_torch.vo import VisualOdometry

pytestmark = pytest.mark.gpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(SPEC)
SPEC.loader.exec_module(chip_smoke)

FCFG = FrontendConfig(n_points=1200, n_lines=256)
N_FRAMES = 6


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: CUDA graphs run only on the card")
    return torch.device("cuda:0")


def _scene_frames(dev, seed=0, n=N_FRAMES):
    scene = SyntheticScene(n_points=600, n_lines=60, seed=seed, width=752, height=480,
                           fx=435.2, fy=435.2, cx=367.4, cy=252.2)
    frames = [tuple(torch.from_numpy(x).to(dev) for x in scene.render_stereo(T, noise=1.0))
              for T in circular_trajectory(n, step_t=0.05)]
    cam = StereoCamera.create(scene.fx, scene.fy, scene.cx, scene.cy, scene.b,
                              width=scene.width, height=scene.height)
    return cam, frames


def test_graphed_vo_equals_eager(dev):
    """Every field of every frame's result, across a mark_keyframe, and the
    state after the last frame; one capture, one replay per frame."""
    cam, frames = _scene_frames(dev)
    runs = []
    for capture in (True, False):
        vo = VisualOdometry(cam, FCFG, TrackerConfig(), device=dev, capture=capture)
        vo.initialize(*frames[0])
        out = []
        for i in range(1, N_FRAMES):
            out.append(vo.process(*frames[i]))
            if i == 2:
                vo.mark_keyframe()
        runs.append((vo, out))
    (g, gres), (e, eres) = runs
    assert g.programs()[0].captured and not e.programs()[0].captured
    assert g.programs()[0].replays == N_FRAMES - 1
    for a, b in zip(gres, eres):
        assert chip_smoke.results_equal(a, b)
    for a, b in zip(g.state, e.state):
        if isinstance(a, torch.Tensor):
            assert chip_smoke.bits_equal(a, b)
    assert all(bool(r.good) for r in gres)


def test_graphed_batch_equals_eager(dev):
    cams_frames = [_scene_frames(dev, seed=s) for s in (0, 1)]
    cam = cams_frames[0][0]
    L = [torch.stack([cf[1][i][0] for cf in cams_frames]) for i in range(N_FRAMES)]
    R = [torch.stack([cf[1][i][1] for cf in cams_frames]) for i in range(N_FRAMES)]
    runs = []
    for capture in (True, False):
        bvo = BatchedVisualOdometry(2, cam, FCFG, TrackerConfig(), device=dev, capture=capture)
        bvo.initialize(L[0], R[0])
        out = []
        for i in range(1, N_FRAMES):
            out.append(bvo.process(L[i], R[i]))
            if i == 2:
                bvo.mark_keyframe([False, True])
        runs.append((bvo, out))
    assert runs[0][0].programs()[0].captured
    for a, b in zip(runs[0][1], runs[1][1]):
        assert chip_smoke.results_equal(a, b)


def test_graphed_local_ba_equals_eager(dev):
    """The mapper's bucket program (uploads, bundle_adjust, Plücker output,
    packed result) graphed and eager on bench_slam.py's problem; a second
    solve of the bucket replays and leaves the first result as it was."""
    prob = local_ba_problem("cpu")
    prob = type(prob)(*(None if x is None else x.numpy() for x in prob))
    cam = StereoCamera.create(*LBA_CAM)
    outs = []
    for capture in (True, False):
        mapper = MapHandler(cam, MapConfig(), device=dev, capture=capture)
        out, _ = mapper._solve_local(prob, {"lines_plucker": None})
        outs.append((mapper, out))
    (gm, gout), (_, eout) = outs
    assert gm.graph_stats()["local_ba"]["captured"] == 1
    assert chip_smoke.bits_equal(gout, eout)
    keep = gout.clone()
    moved = prob._replace(points=prob.points + np.float32(0.01))
    again, _ = gm._solve_local(moved, {"lines_plucker": None})
    assert gm.graph_stats()["local_ba"]["built"] == 1
    assert chip_smoke.bits_equal(gout, keep) and not chip_smoke.bits_equal(again, gout)


def _keyframe_programs(mapper, dev, seed):
    """Each of the mapper's per-keyframe programs once on tests/
    _program_inputs.py's inputs (seeded; each seed its own keyframe pair
    on the ring), as host copies."""
    pair = pi.keyframe_pair(seed, theta=0.3 + 0.2 * seed)
    world, T0, T1, f0, f1 = pair
    Tm, cpack, dpack, cval, pt_lm, ls_lm, pf = pi.assoc_inputs(pair, seed)
    prev = KeyframeRecord(0, T0, stereo_features_from_numpy(f0, dev))
    prev.pt_lm, prev.ls_lm = pt_lm, ls_lm
    dk = stereo_features_from_numpy(f1, dev)
    vpack = np.concatenate([cval, pi.free_mask(seed, f1)])
    T_c_w = np.linalg.inv(T1).astype(np.float32)
    return {"assoc": mapper._assoc(prev, dk, Tm, cpack, dpack, cval, pf, 256, 64).cpu(),
            "kf2kf": mapper._kf2kf(prev, dk, Tm[0]).cpu(),
            "map2kf": mapper._map2kf(dk, T_c_w, cpack, dpack, vpack, 256, 64).cpu(),
            "refine": mapper._refine(pi.refine_arrays(seed, f0, T0, T1)).cpu()}


@pytest.mark.parametrize("plucker", [True, False])
def test_graphed_keyframe_programs_equal_eager(dev, plucker):
    """The fused association, KF2KF, Map2KF and the refinement, graphed and
    eager, on two keyframe pairs: one capture per program kind (on the
    first call, which then replays), every output bit for bit."""
    cfg = MapConfig(plucker_lines=plucker, has_refinement=not plucker)
    runs = []
    for capture in (True, False):
        mapper = MapHandler(pi.port_camera(), cfg, device=dev, capture=capture)
        runs.append((mapper, [_keyframe_programs(mapper, dev, seed) for seed in (0, 1)]))
    (gm, gouts), (_, eouts) = runs
    stats = gm.graph_stats()
    for kind in ("assoc", "kf2kf", "map2kf", "refine"):
        assert (stats[kind]["captured"], stats[kind]["replays"]) == (1, 2), (kind, stats[kind])
        for g, e in zip(gouts, eouts):
            assert chip_smoke.bits_equal(g[kind], e[kind]), kind
        assert not chip_smoke.bits_equal(gouts[0][kind], gouts[1][kind]), kind


def test_graphed_bow_transform_equals_eager(dev):
    """The shipped DBoW2 point and line vocabularies' transforms, graphed
    and eager, on two descriptor sets each."""
    outs = []
    for capture in (True, False):
        mapper = MapHandler(pi.port_camera(), MapConfig(plucker_lines=False), device=dev,
                            capture=capture)
        lc = LoopCloser(pi.port_camera(), mapper, LoopConfig())
        lc.voc = vocab.load_dbow2_vocabulary(
            os.path.join(ROOT, "configs", "vocab_orb_k10L3.yml.gz")).to(dev)
        lc.voc_l = vocab.load_dbow2_vocabulary(
            os.path.join(ROOT, "configs", "vocab_lbd_k10L3.yml.gz")).to(dev)
        outs.append([lc._transform(w, *pi.descriptors(s, n, n // 2)).cpu()
                     for s in (0, 1) for w, n in (("p", 1200), ("l", 256))])
        if capture:
            st = lc.programs.stats()
            assert (st["captured"], st["replays"]) == (2, 4), st
    for g, e in zip(*outs):
        assert chip_smoke.bits_equal(g, e)


def _graphed_trips(report: dict, total: int) -> bool:
    return (report["eager"], report["replayed"], report["captured"]) == \
        (graphs.WARMUP, total - graphs.WARMUP, True) and report["pool_bytes"] > 0


@pytest.mark.parametrize("endpoint", [False, True], ids=["plucker", "endpoint"])
def test_graphed_chunked_gba_equals_eager(dev, endpoint):
    """The chunked GBA (f32, as the mapper runs it) on 3 chunks: the two
    warm-ups, then one captured LM trip replayed for the other 13; every
    output bit for bit the eager loop's."""
    d = pi.chunked_problem(seed=1, C=3, K=8, P=96, L=16, endpoint=endpoint, dtype=np.float32)
    cam = StereoCamera.create(*pi.GBA_INTR)
    cfg = ba.BAConfig()
    runs = []
    for capture in (True, False):
        report = {}
        res = ba.bundle_adjust_chunked(ba_problem_from_numpy(d, dev), cam, cfg,
                                       capture=capture, report=report)
        runs.append((res, report))
    (g, greport), (e, ereport) = runs
    assert _graphed_trips(greport, cfg.iters1 + cfg.iters2), greport
    assert (ereport["eager"], ereport["replayed"]) == (cfg.iters1 + cfg.iters2, 0)
    for a, b in zip((g.problem.T_c_w, g.problem.points, g.problem.lines_orth, g.p_active,
                     g.l_active, g.cost),
                    (e.problem.T_c_w, e.problem.points, e.problem.lines_orth, e.p_active,
                     e.l_active, e.cost)):
        assert chip_smoke.bits_equal(a, b)
    assert not torch.equal(g.problem.T_c_w.cpu(), torch.from_numpy(d["T_c_w"]))


def test_graphed_gba_on_the_slam_map_equals_eager(dev):
    """PLSLAM at chip_smoke phase 5's configuration over its 20 frames,
    then the GBA at finish on two copies of the map it left, graphed and
    eager: the keyframe poses, the landmarks and the trips."""
    scene = SyntheticScene(n_points=600, n_lines=60, seed=0, width=752, height=480,
                           fx=435.2, fy=435.2, cx=367.4, cy=252.2)
    cam, _, frames = chip_smoke.slam_frames(dev, scene)
    cfg, mcfg = chip_smoke.slam_configs()
    slam = PLSLAM(cam, cfg, mcfg, device=dev)
    for i, fr in enumerate(frames):
        slam.process(*fr, timestamp=0.05 * i)
    slam.finish(run_gba=False)
    slam.mapper.flush_ba()
    out = []
    for capture in (True, False):
        m = slam.mapper
        fresh = MapHandler(m.cam, m.cfg, m.ba_cfg, tracker_cfg=m.tracker_cfg, device=dev,
                           capture=capture)
        fresh.map = copy.deepcopy(m.map)
        fresh.global_bundle_adjustment()
        out.append((fresh.gba_trips, fresh.keyframe_trajectory(), fresh.map.pt_w.copy()))
    (gt, gtraj, gpts), (et, etraj, epts) = out
    total = slam.mapper.ba_cfg.iters1 + slam.mapper.ba_cfg.iters2
    assert _graphed_trips(gt, total) and (et["eager"], et["replayed"]) == (total, 0)
    assert len(gtraj) >= 8 and all(np.array_equal(a, b) for a, b in zip(gtraj, etraj))
    assert np.array_equal(gpts, epts)
    assert not all(np.array_equal(a, b) for a, b in zip(gtraj, slam.keyframe_trajectory()))


def test_graphed_pgo_equals_eager(dev):
    """The PGO of a closure on the 156-keyframe ring (25 iterations, f64
    cholesky_ex at 936 x 936): 23 iterations replay one captured
    iteration; the poses bit for bit the eager loop's."""
    tg = pose_graph_from_numpy(pi.ring_pose_graph(seed=0, K=156), dev)
    runs = []
    for capture in (True, False):
        report = {}
        runs.append((pgo.optimize(tg, 25, capture=capture, report=report).T_w_k, report))
    (g, greport), (e, ereport) = runs
    assert _graphed_trips(greport, 25), greport
    assert (ereport["eager"], ereport["replayed"]) == (25, 0)
    assert chip_smoke.bits_equal(g, e) and not torch.equal(g, tg.T_w_k)


@pytest.mark.parametrize("use_lines", [False, True], ids=["points", "points_lines"])
def test_graphed_verification_equals_eager(dev, use_lines):
    """The loop verification on two ring keyframes, its pose solve one
    program per bucket: (ok, DT, pairs) graphed and eager, bit for bit;
    one capture, every solve a replay."""
    _, T0, T1, f0, f1 = pi.keyframe_pair(seed=3, step=0.06)
    outs = []
    for capture in (True, False):
        mapper = MapHandler(pi.port_camera(), MapConfig(plucker_lines=False, use_lines=use_lines),
                            device=dev, capture=capture)
        for i, (T, f) in enumerate(((T0, f0), (T1, f1))):
            mapper.map.keyframes.append(KeyframeRecord(i, T, stereo_features_from_numpy(f, dev)))
        lc = LoopCloser(pi.port_camera(), mapper, LoopConfig())
        outs.append([lc._verify_candidate(1, 0), lc._verify_candidate(1, 0)])
        if capture:
            assert lc.solve_counts == {"solves": 2, "captures": 1, "replays": 2}, \
                lc.solve_counts
    for g, e in zip(*outs):
        assert g[0] and e[0]
        for a, b in zip(g[1:], e[1:]):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_replays_count_their_launches(dev):
    """A capture records the wrappers' launches without counting them;
    each replay counts them on the replaying thread."""
    g = torch.Generator().manual_seed(0)
    d1 = torch.randint(-2**31, 2**31 - 1, (64, 8), generator=g, dtype=torch.int32).to(dev)
    d2 = torch.randint(-2**31, 2**31 - 1, (48, 8), generator=g, dtype=torch.int32).to(dev)
    wrapper = cuda_hamming.hamming_distance_matrix_cuda
    n0 = wrapper.launches
    prog = graphs.Program(lambda: wrapper(d1, wrapper(d1, d2)[:, :8].contiguous()), dev)
    warm = 2 * graphs.WARMUP
    assert wrapper.launches == n0 + warm       # the warm-up ran; the capture did not count
    assert prog.launches_per_replay() == {"hamming_distance_matrix_cuda": 2}
    for _ in range(3):
        out = prog()
    torch.cuda.synchronize()
    assert wrapper.launches == n0 + warm + 6 and prog.replays == 3
    assert torch.equal(out, wrapper(d1, wrapper(d1, d2)[:, :8].contiguous()))


def test_stats_with_a_released_program_alive_and_the_capture_timed(dev):
    """``graphs.stats()`` skips a released program that is still alive,
    and ``graphs.captures()`` counts as it does; the capture is timed (``graphs.capture``) and a staged program's wait
    for its last replay too (``graphs.staged.wait``), on this thread."""
    from plslam_tpu_torch.utils.profiling import counters

    me, n_cap = counters().get("MainThread", {}), graphs.captures()
    x = torch.ones(1024, device=dev)
    prog = graphs.Program(lambda: x * 2, dev)
    held = graphs.Program(lambda: x + 1, dev)
    live = graphs.stats()
    prog()
    torch.cuda.synchronize()
    prog.release()
    st = graphs.stats()
    assert prog.graph is None and st["live"] == live["live"] - 1
    assert 0 < st["pool_bytes"] <= live["pool_bytes"]
    staged = graphs.StagedProgram(lambda inp: inp["a"] * 2, {"a": np.ones(8, np.float32)}, dev)
    staged({"a": np.ones(8, np.float32)})
    staged({"a": np.ones(8, np.float32)})
    after = counters()["MainThread"]
    assert after["graphs.capture.calls"] - me.get("graphs.capture.calls", 0) == 3
    assert after["graphs.capture.ns"] > me.get("graphs.capture.ns", 0)
    assert after["graphs.staged.wait.calls"] - me.get("graphs.staged.wait.calls", 0) == 1
    assert graphs.captures() == n_cap + 3 == graphs.stats()["captures"]
    del held


def _upload_run(dev, cam, pairs, pinned: bool):
    """PLSLAM at phase 5's configuration over ``pairs``: from one pinned
    uint8 pair buffer that is overwritten as soon as each ``process``
    returns, or as they are (float32 on the card).  Per frame: the first
    frame's features, then each tracked frame's pose and host record; the
    logs without their times; the main thread's counters' increase."""
    from plslam_tpu_torch.utils.profiling import counters

    cfg, mcfg = chip_smoke.slam_configs()
    slam = PLSLAM(cam, cfg, mcfg, device=dev)
    src = torch.empty((2,) + tuple(pairs[0][0].shape), dtype=torch.uint8, pin_memory=True)
    before = counters().get("MainThread", {})
    out = []
    for i, (il, ir) in enumerate(pairs):
        if pinned:
            src[0].copy_(il)
            src[1].copy_(ir)
            res = slam.process(src[0], src[1], timestamp=0.05 * i)
            src.fill_(0)
        else:
            res = slam.process(il, ir, timestamp=0.05 * i)
        if res is None:
            out.append(graphs.leaves(slam.vo.current_features))
        else:
            out.append((res.T_f_w.clone(), slam.vo.frame_record.cpu()))
    slam.finish(run_gba=False)
    after = counters()["MainThread"]
    logs = [{k: v for k, v in vars(lg).items() if k != "t_total"} for lg in slam.logs]
    return out, logs, {k: after[k] - before.get(k, 0) for k in after}


def test_pinned_uint8_pairs_track_as_their_float_twins(dev):
    """Phase 5's 20 frames rounded to uint8: handed from a pinned buffer
    (copied asynchronously, cast on the card) and as float32 on the card,
    the first frame's features, every pose, host record and log bit for
    bit; overwriting the pinned source as soon as ``process`` returns
    changes nothing, the first frame included."""
    scene = SyntheticScene(n_points=600, n_lines=60, seed=0, width=752, height=480,
                           fx=435.2, fy=435.2, cx=367.4, cy=252.2)
    cam, _, frames = chip_smoke.slam_frames(dev, scene)
    u8 = [tuple(x.round().clamp(0, 255).to(torch.uint8).cpu() for x in fr) for fr in frames]
    f32 = [tuple(x.to(dev).float() for x in fr) for fr in u8]
    n = len(u8)
    (ou, lu, cu), (of, lf, cf) = (_upload_run(dev, cam, u8, True),
                                  _upload_run(dev, cam, f32, False))
    assert n >= 20 and len(lu) == n - 1 and lu == lf
    first_u, first_f = ou[0], of[0]
    assert first_u.keys() == first_f.keys()
    assert all(chip_smoke.bits_equal(first_u[k], first_f[k]) for k in first_u)
    for (tu, ru), (tf, rf) in zip(ou[1:], of[1:]):
        assert chip_smoke.bits_equal(tu, tf) and chip_smoke.bits_equal(ru, rf)
    assert cu["pipeline.upload.async"] == cu["pipeline.upload.on_card_cast"] == 2 * n
    assert cf.get("pipeline.upload.async", 0) == cf.get("pipeline.upload.on_card_cast", 0) == 0
    assert cu["pipeline.upload.calls"] == cf["pipeline.upload.calls"] == n


def test_a_capture_that_syncs_raises(dev):
    """A function that syncs with the host cannot be captured: the Program
    raises, and nothing runs it eagerly in its place (in a fresh process:
    a failed capture leaves the allocator's capture bookkeeping behind)."""
    code = ("import torch\n"
            "from plslam_tpu_torch import graphs\n"
            "x = torch.ones(4, device='cuda')\n"
            "try:\n"
            "    graphs.Program(lambda: x.sum().item(), 'cuda')\n"
            "    print('captured')\n"
            "except RuntimeError as e:\n"
            "    print('raised', graphs.stats()['captures'], str(e).splitlines()[0])\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("raised 0"), proc.stdout


# A fresh process: a graph whose body allocates 4 GiB is captured and
# dropped, then 8 GiB and 1 GiB blocks are allocated until the card has
# 12-13 GiB free and freed again, so the allocator keeps them cached.  A
# program whose body allocates 8 GiB (one int64 temporary) must then
# capture.  Its warm-ups run on a side stream, whose allocations reuse no
# block cached on another stream: the first takes 8 GiB of the free
# memory (a warm-up that found no room would have the allocator free the
# cache itself) and leaves 4-5 GiB free.  The allocator frees no cached
# block while a capture is underway, so the capture's 8 GiB fit only if
# the cache was emptied before it.  Prints one JSON line.
FULL_CARD = """
import json
import torch
from plslam_tpu_torch import graphs

GiB = 1 << 30
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(0)
y = torch.randint(0, 1000, (GiB // 2,), device=dev, dtype=torch.int64, generator=g)
dropped = graphs.Program(lambda: (y * 2).sum(), dev)
dead_pool = tuple(dropped.graph.pool())
dropped.release()
del dropped
blocks = []
for size, keep in ((8 * GiB, 20 * GiB), (GiB, 13 * GiB)):
    while torch.cuda.mem_get_info(dev)[0] >= keep:
        blocks.append(torch.empty(size, dtype=torch.uint8, device=dev))
cached = sum(b.numel() for b in blocks)
del blocks


def body():
    return torch.cat([y, y]).sum()


free = torch.cuda.mem_get_info(dev)[0]
try:
    prog = graphs.Program(body, dev)
except torch.OutOfMemoryError as e:
    print(json.dumps({"oom": str(e).splitlines()[0], "free": free}))
    raise SystemExit(0)
out = prog().clone()
st = graphs.stats()
pools = {tuple(s.get("segment_pool_id", ())) for s in torch.cuda.memory_snapshot()}
print(json.dumps({"free": free, "need": prog.need, "cached": cached, "captured": prog.captured,
                  "equal": bool(torch.equal(out, body())), "replays": prog.replays,
                  "releases": st["releases"], "released_bytes": st["released_bytes"],
                  "dead_pool_held": dead_pool in pools}))
"""


def test_a_capture_after_the_cache_fills_the_card(dev):
    """The fault of a long process: the caching allocator holds the card.
    The program captures (the cache emptied once, before the capture, with
    the dropped graph's pool in it), and its replay equals the body run
    eagerly bit for bit.  In a fresh process, as the test above."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", FULL_CARD], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    r = json.loads(proc.stdout.splitlines()[-1])
    assert "oom" not in r, r
    assert r["free"] < 13 << 30 and r["need"] >= 8 << 30, r
    assert r["captured"] and r["equal"] and r["replays"] == 1, r
    assert r["releases"] == 1 and r["released_bytes"] >= r["cached"], r
    assert not r["dead_pool_held"], r
