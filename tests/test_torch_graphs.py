"""The captured-program layer on the CPU (``plslam_tpu_torch.graphs``):
the static-buffer trackers run the same in-place function there that the
card captures, so these tests hold that function.

- ``VisualOdometry`` over static buffers equals the functional step bit
  for bit, across a ``mark_keyframe``; a JAX state assigned to
  ``vo.state`` continues to the JAX package's poses; what a frame hands
  out does not change when the next frame runs (the batched tracker:
  tests/test_torch_graphs_batch.py).
- The local BA's bucket program equals the eager ``bundle_adjust``
  composition bit for bit; a deferred result survives a later solve of
  the same bucket; the LRU of buckets evicts the oldest.
- The (21,) frame pack equals the JAX package's ``_pack_frame_scalars``.
- ``pack``/``unpack`` and the launch accounting of a replay.
376x240, 4 frames."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam_tpu import vo as jvo
from plslam_tpu.core.camera import StereoCamera as JCam
from plslam_tpu.frontend.frame import FrontendConfig as JFcfg
from plslam_tpu.frontend.tracker import TrackerConfig as JTcfg
from plslam_tpu.io.synthetic import SyntheticScene, circular_trajectory
from plslam_tpu.pipeline import PLSLAM as JPLSLAM
from plslam_tpu_torch import convert, graphs
from plslam_tpu_torch.backend import ba
from plslam_tpu_torch.backend.mapping import MapConfig, MapHandler
from plslam_tpu_torch.core.camera import StereoCamera
from plslam_tpu_torch.core.plucker import orth_to_plucker, plucker_to_orth
from plslam_tpu_torch.frontend.frame import FrontendConfig
from plslam_tpu_torch.frontend.tracker import TrackerConfig
from plslam_tpu_torch.ops import cuda_lib
from plslam_tpu_torch.vo import FrameResult, VisualOdometry, frame_scalars, step

from test_ba import make_problem
from test_torch_helpers import (ate_within_jax, bits_equal, mark_keyframe_fn,  # noqa: F401
                                one_torch_thread, port_cam, results_equal, to_np,
                                tree_equal, tt)

N_FRAMES = 4
FCFG = dict(n_points=256, n_lines=64)
KF_AT = 1          # mark_keyframe after this frame


@pytest.fixture(scope="module")
def scene_frames():
    scene = SyntheticScene(seed=3)
    frames = [scene.render_stereo(T, noise=1.0) for T in circular_trajectory(N_FRAMES, step_t=0.05)]
    return scene, frames


# ---------------------------------------------------------------------------
# VisualOdometry


@pytest.fixture(scope="module")
def vo_run(scene_frames):
    """The static-buffer VO over the frames (a keyframe marked after
    KF_AT), with copies of what each frame handed out taken at once."""
    scene, frames = scene_frames
    vo = VisualOdometry(port_cam(scene), FrontendConfig(**FCFG), TrackerConfig(), device="cpu")
    vo.initialize(*(tt(x) for x in frames[0]))
    state0 = vo.state
    results, feats, kept = [], [], []
    for i in range(1, N_FRAMES):
        r = vo.process(*(tt(x) for x in frames[i]))
        f = vo.current_features
        results.append(r)
        feats.append(f)
        kept.append((graphs.tree_clone(r), graphs.tree_clone(f), vo.frame_scalars.clone()))
        if i == KF_AT:
            vo.mark_keyframe()
    return vo, state0, results, feats, kept


def test_static_vo_equals_the_functional_step(scene_frames, vo_run):
    scene, frames = scene_frames
    vo, state, results, _, _ = vo_run
    for i in range(1, N_FRAMES):
        want, state = step(torch.stack([tt(x) for x in frames[i]]), state, vo.cam, vo.fcfg,
                           vo.tcfg, vo.params)
        assert results_equal(results[i - 1], want), i
        if i == KF_AT:
            state = mark_keyframe_fn(state)
    assert tree_equal(vo.state, state)
    assert all(bool(r.good) for r in results)


def test_vo_results_and_features_are_not_aliased(vo_run):
    """Frame i's result, its handed-off features and its scalar pack stay
    as they were after the later frames ran."""
    _, _, results, feats, kept = vo_run
    for r, f, (r0, f0, sc0) in zip(results, feats, kept):
        assert results_equal(r, r0)
        assert tree_equal(f, f0)
    assert not bits_equal(results[0].T_f_w, results[-1].T_f_w)
    assert not bits_equal(kept[0][2], kept[-1][2])


def test_state_is_a_copy_and_assignment_copies_in(vo_run):
    vo = vo_run[0]
    st = vo.state
    keep = st.T_f_w.clone()
    st.T_f_w.zero_()
    assert bits_equal(vo.pose, keep)
    buffers = vo._state
    vo.state = st
    assert vo._state is buffers and not vo.pose.any()
    vo.state = vo_run[1]
    assert vo._state is buffers


def test_frame_scalars_equal_the_jax_pack(vo_run):
    """``frame_scalars`` of a result equals ``PLSLAM._pack_frame_scalars`` of
    the JAX package on the same values, and the VO's per-frame pack is that
    of the result it returned."""
    _, _, results, _, kept = vo_run
    for r, (_, _, sc) in zip(results, kept):
        jres = jvo.FrameResult(**{k: jnp.asarray(getattr(to_np(r), k))
                                  for k in jvo.FrameResult._fields})
        want = np.asarray(JPLSLAM._pack_frame_scalars(jres))
        np.testing.assert_array_equal(to_np(frame_scalars(r)), want)
        np.testing.assert_array_equal(to_np(sc), want)


def test_frame_record_carries_the_gn_trips(vo_run):
    """The frame's one host copy (``frame_record``) is the scalar pack then
    the GN trips used of the result it returned, and ``frame_scalars`` is a
    view of it."""
    vo, _, results, _, _ = vo_run
    rec = vo.frame_record
    assert rec.shape == (22,) and vo.frame_scalars.data_ptr() == rec.data_ptr()
    np.testing.assert_array_equal(to_np(rec[:21]), to_np(frame_scalars(results[-1])))
    used = float(results[-1].gn_trips_used)
    assert float(rec[21]) == used and used == int(used) and 2 <= used <= 15


def test_jax_state_continues_to_the_jax_poses(scene_frames):
    """The JAX VO's state after frame 1, converted and assigned to a port
    VO's ``state``, tracks frames 2-4 as the JAX package does, held to
    test_torch_vo.py's bar (each side detects on its own, and the two
    detectors differ by an ulp on a few keypoints)."""
    scene, frames = scene_frames
    jcam = JCam.create(scene.fx, scene.fy, scene.cx, scene.cy, scene.b,
                       width=scene.width, height=scene.height, dtype=jnp.float32)
    jv = jvo.VisualOdometry(jcam, JFcfg(**FCFG), JTcfg())
    jv.initialize(*(jnp.asarray(x) for x in frames[0]))
    jv.process(*(jnp.asarray(x) for x in frames[1]))
    pv = VisualOdometry(port_cam(scene), FrontendConfig(**FCFG), TrackerConfig(), device="cpu")
    pv.state = convert.vo_state_from_numpy(to_np(jv.state), "cpu")
    got, want = [], []
    for i in range(2, N_FRAMES):
        want.append(jv.process(*(jnp.asarray(x) for x in frames[i])))
        got.append(pv.process(*(tt(x) for x in frames[i])))
        assert bool(got[-1].good) and bool(want[-1].good)
    ate_within_jax([r.T_f_w for r in got], [r.T_f_w for r in want],
                    circular_trajectory(N_FRAMES, step_t=0.05)[2:])


def test_process_needs_a_state_and_prewarm_keeps_it(scene_frames):
    scene, frames = scene_frames
    vo = VisualOdometry(port_cam(scene), FrontendConfig(**FCFG), TrackerConfig(), device="cpu")
    said = []
    vo.prewarm(frames[0][0].shape, progress=said.append)
    assert said and "eager" in said[0] and len(vo.programs()) == 1
    with pytest.raises(RuntimeError, match="initialize"):
        vo.process(*(tt(x) for x in frames[1]))
    vo.initialize(*(tt(x) for x in frames[0]))
    vo.prewarm(frames[0][0].shape)
    assert len(vo.programs()) == 1
    small = [x[:120, :188] for x in frames[1]]
    vo.process(*(tt(x) for x in small))
    assert len(vo.programs()) == 2     # a new image shape, a new program


# ---------------------------------------------------------------------------
# the local BA's bucket programs

CAM = StereoCamera.create(435.25, 435.25, 367.5, 252.25, 0.110074)


def _np_problem(seed=11, P=30, L=12, plucker=True):
    """tests/test_ba.make_problem in float32 numpy as the mapper builds it,
    and its meta: the lines as ||d|| = 1 Pluecker rows, or none."""
    prob, *_ = make_problem(P=P, L=L, noise=0.5, pert=0.05, seed=seed)
    f = {k: (None if v is None else np.asarray(v)) for k, v in prob._asdict().items()}
    f = {k: (v.astype(np.float32) if v is not None and v.dtype.kind == "f" else v)
         for k, v in f.items()}
    lp = None
    if plucker:
        Lw = orth_to_plucker(torch.from_numpy(f["lines_orth"]))
        lp = (Lw / torch.linalg.norm(Lw[:, 3:], dim=-1, keepdim=True)).numpy()
    return ba.BAProblem(**f), {"lines_plucker": lp}


def _eager_solve(prob, meta, cfg):
    """The local BA composed eagerly: upload, Pluecker input, bundle_adjust,
    Pluecker output, the packed buffer."""
    dp = convert.ba_problem_from_numpy(prob, "cpu")
    if meta["lines_plucker"] is not None:
        Lw = torch.from_numpy(meta["lines_plucker"])
        scale = torch.linalg.norm(Lw, dim=-1)
        dp = dp._replace(lines_scale=scale, lines_orth=plucker_to_orth(
            Lw / torch.clamp(scale, min=1e-12)[:, None]))
    res = ba.bundle_adjust(dp, CAM, cfg)
    Lo = orth_to_plucker(res.problem.lines_orth)
    Lo = Lo / torch.clamp(torch.linalg.norm(Lo[:, 3:], dim=-1), min=1e-12)[:, None]
    f32 = torch.float32
    return torch.cat([res.problem.T_c_w.reshape(-1), res.problem.points.reshape(-1),
                      Lo.reshape(-1), res.p_active.to(f32), res.l_active.to(f32),
                      res.cost.to(f32)[None]])


def _mapper():
    return MapHandler(CAM, MapConfig(), device="cpu")


@pytest.mark.parametrize("plucker", [True, False])
def test_local_ba_program_equals_eager_bundle_adjust(plucker):
    mapper = _mapper()
    prob, meta = _np_problem(plucker=plucker)
    out, lay = mapper._solve_local(prob, meta)
    assert lay == (5, 30, 12, 150, 60)
    assert bits_equal(out, _eager_solve(prob, meta, mapper.ba_cfg))
    assert mapper.graph_stats()["local_ba"] == {"built": 1, "evicted": 0, "buckets": 1,
                                                "captured": 0, "captures": 0, "replays": 0,
                                                "pool_bytes": 0}


def test_deferred_result_survives_a_later_solve_of_its_bucket():
    mapper = _mapper()
    p1, m1 = _np_problem(seed=11)
    p2, m2 = _np_problem(seed=12)
    out1, _ = mapper._solve_local(p1, m1)
    keep = out1.clone()
    out2, _ = mapper._solve_local(p2, m2)
    assert mapper.graph_stats()["local_ba"]["built"] == 1      # one bucket, replayed
    assert bits_equal(out1, keep) and not bits_equal(out1, out2)
    assert bits_equal(out2, _eager_solve(p2, m2, mapper.ba_cfg))


def test_bucket_cache_evicts_the_least_recent():
    mapper = _mapper()
    cache = mapper.programs["local_ba"]
    cache.size = 2
    probs = [_np_problem(P=p) for p in (20, 24, 28)]
    keys = []
    for pm in probs:
        mapper._solve_local(*pm)
        keys.append(next(reversed(cache)))
    assert list(cache) == keys[1:]
    assert cache.stats()["evicted"] == 1
    mapper._solve_local(*probs[1])                     # the most recent again
    assert list(cache) == [keys[2], keys[1]]
    mapper._solve_local(*probs[0])                     # built again, evicts keys[2]
    assert list(cache) == [keys[1], keys[0]]
    assert cache.stats()["built"] == 4


# ---------------------------------------------------------------------------
# the helpers


def test_pack_and_unpack_keep_every_field():
    g = torch.Generator().manual_seed(0)
    named = {"T": torch.rand((4, 4), generator=g), "n": torch.tensor(7, dtype=torch.int32),
             "ok": torch.tensor(True), "d": torch.rand(3, generator=g, dtype=torch.float64),
             "flags": torch.tensor([True, False, True])}
    buf, layout = graphs.pack(named)
    assert buf.dtype == torch.uint8 and buf.numel() == 64 + 4 + 1 + 24 + 3
    out = graphs.unpack(buf.clone(), layout)
    assert set(out) == set(named)
    for k, v in named.items():
        assert bits_equal(out[k], v), k
    offsets = {name: off for name, _, _, off, _ in layout.fields}
    assert offsets["d"] == 0 and offsets["T"] % 4 == 0 and offsets["n"] % 4 == 0


def test_cpu_program_runs_the_function_and_replay_counts_launches():
    calls = []
    prog = graphs.Program(lambda: calls.append(1) or torch.ones(2), "cpu")
    assert not prog.captured and calls == []
    assert torch.equal(prog(), torch.ones(2)) and calls == [1]

    @cuda_lib.counted
    def wrapper():
        wrapper.count()

    with cuda_lib.recording() as tally:
        wrapper()
        wrapper()
    assert wrapper.launches == 0 and tally == {wrapper: 2}
    prog._tally = dict(tally)
    prog.graph = type("Replayed", (), {"replay": lambda self: None})()
    prog()
    prog()
    assert wrapper.launches == 4 and prog.replays == 2
    assert prog.launches_per_replay() == {"wrapper": 2}


def test_frame_result_fields_survive_the_pack():
    r = FrameResult(T_f_w=torch.eye(4), DT=torch.eye(4), DT_cov=torch.zeros(6, 6),
                    err=torch.tensor(0.5), n_inliers=torch.tensor(40, dtype=torch.int32),
                    good=torch.tensor(True), is_kf=torch.tensor(False),
                    entropy_ratio=torch.tensor(float("nan")),
                    gn_trips_used=torch.tensor(4.0))
    buf, layout = graphs.pack(r._asdict())
    back = FrameResult(**graphs.unpack(buf, layout))
    assert results_equal(back, r)
