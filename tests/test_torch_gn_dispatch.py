"""``tracker.gauss_newton``'s dispatch and the GN operator on the CPU (the
kernel itself runs only on the card: tests/test_torch_gpu_gn.py).

- CPU tensors take the plain twin, bit for bit the solve as it was before
  the kernel (``_gauss_newton_before``, a copy), in every form.
- Under ``torch.func.vmap`` the operator's vmap rule hands the B problems
  to one call of the wrapper (a shared operand at batch stride 0); with a
  CPU stand-in for the wrapper (``_gn_problems.plain_batched``) the
  results equal B single calls.
- The wrapper's checks need no card: float64 and more rows than the kernel
  holds raise.
- The wrapper's calls skip ``cuda_lib.observing``'s hook (and refuse CPU
  tensors), its launches are tallied
  for a replay under ``recording()``, and reach the thread's profiling
  counter ``kernels.gn_launches``.
- ``roofline.WorkCounter`` counts the operator by ``gn_work`` (the wrapper
  stood in for on the CPU).
- ``profile_vo.gn_problems`` records the VO step's two solves a frame;
  ``profile_vo.gn_limits`` holds a settled solve to µm of pose."""

import pytest
import torch

import _gn_problems as gp
from plslam_tpu_torch import roofline
from plslam_tpu_torch.core import lie
from plslam_tpu_torch.core.camera import euroc_default_camera
from plslam_tpu_torch.frontend import tracker
from plslam_tpu_torch.ops import cuda_gauss_newton as cgn
from plslam_tpu_torch.ops import cuda_lib
from plslam_tpu_torch.utils import profiling

from test_torch_helpers import one_torch_thread  # noqa: F401

FORMS = [dict(), dict(early_exit=False), dict(plucker_lines=False),
         dict(plucker_lines=False, early_exit=False), dict(use_lines=False),
         dict(use_points=False)]


def _gauss_newton_before(DT0, pts, ls, cam, cfg, max_iters):
    """``tracker.gauss_newton`` as it was before the kernel, verbatim."""
    dtype, dev = DT0.dtype, DT0.device
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    DT = DT0
    err_prev = torch.full((), 9.9e8, dtype=dtype, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    good = torch.ones((), dtype=torch.bool, device=dev)
    done_in = []
    for _ in range(max_iters):
        done_in.append(done)
        H, g, err = tracker.build_normal_equations(DT, pts, ls, cam, cfg)
        stop = (torch.abs(err - err_prev) < cfg.min_error_change) | (err < cfg.min_error)
        L, chol_ok = tracker._cholesky(H)
        delta = torch.cholesky_solve(g[:, None], L)[:, 0]
        ok = chol_ok & torch.isfinite(delta).all()
        halt = done | stop | ~ok
        step = torch.where(halt, 0.0, delta)
        small = torch.linalg.norm(step) < cfg.min_error_change
        if cfg.early_exit:
            DT = torch.where(done, DT, lie.exp_se3(-step) @ DT)
            good = torch.where(done, good, good & (ok | stop))
        else:
            DT = lie.exp_se3(-step) @ DT
            good = good & (ok | stop)
        err_prev = torch.where(done, err_prev, err)
        done = halt | small
    H, _, err_final = tracker.build_normal_equations(DT, pts, ls, cam, cfg)
    cov = torch.where(good, tracker._solve_spd(H, eye6), eye6)
    return tracker.GNResult(DT=DT, cov=cov, err=torch.where(good, err_final, -1.0),
                            good=good, done_in=tuple(done_in))


def _bits(a, b) -> bool:
    return all(torch.equal(x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))
               for x, y in zip(a[:4], b[:4])) and \
        torch.equal(torch.stack(a.done_in), torch.stack(b.done_in))


@pytest.mark.parametrize("form", FORMS, ids=lambda f: "-".join(f"{k}={v}" for k, v in f.items())
                         or "default")
def test_cpu_dispatch_is_the_plain_solve_bit_for_bit(form):
    cam, cfg = euroc_default_camera(), tracker.TrackerConfig(**form)
    for seed in range(3):
        DT0, pts, ls = gp.problem(seed, 96, 24)
        for max_iters in (5, 10):
            want = _gauss_newton_before(DT0, pts, ls, cam, cfg, max_iters)
            assert _bits(tracker.gauss_newton(DT0, pts, ls, cam, cfg, max_iters), want)


def test_vmap_hands_the_problems_to_one_call(monkeypatch):
    cam, cfg = euroc_default_camera(), tracker.TrackerConfig()
    probs = [gp.problem(s, 64, 16) for s in range(3)]
    DT0, pts, ls = gp.stack(probs)
    seen = []

    def spy(tensors, *rest):
        seen.append(tuple(t.stride(0) for t in tensors))
        return gp.plain_batched(tensors, *rest)

    monkeypatch.setattr(cgn, "gauss_newton_cuda", spy)
    got = torch.func.vmap(lambda d, p, q: cgn.gauss_newton(d, p, q, cam, cfg, 5))(
        DT0, pts, ls)
    shared = torch.func.vmap(lambda p, q: cgn.gauss_newton(DT0[1], p, q, cam, cfg, 5))(
        pts, ls)
    assert len(seen) == 2 and seen[1][0] == 0 and all(s > 0 for s in seen[1][1:])
    for i, p in enumerate(probs):
        one = tracker.gauss_newton(*p, cam, cfg, 5)
        two = tracker.gauss_newton(DT0[1], *p[1:], cam, cfg, 5)
        for res, want in ((got, one), (shared, two)):
            assert _bits(tracker.GNResult(*(x[i] for x in res[:4]),
                                          done_in=tuple(x[i] for x in res.done_in)), want)


def test_wrapper_checks_need_no_card():
    DT0, pts, ls = gp.problem(0, 64, 16)
    tensors = (DT0, *pts, *ls)
    cgn.check_inputs(tensors, batched=False)
    with pytest.raises(TypeError):
        cgn.check_inputs((DT0.double(), *pts, *ls), batched=False)
    with pytest.raises(TypeError):
        cgn.check_inputs((DT0, *pts._replace(valid=pts.valid.to(torch.uint8)), *ls),
                         batched=False)
    big = gp.problem(0, cgn.MAX_ROWS - 16, 16)
    cgn.check_inputs((big[0], *big[1], *big[2]), batched=False)
    bigger = gp.problem(0, cgn.MAX_ROWS - 15, 16)
    with pytest.raises(ValueError):
        cgn.check_inputs((bigger[0], *bigger[1], *bigger[2]), batched=False)
    with pytest.raises(ValueError):
        cgn.check_inputs(tuple(t[None] for t in (bigger[0], *bigger[1], *bigger[2])),
                         batched=True)


def test_launches_skip_the_hook_and_reach_the_counter():
    wrapper = cgn.gauss_newton_cuda
    hooked = []
    DT0, pts, ls = gp.problem(0, 32, 8)
    tensors = tuple(t[None] for t in (DT0, *pts, *ls))
    cam = euroc_default_camera()
    with cuda_lib.observing(lambda w, a, k: hooked.append(w) or w.__wrapped__(*a, **k)):
        with pytest.raises(ValueError, match="CUDA"):
            wrapper(tensors, [cam.fx, cam.fy, cam.cx, cam.cy], True, True, True, True, 5,
                    1e-7, 1e-7)
    assert hooked == []
    before, n = profiling.counters(), wrapper.launches
    wrapper.add(2)
    with cuda_lib.recording() as tally:
        wrapper.count()
    assert tally == {wrapper: 1} and wrapper.launches == n + 2
    added = profiling.added(before, profiling.counters())
    assert sum(c.get(cgn.COUNTER, 0) for c in added.values()) == 2


def test_work_counter_counts_the_operator(monkeypatch):
    monkeypatch.setattr(cgn, "gauss_newton_cuda", gp.plain_batched)
    cam, cfg = euroc_default_camera(), tracker.TrackerConfig(plucker_lines=False)
    DT0, pts, ls = gp.problem(0, 64, 16)
    _, work = roofline.count_work(lambda: cgn.gauss_newton(DT0, pts, ls, cam, cfg, 10))
    nbytes, ops = roofline.gn_work(64, 16, max_iters=10, plucker=False)
    assert work.kernels == {"gauss_newton_cuda": {"calls": 1, "bytes": nbytes, "ops": ops}}
    assert work.ops == {"f32": 0.0, "f32_add": ops}


def test_profile_vo_records_the_vo_solves():
    """``profile_vo.gn_problems`` hands back every solve of an eager VO run:
    two a tracked frame, float32 at the VO's widths."""
    from plslam_tpu_torch.bench import camera, render, scaled
    from plslam_tpu_torch.frontend.frame import FrontendConfig
    from plslam_tpu_torch.io import SyntheticScene
    from plslam_tpu_torch.profile_vo import gn_problems

    scene, widths = scaled(0.25)
    cam, cfg = camera(SyntheticScene(**scene)), tracker.TrackerConfig()
    calls = gn_problems(render(scene, 3, "cpu"), cam, FrontendConfig(**widths), cfg, "cpu")
    assert [c[3] for c in calls] == [cfg.max_iters, cfg.max_iters_ref] * 2
    assert calls[0][1].P.shape[0] == widths["n_points"] and calls[0][0].dtype == torch.float32


def test_gn_limits_hold_a_settled_solve_to_micrometres():
    """The per-solve limit of the card's checks: on a seeded problem that
    settles, twice the plain path's spread over rounding is µm of pose
    and a few parts in 1e4 of cov and err, and never below the floor."""
    from plslam_tpu_torch.profile_vo import GN_FLOOR, gn_differences, gn_limits

    cam, cfg = euroc_default_camera(), tracker.TrackerConfig()
    DT0, pts, ls = gp.problem(1, 256, 64)
    plain = tracker.gauss_newton(DT0, pts, ls, cam, cfg, 10)
    assert gn_differences(plain, plain) == {"DT": 0.0, "cov": 0.0, "err": 0.0}
    lim = gn_limits(DT0, pts, ls, cam, cfg, 10, plain)
    assert all(lim[k] >= GN_FLOOR[k] for k in GN_FLOOR)
    assert lim["DT"] < 1e-4 and lim["cov"] < 1e-2 and lim["err"] < 1e-2, lim
