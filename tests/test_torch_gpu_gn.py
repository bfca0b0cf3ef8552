"""The GN pose-solve kernel (``csrc/gauss_newton.cu``) against its plain twin
``tracker.gauss_newton_plain`` on the card.

- Seeded problems (``_gn_problems``: noise, outliers, masked rows, pyramid
  weights) in every form (early exit or scan, Pluecker or endpoint lines,
  points only, lines only) and the bench scene's own VO solves, each
  solve held on its own: ``good`` equal; DT, cov and err within twice the
  plain path's own spread over rounding on that solve
  (``profile_vo.gn_limits``: card vs CPU, the CPU's with the rows
  reordered, which sums the Gram in another order, and with its inputs
  moved one ulp, which rounds the residuals otherwise), with a floor of a
  few float32 ulps; a ``done_in`` flag that differs from the plain path's sits
  within rounding of its stopping threshold.
- The kernel's selection (``plslam_gn_select_test``) equals
  ``robust.masked_median_upper`` on the card bit for bit: ties, -0 and +0
  (at a width the card sorts by radix, > 128; below it the sort keeps
  equal keys in input order), +-inf, NaN, every row masked, one valid row,
  widths that are not a multiple of the block.
- Two replays of the VO graph on one frame give the same ``frame_record``
  bits, each with two GN launches; a ``batch_vo`` frame makes one launch
  per solve for all B streams; a vmapped call equals the single calls bit
  for bit.
- The wrapper refuses float64 and more rows than the kernel holds.

Marked ``gpu``; each test skips when no CUDA device is present.  On a
machine with one (``--noconftest``: its tests/conftest.py imports jax):
    python -m pytest -m gpu --noconftest tests/test_torch_gpu_gn.py
"""

import math

import numpy as np
import pytest
import torch

import _gn_problems as gp
from plslam_tpu_torch.core import robust
from plslam_tpu_torch.core.camera import euroc_default_camera
from plslam_tpu_torch.frontend import tracker
from plslam_tpu_torch.ops import cuda_gauss_newton as cgn
from plslam_tpu_torch.ops import cuda_lib
from plslam_tpu_torch.profile_vo import gn_differences, gn_limits

pytestmark = pytest.mark.gpu

FORMS = [dict(), dict(early_exit=False), dict(plucker_lines=False),
         dict(plucker_lines=False, early_exit=False), dict(use_lines=False),
         dict(use_points=False)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    return torch.device("cuda:0")


def _to(tree, dev):
    return type(tree)(*(x.to(dev) for x in tree))


def _trace(DT0, pts, ls, cam, cfg, max_iters) -> list:
    """The plain loop's deciding quantities per trip: |err - err_prev|,
    err and the step's norm."""
    DT, err_prev, rows = DT0, torch.full((), 9.9e8, device=DT0.device), []
    done = torch.zeros((), dtype=torch.bool, device=DT0.device)
    for _ in range(max_iters):
        H, g, err = tracker.build_normal_equations(DT, pts, ls, cam, cfg)
        stop = (torch.abs(err - err_prev) < cfg.min_error_change) | (err < cfg.min_error)
        L, ok = tracker._cholesky(H)
        delta = torch.cholesky_solve(g[:, None], L)[:, 0]
        ok = ok & torch.isfinite(delta).all()
        step = torch.where(done | stop | ~ok, 0.0, delta)
        rows.append((abs(err - err_prev).item(), err.item(), torch.linalg.norm(step).item()))
        DT = torch.where(done, DT, tracker.lie.exp_se3(-step) @ DT)
        err_prev = torch.where(done, err_prev, err)
        done = done | stop | ~ok | (torch.linalg.norm(step) < cfg.min_error_change)
    return rows


def _near_threshold(row, cfg) -> bool:
    """The trip's stopping rule was decided within rounding: the change of
    err, err itself or the step's norm within 64 float32 ulps of err of
    its threshold (1e-7 is 13 such ulps at err 0.1: err's own rounding)."""
    d_err, err, norm = row
    slack = 64 * float(np.spacing(np.float32(abs(err))))
    return (abs(d_err - cfg.min_error_change) <= slack or abs(err - cfg.min_error) <= slack
            or abs(norm - cfg.min_error_change) <= slack)


def _hold(problems, cam, cfg, dev) -> list:
    """The kernel against the plain path on the card, solve by solve
    (``problems``: CPU (DT0, pts, ls, max_iters)): ``good`` equal; DT, cov
    and err each within the solve's own limit (``profile_vo.gn_limits``:
    twice the plain path's spread over rounding on that solve);
    returns each solve's (differences, limits)."""
    out = []
    for i, (DT0, pts, ls, max_iters) in enumerate(problems):
        card_in = (DT0.to(dev), _to(pts, dev), _to(ls, dev))
        plain = tracker.gauss_newton_plain(*card_in, cam, cfg, max_iters)
        kern = tracker.gauss_newton(*card_in, cam, cfg, max_iters)
        assert bool(kern.good) == bool(plain.good), i
        got = gn_differences(kern, plain)
        lim = gn_limits(DT0, pts, ls, cam, cfg, max_iters, plain)
        assert all(got[k] <= lim[k] for k in got), (i, got, lim)
        flags = [(bool(a), bool(b)) for a, b in zip(kern.done_in, plain.done_in)]
        for t, (a, b) in enumerate(flags):
            if a != b:
                rows = _trace(*card_in, cam, cfg, max_iters)
                assert t > 0 and _near_threshold(rows[t - 1], cfg), (i, t, rows[t - 1])
                break
        out.append((got, lim))
    return out


def _say(label, held) -> None:
    for i, (got, lim) in enumerate(held):
        print(f"{label} solve {i}: " + ", ".join(f"{k} {got[k]:.3e} <= {lim[k]:.3e}"
                                                 for k in got))


@pytest.mark.parametrize("form", FORMS, ids=lambda f: "-".join(f"{k}={v}" for k, v in f.items())
                         or "default")
def test_kernel_on_seeded_problems(dev, form):
    cam = euroc_default_camera()
    cfg = tracker.TrackerConfig(**form)
    problems = [gp.problem(s, 800, 320) + (mi,) for s in range(6) for mi in (5, 10)]
    _say(f"form {form}", _hold(problems, cam, cfg, dev))


def test_kernel_on_the_bench_scene(dev):
    """The solves of eager VO frames on the bench scene, at its widths.  The
    fourth, frame 2's refinement, never settles in its 10 trips: its spread
    over rounding, and so its limit, is mm of pose (the CPU's moves
    6.6 mm with the order of its rows); the other seven settle and are held
    to µm."""
    from plslam_tpu_torch.bench import SCENE, WIDTHS, camera, render
    from plslam_tpu_torch.frontend.frame import FrontendConfig
    from plslam_tpu_torch.io import SyntheticScene
    from plslam_tpu_torch.profile_vo import gn_problems

    cam = camera(SyntheticScene(**SCENE))
    calls = gn_problems(render(SCENE, 5, dev), cam, FrontendConfig(**WIDTHS),
                        tracker.TrackerConfig(), dev)
    assert len(calls) == 8
    cpu = [(d.cpu(), _to(p, "cpu"), _to(q, "cpu"), mi) for d, p, q, mi in calls]
    _say("bench scene", _hold(cpu, cam, tracker.TrackerConfig(), dev))


def _select_cases():
    g = torch.Generator().manual_seed(7)
    cases = {}
    for n in (1, 7, 33, 255, 256, 257, 1000, 1120, 8192):
        x = torch.rand((3, n), generator=g) * 10
        m = torch.rand((3, n), generator=g) < 0.7
        cases[f"random-{n}"] = (x, m)
        cases[f"ties-{n}"] = (torch.randint(0, 4, (3, n), generator=g).float(), m)
    x = torch.randint(0, 3, (2, 1000), generator=g).float()
    x[x == 0] = -0.0
    x[0, ::3] = 0.0
    cases["signed-zeros-1000"] = (x, torch.rand((2, 1000), generator=g) < 0.8)
    x = torch.rand((4, 300), generator=g)
    x[:, ::5] = math.inf
    x[:, 1::7] = -math.inf
    x[:, 2::11] = math.nan
    x[1, :] = math.nan
    x[2, :200] = math.inf
    cases["inf-nan-300"] = (x, torch.rand((4, 300), generator=g) < 0.9)
    x = torch.rand((3, 500), generator=g)
    m = torch.zeros((3, 500), dtype=torch.bool)
    m[1, 17] = True
    m[2, 499] = True
    cases["none-or-one-valid-500"] = (x, m)
    return cases


@pytest.mark.parametrize("name", list(_select_cases()))
def test_selection_is_the_upper_median(dev, name):
    x, m = (t.to(dev) for t in _select_cases()[name])
    got = cgn.select_test(x, m)
    want = robust.masked_median_upper(x, m)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32))


def test_max_rows_matches_the_source(dev):
    assert cuda_lib.load().lib.plslam_gn_max_rows() == cgn.MAX_ROWS


def test_vo_graph_replays_are_bit_identical(dev):
    """Replaying the VO graph twice from one state on one frame gives the
    same frame record, with two GN launches each time."""
    from plslam_tpu_torch.bench import SCENE, WIDTHS, camera, render
    from plslam_tpu_torch.frontend.frame import FrontendConfig
    from plslam_tpu_torch.io import SyntheticScene
    from plslam_tpu_torch.vo import VisualOdometry

    frames = render(SCENE, 4, dev)
    vo = VisualOdometry(camera(SyntheticScene(**SCENE)), FrontendConfig(**WIDTHS),
                        tracker.TrackerConfig(), device=dev)
    vo.initialize(*frames[0])
    vo.process(*frames[1])
    st = vo.state
    recs = []
    for _ in range(2):
        vo.state = st
        n = cgn.gauss_newton_cuda.launches
        vo.process(*frames[2])
        torch.cuda.synchronize()
        assert cgn.gauss_newton_cuda.launches == n + 2
        recs.append(vo.frame_record.clone())
    assert torch.equal(recs[0].view(torch.int32), recs[1].view(torch.int32))


def test_vmap_is_one_launch_and_equals_single_calls(dev):
    cam, cfg = euroc_default_camera(), tracker.TrackerConfig()
    probs = [tuple(gp.problem(s, 800, 320, device=dev)) for s in range(4)]
    DT0, pts, ls = gp.stack(probs)
    n = cgn.gauss_newton_cuda.launches
    got = torch.func.vmap(lambda d, p, q: tracker.gauss_newton(d, p, q, cam, cfg, 10))(
        DT0, pts, ls)
    assert cgn.gauss_newton_cuda.launches == n + 1
    shared = torch.func.vmap(lambda p, q: tracker.gauss_newton(DT0[0], p, q, cam, cfg, 10))(
        pts, ls)
    for i, p in enumerate(probs):
        one = tracker.gauss_newton(*p, cam, cfg, 10)
        for res in (got, shared):
            for a, b in zip(res[:4], one[:4]):
                assert torch.equal(a[i].reshape(-1).view(torch.uint8),
                                   b.reshape(-1).view(torch.uint8))
            assert [bool(x[i]) for x in res.done_in] == [bool(x) for x in one.done_in]


def test_batch_vo_makes_one_launch_per_solve(dev):
    """A ``BatchedVisualOdometry`` frame launches the GN kernel twice (the
    solve and its refinement) whatever B is, each launch B blocks."""
    from plslam_tpu_torch.batch_vo import BatchedVisualOdometry
    from plslam_tpu_torch.core.camera import StereoCamera
    from plslam_tpu_torch.frontend.frame import FrontendConfig
    from plslam_tpu_torch.io import SyntheticScene, circular_trajectory

    poses = circular_trajectory(3)
    for B in (1, 3):
        scenes = [SyntheticScene(seed=s) for s in range(B)]
        fr = [[torch.from_numpy(np.stack(x)).to(dev) for x in zip(*(sc.render_stereo(T)
                                                                    for sc in scenes))]
              for T in poses]
        sc = scenes[0]
        cam = StereoCamera.create(sc.fx, sc.fy, sc.cx, sc.cy, sc.b, width=sc.width,
                                  height=sc.height)
        bvo = BatchedVisualOdometry(B, cam, FrontendConfig(n_points=512, n_lines=128,
                                                           fast_th=15.0), device=dev)
        bvo.initialize(*fr[0])
        bvo.process(*fr[1])
        n = cgn.gauss_newton_cuda.launches
        res = bvo.process(*fr[2])
        torch.cuda.synchronize()
        assert cgn.gauss_newton_cuda.launches == n + 2
        assert bool(res.good.all())


def test_wrapper_refuses_what_the_kernel_cannot_take(dev):
    cam, cfg = euroc_default_camera(), tracker.TrackerConfig()
    DT0, pts, ls = gp.problem(0, 64, 16, device=dev)
    with pytest.raises(TypeError):
        tracker.gauss_newton(DT0.double(), pts, ls, cam, cfg, 5)
    with pytest.raises(TypeError):
        tracker.gauss_newton(DT0, pts._replace(P=pts.P.double()), ls, cam, cfg, 5)
    DT0, pts, ls = gp.problem(0, cgn.MAX_ROWS - 15, 16, device=dev)
    with pytest.raises(ValueError):
        tracker.gauss_newton(DT0, pts, ls, cam, cfg, 5)
