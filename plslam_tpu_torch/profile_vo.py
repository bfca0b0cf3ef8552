"""Where the time of the port's VO step goes, on one GPU: the graphed step
(one CUDA-graph replay per frame) beside the eager one.

    python -m plslam_tpu_torch.profile_vo [--frames N]

Runs ``VisualOdometry`` at the bench configuration (752x480 synthetic
scene, 1200 points, 256 line slots), graphed and with ``capture=False``,
then:
  - host-clock time of each stage of the eager step (points detection,
    lines detection, match + track), each ended by
    ``torch.cuda.synchronize()``;
  - a ``torch.profiler`` window over N frames of each form: wall ms per
    frame, device-busy share of the wall time, device kernels per frame,
    host CUDA calls per frame (the CUDA runtime calls the profiler traces:
    kernel launches, graph launches, copies, event records), graph launches
    per frame, and the kernels by device time.
Needs CUDA; exits non-zero without it.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from .core.camera import StereoCamera
from .frontend.frame import (FrontendConfig, _detect_describe_lines_batch,
                             _detect_describe_points_batch)
from .frontend.tracker import TrackerConfig
from .io import SyntheticScene, circular_trajectory
from .vo import VisualOdometry, match_and_track


HAND_WRITTEN = ("gather_patches_kernel", "fast_score_nms_kernel", "hamming_mma_kernel",
                "gn_pose_solve_kernel")


def gn_problems(frames: list, cam: StereoCamera, fcfg: FrontendConfig, tcfg: TrackerConfig,
                device) -> list:
    """The arguments of every ``tracker.gauss_newton`` call (two a frame:
    the solve and its refinement) of an eager VO (``capture=False``) over
    ``frames``, the first one initializing: a list of (DT0, pts, ls,
    max_iters), cloned."""
    from .frontend import tracker

    calls, real = [], tracker.gauss_newton

    def spy(DT0, pts, ls, cam_, cfg, max_iters):
        clone = lambda tree: type(tree)(*(x.clone() for x in tree))
        calls.append((DT0.clone(), clone(pts), clone(ls), max_iters))
        return real(DT0, pts, ls, cam_, cfg, max_iters)

    vo = VisualOdometry(cam, fcfg, tcfg, device=device, capture=False)
    tracker.gauss_newton = spy
    try:
        vo.initialize(*frames[0])
        for pair in frames[1:]:
            vo.process(*pair)
    finally:
        tracker.gauss_newton = real
    return calls


# The GN kernel may differ from its plain twin on the card by this many
# times the plain path's own spread over rounding on the same solve, above
# a floor of a few float32 ulps (DT in m, cov relative to its largest
# entry, err relative).
GN_TOL_FACTOR = 2.0
GN_FLOOR = {"DT": 80 * 2.0 ** -23, "cov": 8 * 2.0 ** -23, "err": 8 * 2.0 ** -23}


def gn_differences(a, b) -> dict:
    """The largest |a - b| of two ``GNResult``s: DT (m), cov (relative to
    b's largest entry) and err (relative)."""
    f = lambda x: x.double().cpu()
    cov_scale = max(f(b.cov).abs().max().item(), 1e-30)
    err_scale = max(abs(f(b.err).item()), 1e-30)
    return {"DT": (f(a.DT) - f(b.DT)).abs().max().item(),
            "cov": (f(a.cov) - f(b.cov)).abs().max().item() / cov_scale,
            "err": abs(f(a.err).item() - f(b.err).item()) / err_scale}


def gn_limits(DT0, pts, ls, cam: StereoCamera, tcfg: TrackerConfig, max_iters: int,
              plain) -> dict:
    """The GN kernel's limits on one solve: ``GN_TOL_FACTOR`` times the
    plain path's own spread over rounding, plus ``GN_FLOOR``.  The spread
    is the largest difference from the plain path on the CPU of
    - ``plain``, the plain path on the card: other reduction orders, the
      same elementwise bits;
    - the CPU's with the rows reversed and in two seeded orders: the Gram
      summed in other orders;
    - the CPU's with every float input of the rows moved one ulp up or
      down at random, three seeded draws: the rounding of the kernel's own
      elementwise order (its R p + t is not the plain path's einsum), which
      the other two never vary.  A residual is a difference of pixel
      coordinates, so an ulp there is 1e-4 of a residual, and the MAD
      scale is one such element: err and cov carry it whole.
    A solve that settles moves by µm; one whose trips never settle turns
    the order of its sums into mm of pose."""
    from .frontend import tracker

    def rows(tree, idx):
        return type(tree)(*(x.cpu()[idx] for x in tree))

    def nudged(tree, g):
        def one(x):
            if not x.is_floating_point():
                return x
            up = torch.rand(x.shape, generator=g) < 0.5
            return torch.nextafter(x, torch.where(up, torch.inf, -torch.inf))
        return type(tree)(*(one(x.cpu()) for x in tree))

    def solve(p, q):
        return tracker.gauss_newton_plain(DT0, p, q, cam, tcfg, max_iters)

    DT0 = DT0.cpu()
    n_p, n_l = pts.P.shape[0], ls.sP.shape[0]
    cpu = solve(rows(pts, slice(None)), rows(ls, slice(None)))
    others = [plain]
    for seed in (None, 0, 1):
        g = None if seed is None else torch.Generator().manual_seed(seed)
        order = (lambda n: torch.arange(n - 1, -1, -1)) if g is None else \
            (lambda n: torch.randperm(n, generator=g))
        others.append(solve(rows(pts, order(n_p)), rows(ls, order(n_l))))
    for seed in (2, 3, 4):
        g = torch.Generator().manual_seed(seed)
        others.append(solve(nudged(pts, g), nudged(ls, g)))
    spread = {k: 0.0 for k in GN_FLOOR}
    for other in others:
        for k, v in gn_differences(other, cpu).items():
            spread[k] = max(spread[k], v)
    return {k: GN_TOL_FACTOR * v + GN_FLOOR[k] for k, v in spread.items()}


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total", None)
                 or getattr(evt, "self_cuda_time_total", 0.0))


def profile_window(run, n: int) -> dict:
    """``run(i)`` for i < n under ``torch.profiler``: wall and device-busy
    ms per call, the busy share, device kernels, host CUDA runtime calls
    and graph launches per call, ``n`` and the profile itself (``prof``)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            run(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    kern = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time_total if hasattr(e, "device_time_total")
                  else e.cuda_time_total for e in kern)
    calls = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU
             and e.name.startswith("cuda")]
    return {"wall_ms": 1e3 * wall / n, "busy_ms": busy_us / 1e3 / n,
            "busy_share": busy_us / 1e6 / wall, "kernels": len(kern) / n,
            "host_cuda_calls": len(calls) / n,
            "graph_launches": sum(e.name == "cudaGraphLaunch" for e in calls) / n,
            "n": n, "prof": prof}


def _report(name: str, w: dict) -> None:
    print(f"{name}: wall {w['wall_ms']:.3f} ms/frame, device busy {w['busy_ms']:.3f} "
          f"ms/frame ({100 * w['busy_share']:.1f}% of wall), {w['kernels']:.0f} device "
          f"kernels/frame, {w['host_cuda_calls']:.0f} host CUDA calls/frame, "
          f"{w['graph_launches']:.0f} graph launches/frame")
    avg = [e for e in w["prof"].key_averages() if _device_us(e) > 0]
    avg.sort(key=_device_us, reverse=True)
    n_frames = w["n"]
    ours = [e for e in avg if any(k in e.key for k in HAND_WRITTEN)]
    ours_us = sum(_device_us(e) for e in ours)
    print(f"  hand-written kernels: {ours_us / 1e3 / n_frames:.4f} ms/frame "
          f"({100 * ours_us / 1e3 / n_frames / max(w['busy_ms'], 1e-9):.2f}% of device time)")
    for e in ours:
        print(f"  {_device_us(e) / 1e3 / n_frames:8.4f} ms/frame  "
              f"{e.count / n_frames:5.1f}/frame  {e.key[:70]}")
    print("  top device kernels (ms/frame, calls/frame):")
    for e in avg[:15]:
        print(f"  {_device_us(e) / 1e3 / n_frames:8.4f}  {e.count / n_frames:7.1f}  "
              f"{e.key[:100]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_vo: no CUDA device")
    dev = torch.device("cuda:0")
    scene = SyntheticScene(n_points=600, n_lines=60, seed=0, width=752, height=480,
                           fx=435.2, fy=435.2, cx=367.4, cy=252.2)
    n = 4 + 2 * args.frames
    frames = [tuple(torch.from_numpy(x).to(dev) for x in scene.render_stereo(T))
              for T in circular_trajectory(n, step_t=0.05)]
    cam = StereoCamera.create(scene.fx, scene.fy, scene.cx, scene.cy, scene.b,
                              width=scene.width, height=scene.height)
    fcfg, tcfg = FrontendConfig(n_points=1200, n_lines=256), TrackerConfig()
    graphed = VisualOdometry(cam, fcfg, tcfg, device=dev)
    eager = VisualOdometry(cam, fcfg, tcfg, device=dev, capture=False)
    t0 = time.perf_counter()
    graphed.prewarm(frames[0][0].shape)
    torch.cuda.synchronize()
    print(f"capture: {time.perf_counter() - t0:.3f} s")
    for vo in (graphed, eager):
        vo.initialize(*frames[0])
        for i in range(1, 4):
            vo.process(*frames[i])
    torch.cuda.synchronize()

    # stage split of the eager step on the host clock (synchronising
    # between stages): the functional step from a copy of the state, which
    # both trackers then continue from
    st = eager.state
    stages = {"detect points": [], "detect lines": [], "match + track": []}
    for i in range(4, 4 + args.frames):
        imgs = torch.stack(frames[i])
        t0 = time.perf_counter()
        kp = _detect_describe_points_batch(imgs, fcfg, st.fast_th)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        seg = _detect_describe_lines_batch(imgs, fcfg)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        _, st = match_and_track(kp, seg, st, cam, fcfg, tcfg, eager.params)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2)):
            stages[k].append(dt * 1e3)
    for k, v in stages.items():
        print(f"stage {k} (eager): median {np.median(v):.3f} ms")
    graphed.state = eager.state = st

    rest = frames[4 + args.frames:]
    for name, vo in (("graphed", graphed), ("eager", eager)):
        w = profile_window(lambda i, vo=vo: vo.process(*rest[i]), len(rest))
        _report(f"{name} step over {len(rest)} frames", w)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
