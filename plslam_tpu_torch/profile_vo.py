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


HAND_WRITTEN = ("gather_patches_kernel", "fast_score_nms_kernel", "hamming_mma_kernel")


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
