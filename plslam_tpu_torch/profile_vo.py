"""Where the time of the port's VO step goes, on one GPU.

    python -m plslam_tpu_torch.profile_vo [--frames N]

Runs ``VisualOdometry`` at the bench configuration (752x480 synthetic
scene, 1200 points, 256 line slots), then:
  - host-clock time of each stage (points detection, lines detection,
    match + track), each ended by ``torch.cuda.synchronize()``;
  - a ``torch.profiler`` window over N frames: device-busy share of the
    wall time, kernel launches per frame, and the kernels by device time.
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=10)
    args = ap.parse_args()
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
    vo = VisualOdometry(cam, FrontendConfig(n_points=1200, n_lines=256),
                        TrackerConfig(), device=dev)
    vo.initialize(*frames[0])
    for i in range(1, 4):
        vo.process(*frames[i])
    torch.cuda.synchronize()

    # stage split on the host clock (synchronising between stages)
    stages = {"detect points": [], "detect lines": [], "match + track": []}
    for i in range(4, 4 + args.frames):
        imgs = torch.stack(frames[i])
        t0 = time.perf_counter()
        kp = _detect_describe_points_batch(imgs, vo.fcfg, vo.state.fast_th)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        seg = _detect_describe_lines_batch(imgs, vo.fcfg)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        _, vo.state = match_and_track(kp, seg, vo.state, cam, vo.fcfg, vo.tcfg,
                                      vo.params)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2)):
            stages[k].append(dt * 1e3)
    for k, v in stages.items():
        print(f"stage {k}: median {np.median(v):.3f} ms")

    # profiler window over whole steps
    rest = frames[4 + args.frames:]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in rest:
            vo.process(*f)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time_total if hasattr(e, "device_time_total")
                  else e.cuda_time_total for e in kern)
    print(f"profiled {len(rest)} frames: wall {wall * 1e3 / len(rest):.3f} ms/frame, "
          f"device busy {busy_us / 1e3 / len(rest):.3f} ms/frame "
          f"({100 * busy_us / 1e6 / wall:.1f}% of wall), "
          f"{len(kern) / len(rest):.0f} device kernels/frame")
    avg = [e for e in prof.key_averages() if _device_us(e) > 0]
    avg.sort(key=_device_us, reverse=True)
    ours = [e for e in avg if any(k in e.key for k in HAND_WRITTEN)]
    ours_us = sum(_device_us(e) for e in ours)
    print(f"hand-written kernels: {ours_us / 1e3 / len(rest):.4f} ms/frame "
          f"({100 * ours_us / max(busy_us, 1e-9):.2f}% of device time)")
    for e in ours:
        print(f"  {_device_us(e) / 1e3 / len(rest):8.4f} ms/frame  "
              f"{e.count / len(rest):5.1f}/frame  {e.key[:70]}")
    print("top device kernels (ms/frame, calls/frame):")
    for e in avg[:25]:
        print(f"  {_device_us(e) / 1e3 / len(rest):8.4f}  {e.count / len(rest):7.1f}  "
              f"{e.key[:100]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
