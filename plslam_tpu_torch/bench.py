"""Benchmark: stereo VO throughput (frames/s) on the card (the port of
``bench.py``).

Runs the full per-frame step of ``VisualOdometry``: stereo feature
extraction (FAST+ORB pyramid, line detector + LBD, stereo matching), f2f
association and the robust GN pose solve, on synthetic EuRoC-sized
(752x480) stereo pairs staged on the device, and reports tracked
frames/s.  ``VisualOdometry.prewarm`` captures the step before any frame
(the counterpart of the JAX AOT prewarm), so each ``process`` is one CUDA
graph replay.

    python -m plslam_tpu_torch.bench [--device cuda|cpu]

Prints ONE JSON line with bench.py's keys: {"metric", "value", "unit",
"vs_baseline", "median", "median_vs_baseline", "windows"}; everything else
goes to standard error on ``#`` lines (the card's name and power limit,
the good frames of the best window, the kernel launches per timed frame).
The baseline is bench.py's 20 frames/s.  Three windows of 20 frames after
3 warm-up frames; windows 2 and 3 re-initialize and re-warm; value is the
best window, median the median.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from .core.camera import StereoCamera
from .frontend.frame import FrontendConfig
from .frontend.tracker import TrackerConfig
from .io.synthetic import SyntheticScene, circular_trajectory
from .ops import cuda_fast, cuda_hamming, cuda_patches
from .vo import VisualOdometry

BASELINE_FPS = 20.0
N_WARMUP = 3
N_FRAMES = 20
N_WINDOWS = 3
# EuRoC-sized frames, the full-scale feature budget (config.cpp defaults)
SCENE = dict(n_points=600, n_lines=60, seed=0, width=752, height=480,
             fx=435.2, fy=435.2, cx=367.4, cy=252.2)
WIDTHS = dict(n_points=1200, n_lines=256)
KERNELS = {"gather_patches_batch": cuda_patches.gather_patches_batch,
           "fast_score_nms_batch": cuda_fast.fast_score_nms_batch,
           "hamming_distance_matrix_cuda": cuda_hamming.hamming_distance_matrix_cuda}


class Say:
    """``# [seconds] message`` lines on standard error, as bench.py's."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def __call__(self, msg: str) -> None:
        print(f"# [{time.perf_counter() - self.t0:7.1f}s] {msg}", file=sys.stderr, flush=True)


def resolve_device(name: str) -> torch.device:
    """The device to run on: ``cuda`` is card 0 unless an index is given;
    without CUDA it exits non-zero (nothing falls back to the CPU)."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("CUDA is not available; pass --device cpu to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", 0)
    return dev


def card(dev: torch.device) -> str:
    """nvidia-smi's name and power limit of the card, or ``cpu``."""
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", str(dev.index)], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def kernel_launches() -> dict[str, int]:
    """Each kernel wrapper's launches so far, over every thread."""
    return {k: fn.launches for k, fn in KERNELS.items()}


def scaled(scale: float = 1.0) -> tuple[dict, dict]:
    """``SCENE`` and ``WIDTHS`` with the image, its intrinsics and the
    feature widths scaled by ``scale``: 1 is the benchmark's 752x480 with
    1200 points and 256 line slots; the measurement programs' CPU tests
    run at 0.25 (188x120, 300 points, 64 line slots)."""
    if scale == 1.0:
        return dict(SCENE), dict(WIDTHS)
    scene = dict(SCENE, width=round(SCENE["width"] * scale),
                 height=round(SCENE["height"] * scale),
                 **{k: SCENE[k] * scale for k in ("fx", "fy", "cx", "cy")})
    return scene, {k: round(v * scale) for k, v in WIDTHS.items()}


def camera(scene: SyntheticScene) -> StereoCamera:
    return StereoCamera.create(scene.fx, scene.fy, scene.cx, scene.cy, scene.b,
                               width=scene.width, height=scene.height)


def render(scene_kw: dict, n_poses: int, device) -> list:
    """The (left, right) pairs along ``circular_trajectory(n_poses)``, noise
    1.0, rendered in pose order and staged on ``device``."""
    scene = SyntheticScene(**scene_kw)
    return [tuple(torch.from_numpy(x).to(device) for x in scene.render_stereo(T, noise=1.0))
            for T in circular_trajectory(n_poses, step_t=0.05)]


def run(frames=None, *, scene: dict = SCENE, widths: dict = WIDTHS, n_warmup: int = N_WARMUP,
        n_frames: int = N_FRAMES, windows: int = N_WINDOWS, device="cuda", say=None) -> dict:
    """bench.py's loop on ``frames`` (rendered from ``scene`` when None; at
    least ``1 + n_warmup + n_frames`` pairs).  Returns {"line": the JSON
    object, "good": good frames of the best window, "results": each
    window's timed ``FrameResult``s, "launches": kernel launches per timed
    frame}."""
    say = say or Say()
    dev = torch.device(device)
    if frames is None:
        frames = render(scene, 1 + n_warmup + n_frames, dev)
    frames = [(torch.as_tensor(il, device=dev), torch.as_tensor(ir, device=dev))
              for il, ir in frames]
    vo = VisualOdometry(camera(SyntheticScene(**scene)), FrontendConfig(**widths),
                        TrackerConfig(), device=dev)
    say(f"staged {len(frames)} synthetic stereo pairs on {dev}")
    vo.prewarm(frames[0][0].shape, frames[0][0].dtype, progress=say)
    say("prewarm done")

    window_fps, results, fps, good = [], [], 0.0, 0
    timed_launches = dict.fromkeys(KERNELS, 0)
    for w in range(windows):
        # every window starts from a fresh tracking state (bench.py: the
        # stale end-of-window pose would make the restart frame an outlier)
        vo.initialize(*frames[0])
        for i in range(1, n_warmup + 1):
            res = vo.process(*frames[i])
        _ = float(res.err)
        if w == 0:
            say("warmup frames done")
        before = kernel_launches()
        t0 = time.perf_counter()
        out = []
        for i in range(n_warmup + 1, n_warmup + 1 + n_frames):
            out.append(vo.process(*frames[i]))
        # frame N depends on frame N-1's state: the last frame's scalar
        # syncs the whole chain
        _ = float(out[-1].err)
        dt = time.perf_counter() - t0
        for k, n in kernel_launches().items():
            timed_launches[k] += n - before[k]
        results.append(out)
        window_fps.append(n_frames / dt)
        if n_frames / dt > fps:
            fps = n_frames / dt
            good = sum(int(r.good) for r in out)
        say(f"window: {n_frames / dt:.1f} frames/s")
    median = float(np.median(window_fps))
    line = {"metric": "stereo_vo_tracked_frames_per_s", "value": round(fps, 3),
            "unit": "frames/s", "vs_baseline": round(fps / BASELINE_FPS, 3),
            "median": round(median, 3), "median_vs_baseline": round(median / BASELINE_FPS, 3),
            "windows": [round(f, 3) for f in window_fps]}
    per_frame = {k: n / (windows * n_frames) for k, n in timed_launches.items()}
    return {"line": line, "good": good, "results": results, "launches": per_frame,
            "best_window_s": n_frames / fps}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default: card 0) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    say = Say()
    say(f"device={dev} card={card(dev)} torch {torch.__version__}")
    frames = render(SCENE, 1 + N_WARMUP + N_FRAMES, dev)
    out = run(frames, device=dev, say=say)
    print(json.dumps(out["line"]), flush=True)
    say(f"kernel launches per timed frame: {out['launches']}")
    print(f"# device={dev} good_frames={out['good']}/{N_FRAMES} "
          f"best_window={out['best_window_s']:.2f}s", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
