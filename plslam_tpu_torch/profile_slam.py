"""Full-SLAM frames/s of the port on one GPU at chip_smoke.py's phase-5
(Plücker lines) or phase-7 (endpoint lines, refinement, loop closure)
configuration.

    python -m plslam_tpu_torch.profile_slam [--config plucker|endpoint]
        [--reps N] [--length L] [--switch-interval S] [--stages]
        [--frames FILE] [--save FILE]

Renders bench_slam.py's 20 frames (752x480 synthetic scene, 1200 points,
256 line slots; ``--length`` frames of the same circle instead, to reach
past the one-time captures; or loads them from FILE, which ``--save``
writes), runs ``PLSLAM`` over them REPS times, each a fresh instance (4
warm-up frames, then the rest timed up to the drained queues), and prints
one JSON line: the frames/s of each rep, the keyframes, the card's name
and power limit.
``--switch-interval`` sets ``sys.setswitchinterval`` first (the
interpreter's thread switch interval, 0.005 s by default): how long the
tracker can wait for the interpreter lock while the mapping thread runs
Python.  ``--stages`` adds, per thread, the host ms per call and the
calls of PLSLAM's, the tracker's and the mapper's steps in the timed
frames (``STAGES``; nested steps count inside their callers).  It imports
only ``plslam_tpu_torch``, so the same script can run against another
checkout put first on PYTHONPATH.  Needs CUDA.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import threading
import time
from typing import Callable

import numpy as np
import torch

WARMUP, LENGTH = 4, 20
CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")


def scene():
    """bench.py's synthetic scene, as chip_smoke.py renders it."""
    from plslam_tpu_torch.io import SyntheticScene

    return SyntheticScene(n_points=600, n_lines=60, seed=0, width=752, height=480,
                          fx=435.2, fy=435.2, cx=367.4, cy=252.2)


def render_frames(length: int = LENGTH) -> np.ndarray:
    """(length, 2, 480, 752) f32: chip_smoke.py's SLAM frames (its 20 and
    the circle's next)."""
    from plslam_tpu_torch.io import circular_trajectory

    sc = scene()
    return np.stack([np.stack(sc.render_stereo(T, noise=1.0))
                     for T in circular_trajectory(length, step_t=0.05)])


def configs(name: str):
    """chip_smoke.py's PLSLAMConfig and MapConfig of phase 5 or 7."""
    from plslam_tpu_torch.backend.mapping import MapConfig
    from plslam_tpu_torch.config import PLSLAMConfig

    caps = dict(local_ba_kf=8, ba_points=2048, ba_lines=256, ba_pobs=8192, ba_lobs=2048)
    if name == "plucker":
        return (PLSLAMConfig(orb_nfeatures=1200, lsd_nfeatures=256, min_entropy_ratio=0.99),
                MapConfig(**caps))
    return (PLSLAMConfig(orb_nfeatures=1200, lsd_nfeatures=256, min_entropy_ratio=0.99,
                         use_line_plucker=False, use_loop_closure=True, has_refinement=True,
                         vocabulary_p=os.path.join(CONFIGS, "vocab_orb_k10L3.yml.gz"),
                         vocabulary_l=os.path.join(CONFIGS, "vocab_lbd_k10L3.yml.gz")),
            MapConfig(**caps, plucker_lines=False, has_refinement=True))


# the steps --stages times: PLSLAM's, the tracker's and the mapper's (the
# fused association, the split one with the refinement, the local BA and
# the map upkeep); those a checkout lacks are skipped
STAGES = {"slam": ("process", "_submit", "_insert_keyframe"),
          "vo": ("process",),
          "mapper": ("add_keyframe", "_associate_and_insert", "_assoc", "_assoc_prog",
                     "_fetch_with_pending", "_match_kf2kf", "_refine_kf_pose", "_match_map2kf",
                     "_spawn_landmarks", "local_bundle_adjustment", "build_local_ba",
                     "_solve_local", "flush_ba", "cull_landmarks",
                     "refresh_landmark_descriptors")}


# and, on every thread, a program's replay (the graph launch) and a staged
# program's wait for its last replay and its fill
CLASS_STAGES = {"Program": ("__call__",), "StagedProgram": ("wait", "_fill")}


def wrap_timers(targets) -> tuple[dict, Callable[[], None]]:
    """Wrap each (object, step, key) of ``targets`` in a host timer: (the
    dict that fills with (thread name, key) -> [seconds of each call], a
    function that unwraps them).  A step the object lacks is skipped."""
    acc = collections.defaultdict(list)
    wrapped = []

    def wrap(obj, step, key):
        fn = getattr(obj, step, None)
        if fn is None:
            return

        def timed(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                acc[(threading.current_thread().name, key)].append(time.perf_counter() - t)

        setattr(obj, step, timed)
        wrapped.append((obj, step, fn))

    for obj, step, key in targets:
        wrap(obj, step, key)

    def unwrap():
        for obj, step, fn in reversed(wrapped):
            if isinstance(obj, type):
                setattr(obj, step, fn)
            else:
                delattr(obj, step)   # the instance attribute over the method

    return acc, unwrap


def time_stages(slam):
    """Wrap ``STAGES`` of ``slam`` and ``CLASS_STAGES`` of ``graphs`` in
    host timers (``wrap_timers``)."""
    from plslam_tpu_torch import graphs

    targets = [(slam if obj_name == "slam" else getattr(slam, obj_name), step,
                f"{obj_name}.{step}") for obj_name, steps in STAGES.items() for step in steps]
    for cls_name, steps in CLASS_STAGES.items():
        cls = getattr(graphs, cls_name, None)
        targets += [(cls, step, f"graphs.{cls_name}.{step}")
                    for step in (steps if cls is not None else ())]
    return wrap_timers(targets)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_once(dev, frames: list, name: str, stages: bool = False):
    """One graphed PLSLAM over the frames: (timed frames/s, keyframes, the
    stage times of the timed frames or None)."""
    from plslam_tpu_torch.core.camera import StereoCamera
    from plslam_tpu_torch.pipeline import PLSLAM

    sc = scene()
    cam = StereoCamera.create(sc.fx, sc.fy, sc.cx, sc.cy, sc.b, width=sc.width, height=sc.height)
    cfg, mcfg = configs(name)
    slam = PLSLAM(cam, cfg, mcfg, device=dev)
    for i in range(WARMUP):
        slam.process(*frames[i], timestamp=0.05 * i)
    slam.wait_until_idle()
    _sync(dev)
    acc, unwrap = time_stages(slam) if stages else (None, None)
    t = time.perf_counter()
    for i in range(WARMUP, len(frames)):
        slam.process(*frames[i], timestamp=0.05 * i)
    slam.wait_until_idle()
    _sync(dev)
    fps = (len(frames) - WARMUP) / (time.perf_counter() - t)
    n_kf = len(slam.mapper.map.keyframes)
    slam.finish(run_gba=False)
    if acc is not None:
        unwrap()
        acc = {f"{th} {key}": [round(1e3 * sum(ts) / len(ts), 3), len(ts)]
               for (th, key), ts in sorted(acc.items())}
    return fps, n_kf, acc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", choices=("plucker", "endpoint"), default="plucker")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--length", type=int, default=LENGTH, help="frames rendered")
    ap.add_argument("--switch-interval", type=float, default=None)
    ap.add_argument("--frames", default=None, help="load the frames from this .npy file")
    ap.add_argument("--save", default=None, help="write the rendered frames here and stop")
    ap.add_argument("--stages", action="store_true",
                    help="host ms per call of each step, by thread")
    args = ap.parse_args(argv)
    if args.save:
        np.save(args.save, render_frames(args.length))
        return 0
    if not torch.cuda.is_available():
        raise SystemExit("profile_slam: no CUDA device")
    if args.switch_interval is not None:
        sys.setswitchinterval(args.switch_interval)
    dev = torch.device("cuda:0")
    arr = np.load(args.frames) if args.frames else render_frames(args.length)
    frames = [tuple(torch.from_numpy(x).to(dev) for x in pair) for pair in arr]
    torch.cuda.synchronize()
    runs = [run_once(dev, frames, args.config, args.stages) for _ in range(args.reps)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    import plslam_tpu_torch

    print(json.dumps({"config": args.config,
                      "switch_interval": sys.getswitchinterval(),
                      "frames_per_s": [round(f, 3) for f, _, _ in runs],
                      "keyframes": [k for _, k, _ in runs],
                      "stages_ms_calls": [st for _, _, st in runs] if args.stages else None,
                      "package": os.path.dirname(plslam_tpu_torch.__file__), "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
