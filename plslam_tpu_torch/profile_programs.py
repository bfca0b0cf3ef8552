"""Host ms by step of the programs the port captures one trip at a time
(``graphs.Trips``): the chunked GBA at finish on chip_smoke.py phase 5's
map (``profile_slam``'s frames and Plücker configuration) and the PGO of
a loop closure on a K-keyframe ring (``io.ring_world.ring_pose_graph``),
each graphed and with ``capture=False``, REPS times in turn; and, for
scale, one full pass of Python's cyclic collector over the process's
objects once the map is built.

    python -m plslam_tpu_torch.profile_programs [--reps N] [--ring-kf K]

One line per run: its wall ms (host clock around a synchronized call),
the host ms of the capture (its warm-ups, the capture and the
instantiation), of the instantiation alone, of the trips and of the sync
at the end of the call, and the trips' report; then one JSON line.  Needs
CUDA."""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import gc
import json
import subprocess
import time

import numpy as np
import torch

# (owner, attribute, step name) of the steps timed
STEPS = (("Program", "_capture_locked", "capture_ms"),
         ("CUDAGraph", "capture_end", "instantiate_ms"),
         ("Trips", "run", "trips_ms"),
         ("Trips", "__exit__", "sync_release_ms"))


@contextlib.contextmanager
def timed_steps():
    """Host timers around ``STEPS``: yields the dict of step -> ms, which
    the caller clears before each run."""
    from plslam_tpu_torch import graphs

    owners = {"Program": graphs.Program, "Trips": graphs.Trips,
              "CUDAGraph": torch.cuda.CUDAGraph}
    acc = collections.defaultdict(float)
    saved = []
    for owner, attr, name in STEPS:
        cls = owners[owner]
        fn = getattr(cls, attr)

        def timed(*a, _fn=fn, _name=name, **k):
            t = time.perf_counter()
            try:
                return _fn(*a, **k)
            finally:
                acc[_name] += 1e3 * (time.perf_counter() - t)

        saved.append((cls, attr, fn))
        setattr(cls, attr, timed)
    try:
        yield acc
    finally:
        for cls, attr, fn in saved:
            setattr(cls, attr, fn)


def slam_map(dev):
    """The mapper after profile_slam's 20 Plücker frames, its deferred
    local BA applied: the map chip_smoke.py phase 5's GBA meets."""
    from plslam_tpu_torch.core.camera import StereoCamera
    from plslam_tpu_torch.pipeline import PLSLAM
    from plslam_tpu_torch.profile_slam import configs, render_frames, scene

    sc = scene()
    cam = StereoCamera.create(sc.fx, sc.fy, sc.cx, sc.cy, sc.b, width=sc.width, height=sc.height)
    slam = PLSLAM(cam, *configs("plucker"), device=dev)
    for i, pair in enumerate(render_frames()):
        slam.process(*(torch.from_numpy(x).to(dev) for x in pair), timestamp=0.05 * i)
    slam.finish(run_gba=False)
    slam.mapper.flush_ba()
    return slam.mapper


def run(dev, name: str, capture: bool, call, acc) -> dict:
    torch.cuda.synchronize(dev)
    acc.clear()
    t = time.perf_counter()
    report = call(capture)
    torch.cuda.synchronize(dev)
    wall = 1e3 * (time.perf_counter() - t)
    out = {"program": name, "graphed": capture, "wall_ms": round(wall, 3),
           **{k: round(v, 3) for k, v in acc.items()}, "report": report}
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> int:
    from plslam_tpu_torch.backend import pgo
    from plslam_tpu_torch.backend.mapping import MapHandler
    from plslam_tpu_torch.convert import pose_graph_from_numpy
    from plslam_tpu_torch.io.ring_world import ring_pose_graph

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--ring-kf", type=int, default=156, help="keyframes of the PGO's ring")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_programs: no CUDA device")
    dev = torch.device("cuda:0")
    mapper = slam_map(dev)
    tracked = len(gc.get_objects())
    t = time.perf_counter()
    gc.collect()
    gc_ms = 1e3 * (time.perf_counter() - t)
    print(json.dumps({"gc_full_pass_ms": round(gc_ms, 3), "tracked_objects": tracked}),
          flush=True)

    def gba(capture):
        m = MapHandler(mapper.cam, mapper.cfg, mapper.ba_cfg, tracker_cfg=mapper.tracker_cfg,
                       device=dev, capture=capture)
        m.map = copy.deepcopy(mapper.map)
        m.global_bundle_adjustment()
        return m.gba_trips

    graph = pose_graph_from_numpy(ring_pose_graph(seed=0, K=args.ring_kf), dev)

    def closure(capture):
        report = {}
        pgo.optimize(graph, 25, capture=capture, report=report).T_w_k.cpu()
        return report

    runs = []
    with timed_steps() as acc:
        for _ in range(args.reps):
            for name, call in (("gba", gba), ("pgo", closure)):
                for capture in (True, False):
                    runs.append(run(dev, name, capture, call, acc))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    summary = {f"{name} {'graphed' if cap else 'eager'}":
               float(np.median([r["wall_ms"] for r in runs
                                if r["program"] == name and r["graphed"] == cap]))
               for name in ("gba", "pgo") for cap in (True, False)}
    print(json.dumps({"median_wall_ms": summary, "gc_full_pass_ms": round(gc_ms, 3),
                      "tracked_objects": tracked, "card": smi}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
