"""Faults planted in the system under test, and the control, for the check
of ``correct``: a run of the harness with the timed path broken underneath
has to come out not correct, and its readings set the upper end of the
limits (``PERF.md`` gives them).

    python3 -m benchmark.faults --workload <cell> --seed <n> --fault <name>

A window of the manifest's ``run_seconds``.  Prints one JSON line: the
run's readings beside the cell's limits.  The
benchmark's own runs never plant anything.  Faults, each from the
``AFTER``-th tracked frame on where it is in the tracking step:

- ``none``: nothing planted (a sound run, for the lower readings);
- ``control``: the cell's control (``control.py``);
- ``unchanged``: the tracking step returns the pose of an early frame
  from then on (a step that returns its state unchanged);
- ``pose``: every fifth tracked pose turned by 5 mrad about the vertical
  (an answer altered where it is produced, in a minority of frames);
- ``kf_flag``: the keyframe flag each call returns flipped;
- ``lba_discarded``: the local BA solves and its result is thrown away
  (the mapper's state left unchanged by its optimiser);
- ``assoc_dropped``: the association's matches thrown away, so each
  keyframe's features seed new landmarks and no landmark gains a view;
- ``map_unchanged``: the keyframe goes into the map, but neither the
  association's matches nor new landmarks do: the landmarks stay as they
  were.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

from . import control, manifest, run

AFTER = 3
VO_FAULTS = ("unchanged", "pose", "kf_flag")
MAPPER_FAULTS = ("lba_discarded", "assoc_dropped", "map_unchanged")
FAULTS = ("none", "control") + VO_FAULTS + MAPPER_FAULTS


class Broken:
    """The system under test with a tracking-step fault planted: in the VO
    step's outputs (the pose it returns and the per-frame scalars the
    pipeline reads), or in the keyframe decision the call returns."""

    def __init__(self, slam, fault):
        import torch

        self._slam, self._fault, self._n = slam, fault, 0
        self._first = None
        vo = slam.vo
        step = vo.process

        def process(img_l, img_r):
            res = step(img_l, img_r)
            self._n += 1
            if self._n <= AFTER:
                self._first = res.T_f_w.clone()
                return res
            if self._fault == "unchanged":
                T = self._first.clone()
            elif self._fault == "pose" and self._n % 5 == 0:
                T = res.T_f_w.clone()
                c, s = math.cos(0.005), math.sin(0.005)
                R = torch.tensor([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]],
                                 dtype=T.dtype, device=T.device)
                T[:3, :3] = T[:3, :3] @ R
            else:
                return res
            vo.frame_scalars[5:21] = T.reshape(16).to(vo.frame_scalars.dtype)
            return res._replace(T_f_w=T)

        vo.process = process

    def __getattr__(self, name):
        return getattr(self._slam, name)

    def process(self, img_l, img_r):
        res = self._slam.process(img_l, img_r)
        if self._fault == "kf_flag" and res is not None and self._n > AFTER:
            log = self._slam.logs[-1]
            log.is_kf = not log.is_kf
        return res


def break_mapper(slam, fault):
    """Plant a mapper fault in ``slam.mapper`` (its instance methods, which
    the mapping thread calls through ``self``)."""
    m = slam.mapper
    if fault == "lba_discarded":
        m._finish_local_ba = lambda out, lay, meta: None
    elif fault in ("assoc_dropped", "map_unchanged"):
        for name in ("_apply_kf2kf_points", "_apply_kf2kf_lines", "_apply_map2kf"):
            setattr(m, name, lambda *a, **k: None)
        if fault == "map_unchanged":
            m._spawn_landmarks = lambda kf: None
    else:
        raise ValueError(f"no mapper fault {fault!r}")
    return slam


def factory(fault: str):
    """A ``slam_factory`` for ``run.run_cell`` that plants ``fault``."""
    def build(cell, device, capture):
        slam = run.build_slam(cell, device, capture)
        if fault in VO_FAULTS:
            return Broken(slam, fault)
        if fault in MAPPER_FAULTS:
            return break_mapper(slam, fault)
        return slam
    return build


def run_with(cell, fault: str, seed: int, seconds: float, device, capture: bool = True):
    """One run of the harness with ``fault`` planted (``control``: the
    cell's control configuration)."""
    if fault not in FAULTS:
        raise ValueError(f"no fault {fault!r}; one of {FAULTS}")
    if fault == "control":
        return run.run_cell(control.broken(cell), seed, seconds, False, device,
                            capture=capture)
    return run.run_cell(cell, seed, seconds, False, device, slam_factory=factory(fault),
                        capture=capture)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run with a fault planted")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--fault", required=True, choices=FAULTS)
    args = ap.parse_args(argv)
    man = manifest.Manifest(Path.cwd())
    cell = man.cell(args.workload)
    seconds = float(man.data["run_seconds"])
    import torch

    if not torch.cuda.is_available():
        print("faults are read on the card", file=sys.stderr)
        return 3
    res = run_with(cell, args.fault, args.seed, seconds, torch.device("cuda", 0))
    print(json.dumps({"workload": args.workload, "seed": args.seed, "fault": args.fault,
                      "correct": res["correct"], "attempted": res["attempted"],
                      "failed": res["failed"], "metrics": res["metrics"],
                      "readings": res["readings"], "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
