"""The correctness check against planted faults, on the CPU at half the
cell's width: a run of the harness (past its look for a card) with the
system under test broken underneath (``benchmark/faults.py``) has to come
out not correct, and the same run unbroken correct; so has the control
(``control.py``) at that size.  The faults a single-stream SLAM cell can
have: a step that returns its state unchanged, an answer altered where it
is produced (a pose, a keyframe flag); and, in a cell that holds the
mapper, its local BA's result thrown away, its association dropped, and
its landmarks left unchanged.  The cells have no batch to halve and no
exchange between chips.

The mapper's numbers depend on the size of the map: at this size (a
window of ~40 frames, ~12 keyframes) the local BA has held the drift for
a few spans only and most points are young, so those two limits are set
anew from readings at this size (``SMALL_LIMITS``); the rest are the
cell's own."""

import copy
from pathlib import Path

import pytest
import torch

from benchmark import faults, manifest
from benchmark.reference import check

ROOT = Path(__file__).resolve().parents[2]
SEED = 3_000_000_001
MAPPER_NUMBERS = {"kf_drift_mm", "landmark_single_pct"}
# readings at this size (seed SEED, 35 s window): kf_drift_mm 71.0 sound,
# 151.6 with the local BA's result thrown away; landmark_single_pct 40.3
# sound, 100 with the association dropped, none left with the map unchanged
SMALL_LIMITS = {"kf_drift_mm": 105.0, "landmark_single_pct": 65.0}


def _cell(name):
    cell = copy.deepcopy(manifest.Manifest(ROOT).cell(name))
    c = cell.config["camera"]
    for k in ("fx", "fy", "cx", "cy"):
        c[k] *= 0.5
    c["width"], c["height"] = c["width"] // 2, c["height"] // 2
    cell.spec["warmup"] = {"min_frames": 6, "quiet_keyframes": 1, "max_frames": 10}
    limits = cell.spec["check"]["limits"]
    limits.update({k: v for k, v in SMALL_LIMITS.items() if k in limits})
    return cell


def _cases():
    out = []
    for w in manifest.Manifest(ROOT).data["workloads"]:
        limits = manifest.Manifest(ROOT).cell(w["name"]).spec["check"]["limits"]
        fl = ("none", "control") + faults.VO_FAULTS
        if MAPPER_NUMBERS & set(limits):
            fl += faults.MAPPER_FAULTS
        out += [(w["name"], f) for f in fl]
    return out


@pytest.mark.parametrize("name,fault", _cases())
def test_a_broken_step_is_not_correct(name, fault):
    torch.set_num_threads(4)
    cell = _cell(name)
    # the live loop sends every frame due in the window (20 a second),
    # each a CPU second here: a short window
    seconds = 1.0 if cell.loop == "live" else 35.0
    res = faults.run_with(cell, fault, SEED, seconds, torch.device("cpu"), capture=False)
    assert set(res["checks"]) == set(cell.spec["check"]["limits"]) <= set(check.NUMBERS)
    assert list(res)[-1] == "checks"
    assert res["correct"] is (fault == "none"), res["checks"]
    # every call gave a pose: a frame the tracker declares lost is an answer,
    # held by ``frame_fail_pct``, not a failed operation
    assert res["attempted"] > 0 and res["failed"] == 0
