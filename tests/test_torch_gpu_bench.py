"""The benchmark twins at full size on the card: each
``python -m plslam_tpu_torch.<twin>`` with no arguments exits 0 and prints
its JAX program's JSON lines (the metric names, every frame of bench.py's
best window good; no allocator cache release before bench_slam's captures
in its timed window of a fresh process), with the card's name and power
limit on standard error.

Marked ``gpu``; each test skips when no CUDA device is present.  On a
machine with one (``--noconftest``: its tests/conftest.py imports jax):
    python -m pytest -m gpu --noconftest tests/test_torch_gpu_bench.py
"""

import json
import os
import subprocess
import sys

import pytest
import torch

pytestmark = pytest.mark.gpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRICS = {"bench": ["stereo_vo_tracked_frames_per_s"],
           "bench_slam": ["full_slam_frames_per_s", "local_ba_lm_iterations_per_s"],
           "bench_batch_vo": [f"batch_vo_frames_per_s_B{B}" for B in (1, 2, 4, 8, 16)],
           "bench_dist_gba": [None]}


@pytest.mark.parametrize("twin", list(METRICS))
def test_twin_main_on_the_card(twin):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the twins run on the card")
    proc = subprocess.run([sys.executable, "-m", f"plslam_tpu_torch.{twin}"], cwd=ROOT,
                          capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert [ln.get("metric") for ln in lines] == METRICS[twin]
    name = torch.cuda.get_device_name(0)
    assert name in proc.stderr and " W" in proc.stderr
    if twin == "bench":
        assert "good_frames=20/20" in proc.stderr
    if twin == "bench_slam":
        assert "allocator cache releases before them: 0" in proc.stderr
    if twin == "bench_dist_gba":
        w = torch.cuda.device_count()
        assert {"single", f"mesh{w}", f"mesh1x{w}"} <= set(lines[0])
