"""The measurement programs and the demo at full size on the card: each
``python -m plslam_tpu_torch.<name>`` exits 0 and prints its rows, on the
card with its name and power limit.

Marked ``gpu``; each test skips when no CUDA device is present.  On a
machine with one (``--noconftest``: its tests/conftest.py imports jax):
    python -m pytest -m gpu --noconftest tests/test_torch_gpu_programs.py
"""

import json
import os
import subprocess
import sys

import pytest
import torch

pytestmark = pytest.mark.gpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _main(*argv: str) -> str:
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the programs run on the card")
    proc = subprocess.run([sys.executable, "-m", *argv], cwd=ROOT, capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


def test_roofline_on_the_card():
    out = _main("plslam_tpu_torch.roofline")
    res = json.loads(out.splitlines()[-1])
    assert torch.cuda.get_device_name(0) in res["card"] and " W" in res["card"]
    assert len(res["roofline"]) == 4
    for r in res["roofline"]:
        assert r["graphed"] and r["bits_equal"] and r["busy_ms"] > 0 and r["bound_ms"] > 0
    assert "frames/s compute ceiling" in out


def test_profile_detect_on_the_card():
    out = _main("plslam_tpu_torch.profile_detect").splitlines()
    assert torch.cuda.get_device_name(0) in out[0] and "CUDA kernels" in out[0]
    assert len(out) == 14 and all(line.endswith(" ms") for line in out[1:])


def test_ab_fused_step_on_the_card():
    out = _main("plslam_tpu_torch.ab_fused_step", "2").splitlines()
    rounds = [line for line in out if line.startswith("round ")]
    assert len(rounds) == 2 and all(" MHz, " in line and " W]" in line for line in rounds)
    assert out[-1].startswith("median A ")


def test_profile_mapping_on_the_card():
    out = _main("plslam_tpu_torch.profile_mapping").splitlines()
    assert out[-2].startswith("TOTAL per KF") and out[-1].endswith(" 15 KFs")


def test_demo_synthetic_on_the_card(tmp_path):
    out = _main("plslam_tpu_torch.demo_synthetic", "12", "--out", str(tmp_path))
    assert "ATE RMSE (aligned)" in out
    for name in ("trajectory.txt", "frames.jsonl", "scene.html", "residuals.jsonl"):
        assert (tmp_path / name).stat().st_size > 0, name
