"""chip_smoke.py's phase 9 (the disk path) rehearsed on the CPU."""

import importlib.util
import os

import torch

from test_torch_helpers import load_chip_smoke

chip_smoke = load_chip_smoke()


def test_disk_phase_on_the_cpu(tmp_path, monkeypatch):
    """Phase 9 rehearsed on the CPU at the mini fixture's size (376x240, 9
    frames, diagnostics of frames 4 and 8): the CLI run and every check but
    the kernels' launch counts, the device timers and the card itself."""
    import subprocess
    import sys

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "graph_ms", lambda fn, *a: (fn(), 0.0)[1])
    monkeypatch.setattr(chip_smoke, "median_ms", lambda fn, *a: (fn(), 0.0)[1])
    monkeypatch.setattr(chip_smoke, "KERNEL_WRAPPERS", ())
    # this process loaded JAX for the parity tests (the check is tested above)
    monkeypatch.setattr(chip_smoke, "assert_no_jax", lambda: None)
    monkeypatch.setattr(chip_smoke, "DISK_FRAMES", 9)
    monkeypatch.setattr(chip_smoke, "DISK_OVERLAY_EVERY", 4)
    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib" else find_spec(name, *a))
    fixture = str(tmp_path / "disk")
    writer = subprocess.Popen([sys.executable, "-m", "plslam_tpu_torch.io.mini_euroc", fixture,
                               "--frames", "9"], cwd=chip_smoke.ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
    chip_smoke.wait_disk_fixture(writer)
    by_thread, fps, ate, remap_us = chip_smoke.phase_disk(torch.device("cpu"), "CPU", fixture)
    assert fps > 0 and ate <= chip_smoke.DISK_ATE_FLOOR and remap_us == 0.0
    assert set(by_thread) == set(chip_smoke._wrappers())
    with open(os.path.join(fixture, "residuals.jsonl")) as f:
        assert len(f.readlines()) == 2
