"""chip_smoke.py's phase 10 (batched VO and RGB-D) rehearsed on the CPU."""

import torch

from test_torch_helpers import load_chip_smoke

chip_smoke = load_chip_smoke()


def test_batch_phase_on_the_cpu(monkeypatch):
    """Phase 10 rehearsed on the CPU at 376x240 (2 streams, 512 points,
    128 line slots, 1 + 1 + 2 frames, B in 1 and 2, the ATE floors at
    B = 2 against generous stand-ins): the worker-process render, the
    sweep, the single-stream agreement and the RGB-D track; not the
    kernels' launch counts, the device timers or the card."""
    import sys

    monkeypatch.setitem(sys.modules, "chip_smoke", chip_smoke)   # the workers import it
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "KERNEL_WRAPPERS", ())
    monkeypatch.setattr(chip_smoke, "BATCH_SIZES", (1, 2))
    monkeypatch.setattr(chip_smoke, "BATCH_WARMUP", 1)
    monkeypatch.setattr(chip_smoke, "BATCH_FRAMES", 2)
    monkeypatch.setattr(chip_smoke, "BATCH_SCENE", dict(n_points=300, n_lines=40, width=376,
                                                       height=240, fx=217.6, fy=217.6,
                                                       cx=183.7, cy=126.1))
    monkeypatch.setattr(chip_smoke, "BATCH_WIDTHS", dict(n_points=512, n_lines=128))
    monkeypatch.setattr(chip_smoke, "BATCH_ATE_B", 2)
    monkeypatch.setattr(chip_smoke, "JAX_CPU_BATCH_ATE", (0.05, 0.05))
    monkeypatch.setattr(chip_smoke, "RENDER_WORKERS", 2)
    streams = chip_smoke.wait_batch_render(chip_smoke.start_batch_render())
    assert len(streams) == 2 and streams[0].shape == (4, 2, 240, 376)
    launches, rows, ates = chip_smoke.phase_batch(torch.device("cpu"), "CPU", streams)
    assert set(launches) == set(chip_smoke._wrappers()) and set(rows) == {1, 2}
    assert rows[2]["good"] == rows[2]["frames"] == 6 and len(ates) == 2
    launches, err = chip_smoke.phase_rgbd(torch.device("cpu"), "CPU")
    assert err < 0.02 and not any(launches.values())
