"""chip_smoke.py's phase 14 (the measurement programs and the demo)
rehearsed on the CPU."""

import torch

from plslam_tpu_torch import ab_fused_step, bench, profile_detect, roofline
from plslam_tpu_torch.io import circular_trajectory

from test_torch_helpers import load_chip_smoke, one_thread  # noqa: F401

chip_smoke = load_chip_smoke()


def test_programs_phase_on_the_cpu(monkeypatch, one_thread):
    """Phase 14 on the CPU at a quarter of the width (188x120, 300 points,
    64 line slots; the BA at 8 keyframes, 128 points, 16 lines), 2 calls
    per program, 1 A/B round, a 4-frame demo; every check of the phase but
    the kernels' launch counts (CPU tensors take the plain twins) and the
    graph captures (``graphed`` is False off the card).  The A/B windows'
    ATE is held to a stand-in floor of 0.3 m: at 188x120 the bench scene's
    VO drifts 0.14 m over the 20 timed frames in both GN forms alike (the
    forms' poses are equal bit for bit); phase 4's floor is for 752x480."""
    small_scene, small_widths = bench.scaled(0.25)
    monkeypatch.setattr(bench, "SCENE", small_scene)
    monkeypatch.setattr(bench, "WIDTHS", small_widths)
    monkeypatch.setattr(chip_smoke, "KERNEL_WRAPPERS", ())
    monkeypatch.setattr(chip_smoke, "AB_ROUNDS", 1)
    monkeypatch.setattr(chip_smoke, "DEMO_FRAMES", 4)
    monkeypatch.setattr(chip_smoke, "ATE_FLOOR", 0.3)
    rf_run, pd_run = roofline.run, profile_detect.run
    monkeypatch.setattr(roofline, "run", lambda dev: rf_run(dev, n=2, scale=0.25))
    monkeypatch.setattr(profile_detect, "run", lambda dev, say=None: pd_run(dev, 2, say=say))
    # off the card nothing is captured: the phase's "graphed" checks read
    # True for a program that ran its function
    monkeypatch.setattr(roofline.graphs.Program, "captured", property(lambda self: True))
    poses = circular_trajectory(1 + ab_fused_step.N_WARMUP + ab_fused_step.N_FRAMES,
                                step_t=0.05)
    frames = bench.render(small_scene, len(poses), "cpu")
    launches = chip_smoke.phase_programs(torch.device("cpu"), "CPU", frames, poses)
    assert set(launches) == set(chip_smoke._wrappers())
