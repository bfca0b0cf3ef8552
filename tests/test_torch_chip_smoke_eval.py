"""chip_smoke.py's phase 12 (the evaluation path) rehearsed on the CPU."""

import numpy as np
import torch

from test_torch_helpers import load_chip_smoke, one_thread  # noqa: F401

chip_smoke = load_chip_smoke()


def test_eval_phase_on_the_cpu(monkeypatch, one_thread):
    """Phase 12 rehearsed on the CPU at small sizes: the worker render of the
    nuisance frames (2 workers, 376x240, 6 frames), each program through
    its main with its checks against stand-in JAX values that hold at this
    size (the module tests hold the programs against JAX itself), the
    loop stress cut to 40 + 24 + 12 keyframes, the oracle cut to the
    256-point ring and 3 iterations; not the kernels' launch counts or the
    card."""
    import sys

    from plslam_tpu_torch import (compare_line_modes, e2e_robust, endpoint_gba_ab,
                                  line_match_quality, loop_stress)

    monkeypatch.setitem(sys.modules, "chip_smoke", chip_smoke)
    # one thread throughout (one_thread): the f32 solves move with the
    # order of their sums, so the stand-ins are made as the phase runs
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "KERNEL_WRAPPERS", ())
    monkeypatch.setattr(chip_smoke, "RENDER_WORKERS", 2)
    monkeypatch.setattr(chip_smoke, "EVAL_FRAMES", 6)
    small = dict(width=376, height=240, fx=217.6, fy=217.6, cx=183.7, cy=126.1)
    make_scene = e2e_robust.make_scene
    monkeypatch.setattr(e2e_robust, "make_scene", lambda size=None: make_scene(small))
    monkeypatch.setattr(chip_smoke, "JAX_CPU_E2E", {"plucker": (5, 2, 0.01, 0.01),
                                                    "endpoint": (5, 2, 0.01, 0.01)})
    # the line-mode comparison at 5 frames, the harness's first two rows at
    # 1 scene x 1 step
    cmp_main = compare_line_modes.main
    monkeypatch.setattr(compare_line_modes, "main", lambda argv: cmp_main(argv, n_frames=5))
    monkeypatch.setattr(chip_smoke, "JAX_CPU_COMPARE", {"endpoint": 0.03, "plucker": 0.03})
    run = line_match_quality.run
    monkeypatch.setattr(line_match_quality, "run",
                        lambda cfg, **kw: run(cfg, n_scenes=1, n_steps=1, **kw))
    monkeypatch.setattr(line_match_quality, "CONFIGS", line_match_quality.CONFIGS[:2])
    rows = [run(line_match_quality.FrontendConfig(), n_scenes=1, n_steps=1, label=label,
                device="cpu", **kw) for label, kw in line_match_quality.CONFIGS]
    monkeypatch.setattr(chip_smoke, "JAX_CPU_LMQ", tuple(
        (r["label"], r["matches"], r["correct"]) for r in rows))
    build, lm = endpoint_gba_ab.build, endpoint_gba_ab.faithful_endpoint_lm
    monkeypatch.setattr(endpoint_gba_ab, "build", lambda plucker, device: build(
        plucker, device, n_kf=16, n_pts=256, n_ls=64))
    monkeypatch.setattr(endpoint_gba_ab, "faithful_endpoint_lm", lambda m, timings: lm(
        m, iters=3, timings=timings))
    # the oracle's and the endpoint GBA's stand-ins are their own values;
    # the Plücker GBA is held to the error before it
    mapper, (_, truth) = build(False, "cpu", n_kf=16, n_pts=256, n_ls=64)
    ref = lm(mapper, iters=3)
    mapper.global_bundle_adjustment()
    monkeypatch.setattr(chip_smoke, "JAX_CPU_GBA", dict(
        ours_plucker=1.0, ours_endpoint=endpoint_gba_ab.pt_err(mapper, truth),
        oracle_pt=float(np.median(np.linalg.norm(ref[1] - truth[ref[3]], axis=1))),
        oracle_last=ref[4][-1], oracle_iters=3))
    stress = loop_stress.main
    monkeypatch.setattr(loop_stress, "main", lambda argv: stress(
        argv, n_a1=40, n_b=24, n_a2=12, vocab_refresh_kfs=16, ring_steps=100))
    frames = chip_smoke.wait_eval_render(chip_smoke.start_eval_render())
    assert len(frames) == 6 and frames[0][0].shape == (240, 376)
    launches, summary = chip_smoke.phase_eval(torch.device("cpu"), "CPU", frames)
    assert set(launches) == set(chip_smoke._wrappers())
    assert set(summary) == {"e2e", "e2e_gap", "compare_diff", "lmq_production", "gba",
                            "closures"}
    assert summary["closures"]
