"""The port's measurement programs and demo on the CPU at small sizes:
``profile_detect``, ``ab_fused_step``, ``profile_mapping`` and
``demo_synthetic`` run through their ``main`` and print their rows, and
``profile_map_host``'s ``SlamMap`` tables after its seeded sequence equal
those of the JAX ``SlamMap`` after the unedited JAX script's."""

import math

import numpy as np
import pytest
import torch

from plslam_tpu_torch import (ab_fused_step, demo_synthetic, profile_detect, profile_map_host,
                              profile_mapping)

from test_torch_helpers import load_script, one_torch_thread, words  # noqa: F401

SMALL = ["--device", "cpu", "--scale", "0.25"]
DETECT_ROWS = ["dispatch floor (trivial program)", "dispatch floor x2 (two chained)",
               "FUSED point+line detection", "point detect+describe (alone)",
               "line detect+LBD (alone)", "  pyramid build", "  FAST score+NMS (all levels, kernel)",
               "  score+NMS+select (all levels)", "  detect_pyramid_batch (score..topk)",
               "  ORB describe (300 kp x 2)", "  line detect_segments", "  LBD describe",
               "  line gradient front (blur+sobel+nms)"]


def test_profile_detect_rows(capsys):
    assert profile_detect.main(["2", *SMALL]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("device=cpu card=cpu N=2")
    rows = out[1:]
    assert [r[:42].rstrip() for r in rows] == [n.rstrip() for n in DETECT_ROWS]
    for r in rows:
        assert r.endswith(" ms") and math.isfinite(float(r[42:-3]))
    res = profile_detect.run("cpu", 2, 0.25)
    assert all(r["bits_equal"] for r in res["rows"]) and len(res["rows"]) == len(DETECT_ROWS)


def test_ab_fused_step_windows(capsys):
    assert ab_fused_step.main(["1", *SMALL]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[1].startswith("round 0: A(early)") and "B(scan)" in out[1] and "[-]" in out[1]
    assert out[2].startswith("median A ")
    res = ab_fused_step.run(1, device="cpu", scale=0.25, n_frames=4)
    assert [w["variant"] for w in res["windows"]] == ["A(early)", "B(scan)"]
    a, b = res["results"]["A(early)"], res["results"]["B(scan)"]
    assert all(bool(r.good) for r in a + b)
    # on these frames the two GN forms give the same poses, bit for bit
    assert all(torch.equal(x.T_f_w, y.T_f_w) for x, y in zip(a, b))


def test_profile_mapping_table(capsys):
    assert profile_mapping.main(SMALL) == 0
    out = capsys.readouterr().out.splitlines()
    names = [line[:28].rstrip() for line in out[2:8]]
    assert names == ["assoc+flushBA (1 fetch)", "  of which: combined fetch",
                     "spawn_landmarks(host)", "ba_assemble+dispatch", "cull(host)",
                     "final ba flush"]
    for line in out[2:8]:
        assert all(math.isfinite(float(v)) for v in line[28:].split())
    assert out[8].startswith("TOTAL per KF") and out[9].endswith(" 15 KFs")


def test_demo_synthetic_artifacts(tmp_path, capsys):
    assert demo_synthetic.main(["4", "--out", str(tmp_path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert [line[:9] for line in out.splitlines()[:3]] == ["frame   1", "frame   2", "frame   3"]
    assert "ATE RMSE (aligned)" in out
    for name in ("trajectory.txt", "frames.jsonl", "scene.html", "residuals.jsonl"):
        assert (tmp_path / name).stat().st_size > 0, name
    traj = np.loadtxt(tmp_path / "trajectory.txt", ndmin=2)
    assert traj.shape[1] == 8 and np.isfinite(traj).all()
    assert len((tmp_path / "frames.jsonl").read_text().splitlines()) == 3


def _jax_script_map(monkeypatch, n_kf):
    """The JAX SlamMap after the unedited scripts/profile_map_host.py."""
    mod = load_script("profile_map_host", [str(n_kf)])
    made = []

    class Recorded(mod.SlamMap):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(mod, "SlamMap", Recorded)
    mod.main()
    return made[0]


@pytest.mark.parametrize("n_kf", [60, 130])
def test_profile_map_host_tables_match_jax(monkeypatch, capsys, n_kf):
    """Prunes every 5th, merges every 25th and (at 130) drops a keyframe's
    observations at the 100th: every table equal."""
    want = _jax_script_map(monkeypatch, n_kf)
    got, per_kf = profile_map_host.run(n_kf)
    assert len(per_kf) == n_kf and np.isfinite(per_kf).all()
    assert got.n_pt == want.n_pt and len(got.keyframes) == len(want.keyframes)
    for name in ("pt_w", "pt_valid", "pt_first_kf", "pt_last_kf", "pt_nobs", "covis"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    np.testing.assert_array_equal(words(got.pt_desc), words(want.pt_desc))
    assert got.pobs.n == want.pobs.n
    for name in ("lm", "kf", "fi", "valid"):
        np.testing.assert_array_equal(getattr(got.pobs, name)[: got.pobs.n],
                                      getattr(want.pobs, name)[: want.pobs.n], err_msg=name)
    s = profile_map_host.summary(per_kf)
    assert len(s["median_ms"]) == 3 and s["growth_ratio"] > 0
    assert profile_map_host.main([str(n_kf)]) == 0
    printed = capsys.readouterr().out.splitlines()
    assert printed[-3] == printed[-6]     # the same KFs, landmarks and rows as JAX's
