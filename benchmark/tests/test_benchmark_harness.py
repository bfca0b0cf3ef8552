"""CPU tests of the benchmark's harness: the manifest and its names, the
files found by name, the renderer's repeatability, the end-to-end
arithmetic and the import check."""

import json
import shutil
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import manifest, run, scene, stats, work
from benchmark.reference import check

ROOT = Path(__file__).resolve().parents[2]


def _manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_manifest_names_units_and_texts():
    man = _manifest()
    manifest.validate(man)
    for m in man["end_to_end"] + man["per_layer"]:
        assert manifest.NAME.match(m["name"]) and manifest.UNIT.match(m["unit"])
    for bad in ("a b", "a,b", "a/b", "", "µs", "x" * 65, ".x"):
        with pytest.raises(ValueError):
            manifest.check_name(bad)
    broken = _manifest()
    broken["per_layer"][0]["unit"] = "ms per frame"
    with pytest.raises(ValueError):
        manifest.validate(broken)
    broken = _manifest()
    broken["workloads"][0]["config"] = "no_such_config"
    with pytest.raises(ValueError):
        manifest.validate(broken)


def test_manifest_holds_the_contract_keys():
    man = _manifest()
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert {m["name"] for m in man["end_to_end"]} == {
        "slam_frames_per_s", "track_latency_p50_ms", "setup_s"}
    for m in man["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for w in man["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for c in man["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]


@pytest.mark.parametrize("name", [w["name"] for w in _manifest()["workloads"]])
def test_every_cell_and_its_files_are_found_by_name(name):
    cell = manifest.Manifest(ROOT).cell(name)
    assert cell.loop in ("offline", "live")
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    moved = {m["name"] for m in cell.end_to_end}
    for m in cell.per_layer:
        assert m["moves"] in moved
        assert callable(manifest.reader(m["name"]))
    assert set(cell.spec["check"]["limits"]) <= set(check.NUMBERS)


def test_a_cell_and_a_metric_dropped_in_as_files(tmp_path):
    """A new traffic mix, cell and per-layer metric are files plus manifest
    entries: no code changes."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "_checkout"))
    man = _manifest()
    bench = tmp_path / "benchmark"
    tr = json.loads((bench / "traffic" / "hall.offline.json").read_text())
    tr["route"]["frames"] = 628
    (bench / "traffic" / "hall.slow.json").write_text(json.dumps(tr))
    spec = json.loads((bench / "cells" / "euroc_mav.offline.json").read_text())
    spec["traffic"] = "hall.slow"
    (bench / "cells" / "euroc_mav.slow.json").write_text(json.dumps(spec))
    (bench / "metrics" / "frames.in_window.py").write_text(
        "def read(ctx):\n    return float(len(ctx['frames']['t_call']))\n")
    man["workloads"].append({"name": "euroc_mav.slow", "config": "euroc_mav",
                             "traffic": "hall.slow", "chips": 1, "why": "slower lap"})
    next(m for m in man["end_to_end"]
         if m["name"] == "slam_frames_per_s")["workloads"].append("euroc_mav.slow")
    man["per_layer"].append({"name": "frames.in_window", "unit": "count", "better": "higher",
                             "source": "host_clock", "layer": "SLAM driver (pipeline)",
                             "moves": "slam_frames_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    cell = manifest.Manifest(tmp_path).cell("euroc_mav.slow")
    assert cell.traffic["route"]["frames"] == 628
    assert "frames.in_window" in {m["name"] for m in cell.per_layer}
    # without a workloads key, it goes to every cell reporting what it moves
    live = manifest.Manifest(tmp_path).cell("euroc_mav.live")
    assert "frames.in_window" not in {m["name"] for m in live.per_layer}
    read = manifest.reader("frames.in_window", bench)
    assert read({"frames": {"t_call": [1, 2, 3]}}) == 3.0


def test_missing_manifest_fails(tmp_path):
    with pytest.raises(FileNotFoundError):
        manifest.Manifest(tmp_path)


def _small(traffic: dict, frames: int = 6) -> dict:
    t = json.loads(json.dumps(traffic))
    t["route"]["frames"] = frames
    t["landmarks"]["points"] = 300
    t["landmarks"]["lines"] = 30
    return t


def test_renderer_repeats_exactly_from_a_seed():
    cell = manifest.Manifest(ROOT).cell("euroc_mav.offline")
    cam = scene.Camera(188, 120, 109.06, 109.06, 91.11, 64.24, 0.110078)
    tr = _small(cell.traffic)
    seed = 2 ** 33 + 5
    a = scene.render_lap(cam, tr, seed, torch.device("cpu"))
    b = scene.render_lap(cam, tr, seed, torch.device("cpu"))
    c = scene.render_lap(cam, tr, seed + 1, torch.device("cpu"))
    assert a.frames.dtype == torch.uint8 and a.frames.shape == (6, 2, 120, 188)
    assert torch.equal(a.frames, b.frames) and np.array_equal(a.poses, b.poses)
    assert torch.equal(a.marks.P, b.marks.P)
    assert not torch.equal(a.frames, c.frames)
    # one route and one world: a seed draws the sensor noise
    assert np.array_equal(a.poses, c.poses) and torch.equal(a.marks.P, c.marks.P)


@pytest.mark.parametrize("name", ["hall.offline", "block.live"])
def test_routes_close_and_start_at_the_identity(name):
    tr = json.loads((ROOT / "benchmark" / "traffic" / f"{name}.json").read_text())
    route = scene.Route(tr["route"])
    P = route.poses()
    assert np.allclose(P[0], np.eye(4))
    step = np.linalg.norm(np.diff(P[:, :3, 3], axis=0), axis=1)
    wrap = np.linalg.norm(P[0, :3, 3] - P[-1, :3, 3])
    assert abs(wrap - step.mean()) < 0.05 * step.mean()
    assert np.allclose(P[:, :3, :3] @ np.swapaxes(P[:, :3, :3], 1, 2), np.eye(3), atol=1e-12)


def test_a_splat_matches_the_host_formula():
    cam = scene.Camera(40, 30, 20.0, 20.0, 20.0, 15.0, 0.1)
    flat = torch.full((30 * 40,), scene.BACKGROUND, dtype=torch.float32)
    u, v = torch.tensor([17.3], dtype=torch.float64), torch.tensor([11.6], dtype=torch.float64)
    scene._splat(flat, torch.tensor([0]), u, v, torch.tensor([200.0], dtype=torch.float64),
                 cam, 1.1, 3)
    img = flat.view(30, 40).numpy()
    ys, xs = np.mgrid[8:15, 14:21]
    g = 200.0 * np.exp(-((xs - 17.3) ** 2 + (ys - 11.6) ** 2) / (2 * 1.1 * 1.1))
    assert np.allclose(img[8:15, 14:21], np.maximum(30.0, g), atol=1e-4)
    assert (img[:8] == 30.0).all() and (img[:, :14] == 30.0).all()


def test_percentiles_and_rates():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 50) == pytest.approx(50.5)
    assert stats.percentile(xs, 95) == pytest.approx(np.percentile(xs, 95))
    assert stats.rate(300, 30.0) == 10.0
    due = [i * 0.1 for i in range(200)]
    done = [d + 0.02 for d in due]
    lat = stats.latencies_ms(due, done)
    assert stats.percentile(lat, 95) == pytest.approx(20.0)
    # a one-second stall at frame 100: the frames queued behind it carry the wait
    stalled, t = [], 0.0
    for i, d in enumerate(due):
        t = max(t, d) + (1.0 if i == 100 else 0.02)
        stalled.append(t)
    lat_s = stats.latencies_ms(due, stalled)
    assert stats.percentile(lat_s, 95) > 5 * stats.percentile(lat, 95)
    assert stats.percentile(lat_s, 50) == pytest.approx(20.0)
    # a closed loop's rate counts the drain: a slow drain lowers it
    assert stats.rate(600, 30.0 + 3.0) < stats.rate(600, 30.0)


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def test_the_check_sees_a_minority_of_bad_frames_and_the_lost_ones():
    """The medians stay put when a fifth of the frames are off; the 90th
    percentile over the tracked frames and the share of lost frames do
    not."""
    n = 101
    lap = np.repeat(np.eye(4)[None], n, 0)
    lap[:, 0, 3] = 0.05 * np.arange(n)
    truth = {"poses": lap}
    out = {"frames": np.arange(n), "poses": lap.copy(), "is_kf": np.zeros(n, bool),
           "good": np.ones(n, bool), "kf_poses": lap[:1], "kf_submitted": lap[:1],
           "points_nobs": np.array([2, 3])}
    sound = check.readings(out, truth, window_from=1)
    assert sound["frame_r_p90_mrad"] < 1e-6 and sound["frame_fail_pct"] == 0.0
    assert sound["kf_mismatch"] == 0.0 and sound["landmark_single_pct"] == 0.0
    bad = dict(out, poses=lap.copy())
    for i in range(5, n, 10):  # one frame in ten turned: two motions in ten off
        bad["poses"][i, :3, :3] = _rot_y(0.005)
    read = check.readings(bad, truth, window_from=1)
    assert read["frame_r_mrad"] < 1e-6
    assert read["frame_r_p90_mrad"] == pytest.approx(5.0, rel=1e-3)
    lost = dict(out, good=np.arange(n) % 4 == 0)
    assert check.readings(lost, truth, window_from=1)["frame_fail_pct"] == 75.0
    ok, checks = check.judge(read, {"frame_r_mrad": 1.0, "frame_r_p90_mrad": 2.0})
    assert not ok and list(checks) == ["frame_r_mrad", "frame_r_p90_mrad"]


def test_work_formulas():
    nbytes, ops = work.hamming((1200, 8), (1200, 8))
    assert nbytes == 2400 * 32 + 1200 * 1200 * 4 and ops["int8"] == 2.0 * 1200 * 1200 * 256
    nbytes, _ = work.patches((2, 480, 752), (2, 1200), 48)
    assert nbytes == 4 * 2 * 480 * 752 + 8 * 2400 + 4 * 2400 * 48 * 48
    nbytes, ops = work.fast((2, 480, 752))
    assert nbytes == 12 * 2 * 480 * 752 + 8 and ops["f32_minmax"] == 19 * 2 * 480 * 752
    b = work.bound_s(3.35e12, {}, "NVIDIA H100 80GB HBM3")
    assert b == pytest.approx(1.0)
    with pytest.raises(KeyError):
        work.peaks("some other card")


def test_import_check_compares_whole_top_level_names(monkeypatch):
    base = set(run.forbidden_modules())
    monkeypatch.setitem(sys.modules, "plslam_tpu_torch_like", types.ModuleType("x"))
    assert set(run.forbidden_modules()) == base
    monkeypatch.setitem(sys.modules, "plslam_tpu.core", types.ModuleType("x"))
    assert "plslam_tpu" in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert "jax" in run.forbidden_modules()


def test_the_harness_and_reference_load_no_jax():
    code = ("import sys; import benchmark.run, benchmark.control, benchmark.trace, "
            "benchmark.reference.check, plslam_tpu_torch.pipeline; "
            "from benchmark.run import forbidden_modules; "
            "assert not forbidden_modules(), forbidden_modules(); "
            "ref = [m for m in sys.modules if m.startswith('plslam_tpu_torch')]; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr
    code = ("import sys, benchmark.reference.check; "
            "assert not [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'plslam_tpu', 'plslam_tpu_torch', 'torch')], 'reference imports'; "
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr


def test_the_command_refuses_a_directory_without_the_program(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "_checkout"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "euroc_mav.offline", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "correct" not in out.stdout
