"""``python -m plslam_tpu_torch.run_baseline_suite --mini`` on the CPU: the
suite writes the mini fixture and its config overlay, runs the port's CLI
in a subprocess and tabulates the JSON tail; one configuration
(points-only) on the reference's config_fast.yaml keeps it short."""

import os
import subprocess
import sys

import pytest

from plslam_tpu_torch import run_baseline_suite

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
FAST = os.path.join(ROOT, "configs", "config_fast.yaml")


def test_baseline_suite_mini():
    """The suite writes its config overlay, runs the CLI in a subprocess on
    the mini fixture and tabulates the JSON tail."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-m", "plslam_tpu_torch.run_baseline_suite", "--mini",
                        "--device", "cpu", "--config", FAST, "--configs", "1-points-only"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    rows = [ln for ln in r.stdout.splitlines() if ln.startswith("| 1-points-only")]
    assert len(rows) == 1 and "ERR" not in rows[0], r.stdout
    ate = float(rows[0].split("|")[3].split()[0])
    assert ate < 0.15, rows


def test_config_overlay_round_trips(tmp_path):
    """The overlay keeps every key of the base config and applies the
    configuration's overrides; the port reads it back with typed floats."""
    import yaml

    from plslam_tpu_torch.config import PLSLAMConfig

    base = os.path.join(ROOT, "configs", "config_euroc.yaml")
    path = run_baseline_suite.write_overlay(
        base, run_baseline_suite.CONFIGS["3-endpoint-lc"], str(tmp_path / "o.yaml"))
    data = yaml.safe_load(open(path))
    assert data["use_loop_closure"] is True and data["use_line_plucker"] is False
    cfg = PLSLAMConfig.from_yaml(path)
    assert cfg.orb_nfeatures == 800 and cfg.min_error == 1e-7 and cfg.has_lines


def test_unknown_configuration_is_refused():
    with pytest.raises(SystemExit):
        run_baseline_suite.main(["--mini", "--configs", "5-nonexistent"])
