"""The port's disk entry point end to end on the CPU (tests/test_disk_e2e.py's
path): the 8-frame mini fixture in the EuRoC layout goes through
``python -m plslam_tpu_torch.run_euroc --device cpu``, read by the host
reader and by the prefetching loader, to a TUM trajectory and the JSON ATE
tail (under 0.15 m, as tests/test_disk_e2e.py asks of the JAX package);
the native evaluate_ate scores the same files where that binary runs.  The
runs take the reference's config_fast.yaml (600 ORB points on one level,
100 line slots), the lightest shipped configuration, to stay short on the
CPU (tests/test_torch_baseline_suite.py drives the suite's ``--mini``).

Run as a script, the module records the JAX package's CLI on a fixture,
frame by frame: the reference behind chip_smoke.py's phase 9 constants
(``JAX_CPU_DISK_ATE``, ``JAX_CPU_DISK_LOST``)::

    python -m plslam_tpu_torch.io.mini_euroc DIR --frames 40 --euroc-size
    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_disk_e2e.py DIR configs/config_euroc.yaml
"""

import importlib.util
import json
import os
import subprocess
import sys
import tempfile
from unittest import mock

import numpy as np
import pytest

from plslam_tpu_torch import run_euroc
from plslam_tpu_torch.io import mini_euroc

from test_torch_helpers import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
EVALUATE_ATE = os.path.join(ROOT, "plslam_tpu", "native", "evaluate_ate")
FAST = os.path.join(ROOT, "configs", "config_fast.yaml")


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    return mini_euroc.make(str(tmp_path_factory.mktemp("disk") / "mini"), frames=8)


@pytest.mark.parametrize("loader", [False, True])
def test_cli_disk_to_ate(mini, tmp_path, capsys, loader):
    out_traj = str(tmp_path / "traj.txt")
    argv = [mini["dir"], "--params", mini["params"], "--gt", mini["gt_csv"],
            "--out", out_traj, "--config", FAST, "--device", "cpu"]
    argv += ["--native-loader"] if loader else []
    res = run_euroc.main(argv)
    stdout = capsys.readouterr().out
    tail = json.loads([ln for ln in stdout.splitlines() if ln.startswith("{")][-1])
    assert set(tail) == {"ate_rmse_m", "n_keyframes"}
    assert tail["ate_rmse_m"] == round(res["ate_rmse_m"], 4)
    # the mini trajectory spans ~0.35 m: below 0.15 m the whole path tracked
    assert tail["ate_rmse_m"] < 0.15, tail
    slam = res["slam"]
    rows = open(out_traj).read().strip().splitlines()
    assert len(rows) == len(slam.mapper.map.keyframes) == tail["n_keyframes"] >= 2
    assert all(lg.good for lg in slam.logs) and len(slam.logs) == mini["frames"] - 1
    assert set(res["stages"]) == ({"wait", "upload", "rectify", "process"} if loader
                                  else {"read", "process"})
    assert all(v["count"] == mini["frames"] for v in res["stages"].values())
    assert (res["decode_ms"] is not None) == loader
    # keyframe timestamps are the fixture's nanosecond stamps
    t = np.loadtxt(out_traj)[:, 0]
    assert np.allclose(t[0], mini_euroc.T0_NS * 1e-9)
    if os.access(EVALUATE_ATE, os.X_OK):
        native = json.loads(subprocess.run([EVALUATE_ATE, out_traj, mini["gt_tum"]],
                                           capture_output=True, text=True,
                                           check=True).stdout)
        assert native["n_pairs"] == tail["n_keyframes"]
        assert native["ate_rmse"] < 0.15 and abs(native["ate_rmse"] - res["ate_rmse_m"]) < 1e-3


def test_cli_missing_frame_raises(mini, tmp_path):
    """A frame that fails to decode raises through main, with the loader."""
    import shutil

    bad = str(tmp_path / "bad")
    shutil.copytree(mini["dir"], bad)
    d = os.path.join(bad, "mav0", "cam1", "data")
    victim = sorted(os.listdir(d))[0]
    with open(os.path.join(d, victim), "wb") as f:
        f.write(b"not a png")
    with pytest.raises(ValueError, match="cannot decode"):
        run_euroc.main([bad, "--params", mini["params"], "--out", str(tmp_path / "t.txt"),
                        "--config", FAST, "--device", "cpu", "--native-loader"])



def typed_config(src: str, dst: str) -> None:
    """Copy a run config with its float strings as floats: PyYAML reads
    ``1e-7`` (no dot) as a string, which the JAX package's ``from_yaml``
    keeps and its tracker cannot compare (the port's coerces them)."""
    import yaml

    def typed(v):
        try:
            return float(v) if isinstance(v, str) else v
        except ValueError:
            return v

    with open(src) as f:
        data = yaml.safe_load(f.read().replace("\t", " "))
    with open(dst, "w") as f:
        yaml.safe_dump({k: typed(v) for k, v in data.items()}, f)


def jax_cli_frame_logs(argv):
    """Run the JAX package's CLI (``scripts/run_euroc.py``) in this process
    on ``argv`` and return its pipeline's per-frame logs, read at finish."""
    from plslam_tpu import pipeline

    spec = importlib.util.spec_from_file_location(
        "jax_run_euroc", os.path.join(ROOT, "scripts", "run_euroc.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    logs = []
    finish = pipeline.PLSLAM.finish

    def keep_logs(self, *args, **kwargs):
        logs.extend(self.logs)
        return finish(self, *args, **kwargs)

    with mock.patch.object(pipeline.PLSLAM, "finish", keep_logs), \
            mock.patch.object(sys, "argv", ["run_euroc.py", *argv]):
        cli.main()
    return logs


if __name__ == "__main__":
    fixture, config = sys.argv[1:3]
    with tempfile.TemporaryDirectory() as tmp:
        cfg = os.path.join(tmp, "config.yaml")
        typed_config(config, cfg)
        logs = jax_cli_frame_logs(
            [fixture, "--params", os.path.join(fixture, "params.yaml"), "--config", cfg,
             "--gt", os.path.join(fixture, "groundtruth.csv"), "--native-loader",
             "--out", os.path.join(tmp, "trajectory.txt")])
    for lg in logs:
        print(f"frame {lg.frame}: good={lg.good} err={float(lg.err):.4f} "
              f"inliers={int(lg.n_inliers)} kf={lg.is_kf}")
    print(f"lost frames {[lg.frame for lg in logs if not lg.good]}; "
          f"{sum(lg.is_kf for lg in logs)} keyframe frames after the first")
