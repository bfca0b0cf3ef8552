"""The port stands alone and runs on the card by default: a fresh
interpreter imports every module of ``plslam_tpu_torch`` and loads
``chip_smoke.py``, and none of ``jax``, ``jaxlib`` or ``plslam_tpu[.*]`` is
loaded afterwards; the entry points default to ``device="cuda"`` and
nothing falls back to the CPU."""

import inspect
import json
import os
import subprocess
import sys

import pytest
import torch

from plslam_tpu_torch.batch_vo import BatchedVisualOdometry
from plslam_tpu_torch.core.camera import StereoCamera
from plslam_tpu_torch.pipeline import PLSLAM
from plslam_tpu_torch.vo import VisualOdometry

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
# the evaluation programs that run on the card: python -m plslam_tpu_torch.<name>
EVAL_MODULES = ("line_match_quality", "compare_line_modes", "e2e_robust", "endpoint_gba_ab",
                "loop_stress", "train_vocabulary")
# the benchmark twins: python -m plslam_tpu_torch.<name>
BENCH_MODULES = ("bench", "bench_slam", "bench_batch_vo", "bench_dist_gba")
# the measurement programs and the demo that run on the card
PROGRAM_MODULES = ("roofline", "profile_detect", "ab_fused_step", "profile_mapping",
                   "demo_synthetic")

PROBE = r"""
import importlib, importlib.util, json, pkgutil, sys
import plslam_tpu_torch
names = [m.name for m in pkgutil.walk_packages(plslam_tpu_torch.__path__, "plslam_tpu_torch.")]
for n in names:
    importlib.import_module(n)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "plslam_tpu"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env, check=True,
                         capture_output=True, text=True, timeout=240).stdout
    res = json.loads(out.strip().splitlines()[-1])
    assert res["bad"] == []
    for mod in ("plslam_tpu_torch.config", "plslam_tpu_torch.pipeline",
                "plslam_tpu_torch.io.synthetic", "plslam_tpu_torch.ops.cuda_patches",
                "plslam_tpu_torch.batch_vo", "plslam_tpu_torch.frontend.rgbd",
                "plslam_tpu_torch.core.segment", "plslam_tpu_torch.io.ring_map",
                "plslam_tpu_torch.io.ring_world",
                *(f"plslam_tpu_torch.{m}" for m in EVAL_MODULES + BENCH_MODULES
                  + PROGRAM_MODULES), "plslam_tpu_torch.profile_map_host",
                "plslam_tpu_torch.evaluate_ate", "plslam_tpu_torch.viz",
                *(f"plslam_tpu_torch.parallel.{m}" for m in
                  ("mesh", "launch", "dist_ba", "dist_gba", "dist_match", "multihost"))):
        assert mod in res["modules"]


@pytest.mark.parametrize("entry", [VisualOdometry, PLSLAM, BatchedVisualOdometry])
def test_entry_points_default_to_the_card(entry):
    assert inspect.signature(entry).parameters["device"].default == "cuda"


def test_no_fallback_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    vo = VisualOdometry(StereoCamera.create(200.0, 200.0, 90.0, 60.0, 0.1,
                                            width=188, height=120))
    assert vo.device.type == "cuda"
    with pytest.raises(ValueError, match="must be on cuda"):
        vo.initialize(torch.zeros(120, 188), torch.zeros(120, 188))


def test_bare_cuda_names_the_current_card(monkeypatch):
    """``.to("cuda")`` puts a tensor on the current card, and the tensor
    reports ``cuda:<index>``; the entry points' default device ``"cuda"``
    accepts it.  It used to refuse it: ``VisualOdometry._stack`` compared
    ``torch.device("cuda")`` with ``cuda:0``, so every program run with its
    default ``--device`` raised on its first frame."""
    from types import SimpleNamespace

    from plslam_tpu_torch.device import on_device

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)

    def at(name):
        return SimpleNamespace(device=torch.device(name))

    cuda = torch.device("cuda")
    assert on_device(at("cuda:1"), cuda)
    assert not on_device(at("cuda:0"), cuda) and not on_device(at("cpu"), cuda)
    assert on_device(at("cuda:0"), torch.device("cuda:0"))
    assert not on_device(at("cuda:1"), torch.device("cuda:0"))
    assert on_device(at("cpu"), torch.device("cpu"))


@pytest.mark.parametrize("name", EVAL_MODULES)
def test_evaluation_programs_default_to_the_card(name, monkeypatch):
    """Each program's --device defaults to cuda (read off its parser, which
    stops the run before any work)."""
    import argparse
    import importlib

    seen = {}

    def grab(self, args=None, namespace=None):
        seen["device"] = self.get_default("device")
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(SystemExit):
        importlib.import_module(f"plslam_tpu_torch.{name}").main([])
    assert seen["device"] == "cuda"


@pytest.mark.parametrize("name", BENCH_MODULES)
def test_benchmark_twins_need_the_card(name):
    """Without CUDA and without ``--device cpu`` each twin exits non-zero
    before any work; its ``run`` defaults to the card."""
    import importlib

    mod = importlib.import_module(f"plslam_tpu_torch.{name}")
    run = mod.bench_slam if name == "bench_slam" else mod.run
    assert inspect.signature(run).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        mod.main([])
    assert e.value.code not in (0, None)


@pytest.mark.parametrize("name", PROGRAM_MODULES)
def test_measurement_programs_need_the_card(name):
    """Each defaults to the card: without CUDA and without ``--device cpu``
    it exits non-zero before any work."""
    import importlib

    mod = importlib.import_module(f"plslam_tpu_torch.{name}")
    assert inspect.signature(mod.run).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        mod.main([])
    assert e.value.code not in (0, None)
