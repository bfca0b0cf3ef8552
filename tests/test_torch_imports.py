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
                "plslam_tpu_torch.core.segment"):
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
