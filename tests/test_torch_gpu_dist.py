"""chip_smoke.py's phase 11 over every card of a machine with more than
one: one NCCL rank per card, started by ``plslam_tpu_torch.parallel.launch``
(NCCL takes one rank per card, so one card runs the phase at world 1, in
chip_smoke.py itself).  The phase's own checks hold on every rank: each
distributed program against its single-device form, the kf-block GBA bit
for bit the chunked GBA on the same partition, the sharded batch within
phase 10's bars of the unsharded one (rank 0), 4 / 2 / 4 kernel launches
per batched frame.

Marked ``gpu``; skips with fewer than two CUDA devices.  On such a machine
(``--noconftest``: tests/conftest.py imports jax):

    python -m pytest -m gpu --noconftest tests/test_torch_gpu_dist.py
"""

import importlib.util
import os
import subprocess

import pytest
import torch

from plslam_tpu_torch.parallel.launch import launch

pytestmark = pytest.mark.gpu

TESTS = os.path.dirname(os.path.abspath(__file__))


def test_phase_11_over_every_card():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip("needs two or more CUDA devices: NCCL takes one rank per card")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(TESTS, "..", "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from plslam_tpu_torch.ops import cuda_lib

    cuda_lib.load()     # built once here, loaded by every rank
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.splitlines()[0]
    outs = launch("torch_dist_ranks:run_chip_smoke_phase_11", n,
                  {"device": "cuda", "smi": smi,
                   "cfg": dict(chip_smoke.DIST, b=-(-chip_smoke.DIST["b"] // n) * n)},
                  timeout=900,
                  pythonpath=(TESTS,))
    lines = "\n".join(outs[0]["lines"])
    print(lines)
    assert f"world {n}," in lines and "against the unsharded batch" in lines
    assert lines.count("bit-identical to the chunked GBA on the same partition True") == 2
    for out in outs:
        assert (out["launches"] > 0).all(), out["launches"]
