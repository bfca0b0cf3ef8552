"""SPMD launcher: one function run by ``world`` rank processes over NCCL
with one card per rank, or over a gloo process group on the CPU when the
caller asks for it (the port's own; the JAX package runs one controller
over a mesh and needs none).

    outs = launch("package.module:function", 4, {"x": array, "path": "..."})
    outs = launch("package.module:function", 8, inputs, device_type="cpu")

Each rank is a fresh interpreter started with ``subprocess`` as ``python -m
plslam_tpu_torch.parallel.launch`` (never ``multiprocessing.spawn``, which
re-imports the caller's ``__main__``: under pytest, pytest itself), with
``RANK``/``WORLD_SIZE`` (and ``LOCAL_RANK``, its card) in its environment
and one torch thread.  The
group's store is a ``FileStore`` in a fresh temporary directory, so no TCP
port is taken and concurrent launches cannot collide.  Inputs go to every
rank as one ``.npz`` (numpy arrays) and one JSON file (everything else);
``function(inputs)`` runs with the group initialized and returns a dict of
numpy arrays (or tensors), which come back as one dict per rank, in rank
order.  Maps travel as checkpoint paths (``io/checkpoint.py``).  A rank
that fails, or a launch that outlives ``timeout`` seconds, kills the other
ranks and raises with the failing ranks' standard error.
"""

from __future__ import annotations

import datetime
import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _write_inputs(workdir: str, inputs: dict) -> None:
    arrays = {k: np.asarray(v) for k, v in inputs.items() if isinstance(v, np.ndarray)}
    other = {k: v for k, v in inputs.items() if k not in arrays}
    np.savez(os.path.join(workdir, "in.npz"), **arrays)
    with open(os.path.join(workdir, "in.json"), "w") as f:
        json.dump(other, f)


def _read_inputs(workdir: str) -> dict:
    with np.load(os.path.join(workdir, "in.npz"), allow_pickle=False) as z:
        inputs = {k: z[k] for k in z.files}
    with open(os.path.join(workdir, "in.json")) as f:
        inputs.update(json.load(f))
    return inputs


def _failure(target, world, why, ranks, logs) -> RuntimeError:
    """The error of a failed launch, with the end of each named rank's log."""
    tails = []
    for r in ranks:
        with open(logs[r].name, errors="replace") as f:
            tails.append(f"--- rank {r} ---\n{f.read()[-4000:]}")
    return RuntimeError(f"launch {target} x{world}: {why}:\n" + "\n".join(tails))


def launch(target: str, world: int, inputs: dict | None = None, *, timeout: float = 120.0,
           pythonpath: tuple[str, ...] = (), device_type: str = "cuda") -> list[dict]:
    """Run ``target`` ("module:function") in ``world`` ranks, NCCL on cards
    0..world-1 for ``device_type="cuda"``, gloo for ``"cpu"``; returns each
    rank's outputs.  ``pythonpath`` adds import roots for ``target``
    (the repository root is always first)."""
    workdir = tempfile.mkdtemp(prefix="plslam_spmd_")
    procs, logs = [], []
    try:
        _write_inputs(workdir, inputs or {})
        env = dict(os.environ, WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                   OMP_NUM_THREADS="1", PLSLAM_SPMD_TIMEOUT=str(timeout),
                   PLSLAM_SPMD_DEVICE=device_type,
                   PYTHONPATH=os.pathsep.join(
                       (ROOT, *pythonpath, *filter(None, [os.environ.get("PYTHONPATH")]))))
        for r in range(world):
            log = open(os.path.join(workdir, f"rank{r}.log"), "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "plslam_tpu_torch.parallel.launch", target, workdir],
                cwd=ROOT, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdin=subprocess.DEVNULL,
                stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                raise _failure(target, world, f"rank(s) {failed} failed", failed, logs)
            if None not in codes:
                break
            if time.monotonic() > deadline:
                raise _failure(target, world, f"timed out after {timeout:.0f} s", range(world),
                               logs)
            time.sleep(0.02)
        outs = []
        for r in range(world):
            with np.load(os.path.join(workdir, f"out{r}.npz"), allow_pickle=False) as z:
                outs.append({k: z[k] for k in z.files})
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
        shutil.rmtree(workdir, ignore_errors=True)


def _rank_main(target: str, workdir: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    timeout = datetime.timedelta(seconds=float(os.environ["PLSLAM_SPMD_TIMEOUT"]))
    cuda = os.environ["PLSLAM_SPMD_DEVICE"] == "cuda"
    if cuda:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group("nccl" if cuda else "gloo",
                            store=dist.FileStore(os.path.join(workdir, "store"), world),
                            rank=rank, world_size=world, timeout=timeout)
    try:
        module, name = target.split(":")
        out = getattr(importlib.import_module(module), name)(_read_inputs(workdir))
        out = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
               for k, v in (out or {}).items()}
        tmp = os.path.join(workdir, f"out{rank}.tmp.npz")
        np.savez(tmp, **out)
        os.replace(tmp, os.path.join(workdir, f"out{rank}.npz"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(*sys.argv[1:3])
