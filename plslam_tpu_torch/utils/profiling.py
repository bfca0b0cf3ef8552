"""Per-stage host timing and device traces (``plslam_tpu.utils.profiling``;
the reference has a chrono Timer and cout, mapHandler.cpp:162-234)."""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict

import torch


class StageTimer:
    """Accumulates wall time per named stage (the Vector7f ``time`` analog,
    mapHandler.cpp:162-234, but structured)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, sync: bool = False):
        """Time the block; with ``sync`` the stage ends only when the card
        has finished the work queued so far (no-op where the process has not
        used the card), so device time lands in the stage that queued it."""
        t0 = time.time()
        try:
            yield
        finally:
            if sync and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            dt = time.time() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> dict:
        return {k: {"total_s": round(v, 4),
                    "mean_ms": round(1000.0 * v / max(self.counts[k], 1), 3),
                    "count": self.counts[k]}
                for k, v in sorted(self.totals.items())}

    def dump_jsonl(self, path: str):
        with open(path, "a") as f:
            f.write(json.dumps(self.summary()) + "\n")


@contextlib.contextmanager
def device_trace(logdir: str):
    """torch.profiler trace of the block, host and (where there is one)
    CUDA activity, written as a Chrome trace to ``logdir/trace.json``
    (open in chrome://tracing or Perfetto).  Yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
