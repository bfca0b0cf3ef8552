"""Batched-VO B-sweep: per-stream and aggregate frames/s at B in {1, 2, 4,
8, 16} on the card (the port of ``scripts/bench_batch_vo.py``).

B independent stereo streams tracked in lockstep by
``BatchedVisualOdometry`` (detection as one flat (2B, H, W) stack, the
step one CUDA graph per B): stream s renders ``SyntheticScene(600, 60,
seed=s)`` at 752x480.  Per B a fresh tracker, 3 warm-up frames, then 12
timed frames; the per-frame stack of the B streams stays inside the timed
loop, as ``jnp.stack`` does in the JAX script.

    python -m plslam_tpu_torch.bench_batch_vo [--device cuda|cpu]

Prints the JAX script's JSON line per B (``batch_vo_frames_per_s_B{B}``,
with its keys); everything else goes to standard error on ``#`` lines.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import multiprocessing
import os
import sys
import time

import numpy as np
import torch

from .batch_vo import BatchedVisualOdometry
from .bench import SCENE, WIDTHS, Say, camera, card, kernel_launches, resolve_device
from .frontend.frame import FrontendConfig
from .frontend.tracker import TrackerConfig
from .io.synthetic import SyntheticScene, circular_trajectory

N_WARMUP = 3
N_FRAMES = 12
B_SWEEP = (1, 2, 4, 8, 16)


def bench_one(B: int, frames_by_stream, cam, fcfg: FrontendConfig, n_warmup: int = N_WARMUP,
              n_frames: int = N_FRAMES, device="cuda") -> dict:
    """The JAX script's ``bench_one``: returns {"agg", "per": frames/s,
    "good": (n_frames, B) good flags of the timed frames, "results": the
    timed ``FrameResult``s, "launches": kernel launches per timed frame}."""
    bvo = BatchedVisualOdometry(B, cam, fcfg, TrackerConfig(), device=device)
    il0 = torch.stack([frames_by_stream[b][0][0] for b in range(B)])
    ir0 = torch.stack([frames_by_stream[b][0][1] for b in range(B)])
    bvo.initialize(il0, ir0)
    for i in range(1, n_warmup + 1):
        res = bvo.process(
            torch.stack([frames_by_stream[b][i][0] for b in range(B)]),
            torch.stack([frames_by_stream[b][i][1] for b in range(B)]))
    _ = res.err.cpu()
    before = kernel_launches()
    t0 = time.perf_counter()
    results = []
    for i in range(n_warmup + 1, n_warmup + 1 + n_frames):
        res = bvo.process(
            torch.stack([frames_by_stream[b][i][0] for b in range(B)]),
            torch.stack([frames_by_stream[b][i][1] for b in range(B)]))
        results.append(res)
    err = res.err.cpu().numpy()  # sync the sequential chain
    dt = time.perf_counter() - t0
    launches = {k: (n - before[k]) / n_frames for k, n in kernel_launches().items()}
    if not np.isfinite(err).all():
        raise RuntimeError(f"B={B}: the last frame's error is not finite: {err}")
    agg = B * n_frames / dt
    return {"agg": agg, "per": agg / B, "results": results, "launches": launches,
            "good": torch.stack([r.good for r in results]).cpu().numpy()}


def _render_stream(scene: dict, n_poses: int) -> list:
    s = SyntheticScene(**scene)
    return [s.render_stereo(T, noise=1.0) for T in circular_trajectory(n_poses, step_t=0.05)]


def render_streams(n_streams: int, n_poses: int, device, scene: dict = SCENE,
                   workers: int = 0) -> list:
    """Stream s: ``scene`` with seed s, rendered in pose order (in
    ``workers`` spawned processes, one stream each, when above 0), its
    pairs staged on ``device``."""
    kws = [dict(scene, seed=s) for s in range(n_streams)]
    if workers > 0:
        with concurrent.futures.ProcessPoolExecutor(
                workers, mp_context=multiprocessing.get_context("spawn")) as pool:
            streams = list(pool.map(_render_stream, kws, [n_poses] * n_streams))
    else:
        streams = [_render_stream(kw, n_poses) for kw in kws]
    return [[tuple(torch.from_numpy(x).to(device) for x in pair) for pair in st]
            for st in streams]


def run(frames_by_stream=None, *, scene: dict = SCENE, widths: dict = WIDTHS,
        b_sweep=B_SWEEP, n_warmup: int = N_WARMUP, n_frames: int = N_FRAMES, device="cuda",
        say=None) -> dict:
    """The JAX script's sweep on ``frames_by_stream`` (stream s: a list of
    (left, right) pairs; rendered from ``scene`` with seed s when None).
    Returns {"lines": one JSON object per B, "runs": ``bench_one``'s dict per
    B}."""
    say = say or Say()
    dev = torch.device(device)
    if frames_by_stream is None:
        frames_by_stream = render_streams(max(b_sweep), 1 + n_warmup + n_frames, dev, scene)
    frames_by_stream = [[(torch.as_tensor(il, device=dev), torch.as_tensor(ir, device=dev))
                         for il, ir in st] for st in frames_by_stream]
    cam = camera(SyntheticScene(**scene))
    lines, runs, single = [], {}, None
    for B in b_sweep:
        r = runs[B] = bench_one(B, frames_by_stream, cam, FrontendConfig(**widths), n_warmup,
                                n_frames, dev)
        if single is None:
            single = r["per"]
        lines.append({"metric": f"batch_vo_frames_per_s_B{B}", "value": round(r["agg"], 2),
                      "unit": "frames/s (aggregate)", "per_stream": round(r["per"], 2),
                      "per_stream_vs_single": round(r["per"] / single, 3)})
        say(f"B={B}: {int(r['good'].sum())}/{r['good'].size} timed stream-frames good; kernel "
            f"launches per timed frame {r['launches']}")
    return {"lines": lines, "runs": runs}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default: card 0) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    say = Say()
    say(f"device={dev} card={card(dev)} torch {torch.__version__}")
    streams = render_streams(max(B_SWEEP), 1 + N_WARMUP + N_FRAMES, dev,
                             workers=min(max(B_SWEEP), os.cpu_count() or 1))
    say(f"staged {len(streams)} streams of {len(streams[0])} synthetic stereo pairs on {dev}")
    for line in run(streams, device=dev, say=say)["lines"]:
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
