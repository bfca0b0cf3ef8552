"""Interleaved A/B of two graphed ``VisualOdometry`` variants on one GPU
(the twin of ``scripts/ab_fused_step.py``): they alternate timing windows
in ONE process, so drift of the card hits both alike.  Wired, as the JAX
script, to ``TrackerConfig.early_exit``: A the frozen-carry form of the
JAX while loop, B the fixed-length scan form (the same 5 + 10 trips in
both: the port's GN is a fixed-trip loop either way).

    python -m plslam_tpu_torch.ab_fused_step [n_rounds] [--device cuda|cpu] [--scale S]

Each round runs A then B: ``initialize`` on frame 0, 3 warm-up frames,
then 20 timed frames ended by one scalar fetch, from the bench scene's
frames staged on the device.  Beside each window's frames/s it prints the
card's SM clock and power draw at the window's end (``nvidia-smi
--query-gpu=clocks.sm,power.draw``), then the medians and bests.
``--device cpu`` runs the plain kernels on the host clock (no clocks);
``--scale`` scales the image and the feature widths (the CPU tests run
0.25).
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import numpy as np
import torch

from .bench import camera, card, render, resolve_device, scaled
from .frontend.frame import FrontendConfig
from .frontend.tracker import TrackerConfig
from .io.synthetic import SyntheticScene
from .vo import VisualOdometry

N_FRAMES = 20
N_WARMUP = 3
ROUNDS = 4


def clocks(dev: torch.device) -> str:
    """nvidia-smi's SM clock and power draw of the card now, or ``-`` off
    the card."""
    if dev.type != "cuda":
        return "-"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader",
         "-i", str(dev.index)], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def window(vo: VisualOdometry, frames: list, n_frames: int = N_FRAMES) -> tuple[float, list]:
    """The JAX script's ``run``: (timed frames/s, the timed results)."""
    vo.initialize(*frames[0])
    for i in range(1, N_WARMUP + 1):
        res = vo.process(*frames[i])
    _ = float(res.err)
    t0 = time.perf_counter()
    out = [vo.process(*frames[i]) for i in range(N_WARMUP, N_WARMUP + n_frames)]
    _ = float(out[-1].err)
    return n_frames / (time.perf_counter() - t0), out


def run(rounds: int = ROUNDS, *, frames=None, device="cuda", scale: float = 1.0,
        n_frames: int = N_FRAMES, say=None) -> dict:
    """The interleaved rounds on ``frames`` (rendered from the bench scene
    when None; ``N_WARMUP + n_frames + 1`` pairs): {"card", "windows":
    [{"round", "variant", "frames_per_s", "clocks", "err"}], "results":
    {variant: last window's FrameResults}, "median", "best"}."""
    dev = torch.device(device)
    say = say or (lambda msg: None)
    scene_kw, widths = scaled(scale)
    cam = camera(SyntheticScene(**scene_kw))
    fcfg = FrontendConfig(**widths)
    variants = {"A(early)": VisualOdometry(cam, fcfg, TrackerConfig(early_exit=True), device=dev),
                "B(scan)": VisualOdometry(cam, fcfg, TrackerConfig(early_exit=False), device=dev)}
    if frames is None:
        frames = render(scene_kw, N_WARMUP + n_frames + 1, dev)
    for vo in variants.values():
        vo.prewarm(frames[0][0].shape, frames[0][0].dtype)
    windows, results = [], {}
    for r in range(rounds):
        line = []
        for name, vo in variants.items():
            fps, out = window(vo, frames, n_frames)
            w = {"round": r, "variant": name, "frames_per_s": fps, "clocks": clocks(dev),
                 "err": float(out[-1].err)}
            windows.append(w)
            results[name] = out
            line.append(f"{name} {fps:7.1f} [{w['clocks']}]")
        say(f"round {r}: " + "  ".join(line) + "   " + " ".join(
            f"err{w['variant'][0]}={w['err']:.5f}" for w in windows[-2:]))
    fps = {name: [w["frames_per_s"] for w in windows if w["variant"] == name]
           for name in variants}
    return {"card": card(dev), "windows": windows, "results": results,
            "median": {k: float(np.median(v)) for k, v in fps.items()},
            "best": {k: max(v) for k, v in fps.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("rounds", nargs="?", type=int, default=ROUNDS)
    ap.add_argument("--device", default="cuda", help="cuda (default: card 0) or cpu")
    ap.add_argument("--scale", type=float, default=1.0, help="image and feature widths")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device={dev} card={card(dev)}; window: frames/s [SM clock, power draw at its end]",
          flush=True)
    out = run(args.rounds, device=dev, scale=args.scale, say=lambda m: print(m, flush=True))
    med, best = out["median"], out["best"]
    print(f"median A {med['A(early)']:.1f}  B {med['B(scan)']:.1f}  best A "
          f"{best['A(early)']:.1f}  B {best['B(scan)']:.1f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
