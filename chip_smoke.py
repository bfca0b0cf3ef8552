#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``plslam_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each reported on its own lines:
  1. device: fails without CUDA; prints nvidia-smi's name and power limit;
  2. build: compiles the CUDA kernels from ``plslam_tpu_torch/csrc``;
  3. kernels: each kernel at the VO path's shapes against its plain
     PyTorch version on the card (bit-exact), with CUDA-event timings;
  4. main path: ``VisualOdometry`` at the bench configuration (752x480,
     1200 points, 256 line slots) on the synthetic scene; every frame must
     track, ATE must stay under the floor, every kernel must have launched;
  5. the kernel summary as one JSON line, then the result as the last line.
Any failure raises and exits non-zero.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

# ATE (m, no alignment, all 24 poses) of the JAX package's VisualOdometry
# on the same 24 frames, run on CPU; the port must stay within 2x of it.
JAX_CPU_ATE = 0.03175965853455335
ATE_FLOOR = max(2.0 * JAX_CPU_ATE, 0.01)

N_WARMUP = 3
N_FRAMES = 20
TIMING_REPS = 25
TIMING_WARMUP = 3


def say(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, reps: int = TIMING_REPS) -> float:
    """Median CUDA-event time of fn() over reps calls, after warm-up."""
    for _ in range(TIMING_WARMUP):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def check_equal(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {tuple(got.shape)} {got.dtype} vs "
                             f"{tuple(want.shape)} {want.dtype}")
    err = (got.double() - want.double()).abs().max().item() if got.numel() else 0.0
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel != plain, max |diff| {err}")
    return err


def phase_kernels(dev, levels, scene_imgs, card):
    """Each kernel vs its plain version at the main path's shapes."""
    from plslam_tpu_torch.ops import cuda_fast, cuda_hamming, cuda_patches

    gen = torch.Generator().manual_seed(0)
    H, W = scene_imgs.shape[1:]
    report = []

    # patch gather: ORB (2, 1200) on the image pair, LBD (4, 1536) on gx/gy
    errs, ms, plain_ms = [], 0.0, 0.0
    for name, B, N in (("orb", 2, 1200), ("lbd", 4, 1536)):
        imgs = torch.rand((B, H, W), generator=gen).mul_(255).to(dev)
        y0 = torch.randint(-23 - 8, H - 25 + 8, (B, N), generator=gen,
                           dtype=torch.int32).to(dev)
        x0 = torch.randint(-23 - 8, W - 25 + 8, (B, N), generator=gen,
                           dtype=torch.int32).to(dev)
        got = cuda_patches.gather_patches_batch(imgs, y0, x0, 48)
        want = cuda_patches.gather_patches_plain(imgs, y0, x0, 48)
        errs.append(check_equal(f"patches {name}", got, want))
        t = median_ms(lambda: cuda_patches.gather_patches_batch(imgs, y0, x0, 48))
        tp = median_ms(lambda: cuda_patches.gather_patches_plain(imgs, y0, x0, 48))
        ms, plain_ms = ms + t, plain_ms + tp
        say(f"kernel patches {name} ({B},{N},48,48): exact; {t:.4f} ms vs plain {tp:.4f} ms on {card}")
    report.append(dict(name="gather_patches_batch", route="cuda",
                       source="plslam_tpu_torch/csrc/patches.cu",
                       replaces="plslam_tpu/ops/pallas_patches.py:100",
                       max_abs_err=max(errs), ms=ms, plain_ms=plain_ms))

    # FAST score + NMS on the four pyramid levels of the scene pair and of
    # uniform noise (dense corners); raw exact off the 3-px frame, nms off
    # the 4-px frame (the kernel zero-pads where the plain form wraps)
    errs, ms, plain_ms = [], 0.0, 0.0
    thr = torch.full((2,), 20.0, device=dev)
    for li, lvl in enumerate(levels):
        noise = torch.rand(lvl.shape, generator=gen).mul_(255).to(dev)
        for kind, imgs in (("scene", lvl.contiguous()), ("noise", noise)):
            raw, nms = cuda_fast.fast_score_nms_batch(imgs, thr)
            raw_p, nms_p = cuda_fast.fast_score_nms_plain(imgs, thr)
            errs.append(check_equal(f"fast raw L{li} {kind}", raw[:, 3:-3, 3:-3],
                                    raw_p[:, 3:-3, 3:-3]))
            errs.append(check_equal(f"fast nms L{li} {kind}", nms[:, 4:-4, 4:-4],
                                    nms_p[:, 4:-4, 4:-4]))
        imgs = lvl.contiguous()
        t = median_ms(lambda: cuda_fast.fast_score_nms_batch(imgs, thr))
        tp = median_ms(lambda: cuda_fast.fast_score_nms_plain(imgs, thr))
        ms, plain_ms = ms + t, plain_ms + tp
        say(f"kernel fast L{li} {tuple(lvl.shape)}: exact; {t:.4f} ms vs plain {tp:.4f} ms on {card}")
    report.append(dict(name="fast_score_nms_batch", route="cuda",
                       source="plslam_tpu_torch/csrc/fast.cu",
                       replaces="plslam_tpu/ops/pallas_fast.py:82",
                       max_abs_err=max(errs), ms=ms, plain_ms=plain_ms))

    # Hamming: stereo + f2f, points 1200x1200 and lines 256x256 (2 each/frame)
    errs, ms, plain_ms = [], 0.0, 0.0
    for n in (1200, 256):
        d1 = torch.randint(-2**31, 2**31, (n, 8), generator=gen, dtype=torch.int64)
        d2 = torch.randint(-2**31, 2**31, (n, 8), generator=gen, dtype=torch.int64)
        d1, d2 = d1.to(torch.int32).to(dev), d2.to(torch.int32).to(dev)
        got = cuda_hamming.hamming_distance_matrix_cuda(d1, d2)
        want = cuda_hamming.hamming_plain(d1, d2)
        errs.append(check_equal(f"hamming {n}", got, want))
        t = median_ms(lambda: cuda_hamming.hamming_distance_matrix_cuda(d1, d2))
        tp = median_ms(lambda: cuda_hamming.hamming_plain(d1, d2))
        ms, plain_ms = ms + 2 * t, plain_ms + 2 * tp
        say(f"kernel hamming {n}x{n}: exact; {t:.4f} ms vs plain {tp:.4f} ms on {card}")
    report.append(dict(name="hamming_distance_matrix_cuda", route="cuda",
                       source="plslam_tpu_torch/csrc/hamming.cu",
                       replaces="plslam_tpu/ops/pallas_hamming.py:45",
                       max_abs_err=max(errs), ms=ms, plain_ms=plain_ms))
    return report


def phase_main_path(dev, scene, poses, frames):
    """VisualOdometry through the kernels at the bench configuration."""
    from plslam_tpu_torch.core.camera import StereoCamera
    from plslam_tpu_torch.frontend.frame import FrontendConfig
    from plslam_tpu_torch.frontend.tracker import TrackerConfig
    from plslam_tpu_torch.io import ate_rmse
    from plslam_tpu_torch.ops import cuda_fast, cuda_hamming, cuda_patches
    from plslam_tpu_torch.vo import VisualOdometry

    wrappers = {"gather_patches_batch": cuda_patches.gather_patches_batch,
                "fast_score_nms_batch": cuda_fast.fast_score_nms_batch,
                "hamming_distance_matrix_cuda": cuda_hamming.hamming_distance_matrix_cuda}
    cam = StereoCamera.create(scene.fx, scene.fy, scene.cx, scene.cy, scene.b,
                              width=scene.width, height=scene.height)
    vo = VisualOdometry(cam, FrontendConfig(n_points=1200, n_lines=256),
                        TrackerConfig(), device=dev)

    for fn in wrappers.values():
        fn.launches = 0
    vo.initialize(*frames[0])
    results = [vo.process(*frames[i]) for i in range(1, N_WARMUP + 1)]
    torch.cuda.synchronize()
    before = {k: fn.launches for k, fn in wrappers.items()}
    t0 = time.perf_counter()
    for i in range(N_WARMUP + 1, N_WARMUP + 1 + N_FRAMES):
        results.append(vo.process(*frames[i]))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}

    # the step keeps its state on the card: one more step (repeating the
    # last frame) under sync-debug "error" raises on any host sync
    torch.cuda.set_sync_debug_mode("error")
    vo.process(*frames[-1])
    torch.cuda.set_sync_debug_mode(0)
    say("main path: a step made no host sync (sync debug mode 'error')")

    est = np.stack([np.eye(4)] + [r.T_f_w.cpu().numpy() for r in results])
    if est.shape != (len(poses), 4, 4) or not np.isfinite(est).all():
        raise AssertionError(f"bad poses: shape {est.shape}, finite "
                             f"{np.isfinite(est).all()}")
    good = [bool(r.good) for r in results]
    gt = np.stack([p[:3, 3] for p in poses])
    ate = ate_rmse(est[:, :3, 3], gt, align=False)
    fps = N_FRAMES / dt
    timed_good = sum(good[N_WARMUP:])
    say(f"main path: {timed_good}/{N_FRAMES} timed frames good, "
        f"{sum(good)}/{len(good)} overall; ATE {ate:.6f} m (floor {ATE_FLOOR:.6f}, "
        f"JAX CPU {JAX_CPU_ATE:.6f}); {fps:.3f} frames/s over {N_FRAMES} frames")
    per_frame = {k: (launches[k] - before[k]) / N_FRAMES for k in wrappers}
    say(f"main path launches (init + {len(results)} frames): {launches}; "
        f"per timed frame: {per_frame}")
    if not all(good):
        raise AssertionError(f"frames lost tracking: {good}")
    if not ate <= ATE_FLOOR:
        raise AssertionError(f"ATE {ate} above floor {ATE_FLOOR}")
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} never launched on the main path")
    return launches, fps, ate


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    say(smi)
    say(f"device: {kind}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    from plslam_tpu_torch.io import SyntheticScene, circular_trajectory
    from plslam_tpu_torch.ops import cuda_lib
    from plslam_tpu_torch.ops.image import build_pyramid

    build = cuda_lib.load()
    say(f"build: {build.seconds:.2f} s -> {build.path.name}")
    for line in build.log.splitlines():
        if "Used" in line or "spill" in line:
            say(f"  ptxas: {line.strip()}")

    # bench.py's configuration, frames staged on the device
    scene = SyntheticScene(n_points=600, n_lines=60, seed=0, width=752, height=480,
                           fx=435.2, fy=435.2, cx=367.4, cy=252.2)
    poses = circular_trajectory(1 + N_WARMUP + N_FRAMES, step_t=0.05)
    frames = [tuple(torch.from_numpy(x).to(dev) for x in scene.render_stereo(T, noise=1.0))
              for T in poses]
    pair = torch.stack(frames[0])
    levels = build_pyramid(pair, 4, 1.2)

    report = phase_kernels(dev, levels, pair, smi)
    launches, fps, ate = phase_main_path(dev, scene, poses, frames)
    for k in report:
        k["launches"] = launches[k["name"]]
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    say(f"main path: {fps:.3f} frames/s, ATE {ate:.6f} m on {smi}")
    say(json.dumps({"kernels": report}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
