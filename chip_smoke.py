#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``plslam_tpu_torch``) on one GPU.

    python3 chip_smoke.py                     # every phase
    python3 chip_smoke.py --kernels           # phases 1-3 only

Phases, each reported on its own lines:
  1. device: fails without CUDA; prints nvidia-smi's name and power limit;
  2. build: compiles the CUDA kernels from ``plslam_tpu_torch/csrc``, while
     a background process writes phase 9's fixture; the script waits for
     that process before phase 3, so no timed phase shares the host with it;
  3. kernels: each kernel at the VO path's shapes (and the Hamming kernel
     at the mapper's and loop closer's) against its plain PyTorch version
     on the card (bit-exact); per shape its device time (a CUDA graph of
     100 back-to-back launches between CUDA events), its host time (one
     wrapper call between CUDA events), the plain version's time, the
     library yardstick's device time (one PyTorch call for the same
     function, never called by the port), the bound (bytes or operations
     over the H100's published peaks) and the share bound / device time;
  4. VO path: ``VisualOdometry`` at the bench configuration (752x480,
     1200 points, 256 line slots) on the synthetic scene; every frame must
     track, ATE must stay under the floor, every kernel must have launched;
  5. SLAM path: ``PLSLAM`` at bench_slam.py's configuration (tracking, the
     mapping worker thread, deferred local BA, chunked GBA at finish);
     every frame good, >= 8 keyframes, a local BA written back, finite GBA
     poses, keyframe ATE under the floor, the Hamming kernel launched from
     the mapping thread;
  6. local BA: LM iterations/s of ``lm_rounds`` (f32, K=8, P=512, L=64);
  7. endpoint SLAM from images: phase 5's configuration with endpoint
     lines, loop closure (the shipped DBoW2 vocabularies) and the keyframe
     pose refinement; every frame good, >= 8 keyframes, a local BA written
     back, every keyframe BoW-encoded, no loop (20 frames lie under
     ``lc_kf_dist``), keyframe ATE under the floor, the Hamming kernel
     launched from the mapping thread;
  8. loop closure at reference scale: the 156-keyframe ring replay of
     tests/test_scale_e2e.py through ``insert_keyframe_features`` (drifted
     odometry, ``lc_kf_dist=50``, online vocabulary): a closure against
     the KF-0 region, no false loop, ATE and closure-keyframe error below
     the odometry's, real fusion, a multi-chunk endpoint GBA at finish, the
     Hamming kernel launched from the loop-closure thread;
  9. disk path: a 40-frame 752x480 EuRoC-layout fixture (``io/mini_euroc``,
     phase 4's scene, written during phase 2) through ``run_euroc.main``
     with configs/config_euroc.yaml, the prefetching loader (decode on
     host threads; the fixture's params are already rectified, so no
     remap) and ``--gt``; every frame good but those the JAX package's CLI
     also loses on the CPU (frame 34), >= 3 keyframes, a local BA
     written back, one TUM row per keyframe, ATE under the floor, every
     kernel launched; overlays when the card's machine has matplotlib,
     else the frame diagnostics on the card against the CPU; the device
     remap of configs/euroc_params.yaml's maps against the plain CPU remap;
     loader decode ms, the stage split and the CLI's frames/s;
 10. batched VO and RGB-D: ``BatchedVisualOdometry`` at
     scripts/bench_batch_vo.py's configuration (16 streams rendered in
     worker processes during phase 2) for B in 1, 2, 4, 8, 16: aggregate
     and per-stream frames/s, every frame of every stream good, 4 FAST / 2
     patch / 4 Hamming launches per frame at every B, no host sync, no
     vmap fallback; at B = 4 each stream's ATE under max(2x the JAX
     package's CPU value, 0.01 m); at B = 2 each stream against
     single-stream ``VisualOdometry``; then tests/test_rgbd.py's two-frame
     RGB-D track (error under 0.02 m, the FAST and patch kernels launched).
Phase 4 also runs the VO twice over its frames and phase 6 ``lm_rounds``
six times on one problem: both must repeat bit for bit.  Phase 3 also
times the batched Hamming launch at (B, 1200, 8)^2 and (B, 256, 8)^2.
Then come the summary lines, the kernel summary as one JSON line, and the
result as the last line.  Any failure raises and exits non-zero, and so
does an import of JAX or of the JAX package (``plslam_tpu``).
"""

import argparse
import functools
import importlib.util
import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# ATE (m, no alignment, all 24 poses) of the JAX package's VisualOdometry
# on the same 24 frames, run on CPU; the port must stay within 2x of it.
JAX_CPU_ATE = 0.03175965853455335
ATE_FLOOR = max(2.0 * JAX_CPU_ATE, 0.01)

N_WARMUP = 3
N_FRAMES = 20

# Keyframe ATE (m, Umeyama-aligned, keyframes matched to ground truth by
# timestamp) of the JAX package's PLSLAM on the SLAM phase's 20 frames,
# run on CPU (scripts/jax_slam_reference.py slam); the port must stay
# within 2x of it.
JAX_CPU_SLAM_ATE = 0.013965862188961113
SLAM_ATE_FLOOR = max(2.0 * JAX_CPU_SLAM_ATE, 0.01)
SLAM_WARMUP = 4
SLAM_FRAMES = 16
LBA_REPS = 5
LM_ITERS = 10
LM_REPS = 5
MAPPER_THREAD = "plslam-mapper"
LOOP_THREAD = "plslam-loopcloser"
CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")

# Keyframe ATE (m, aligned as in phase 5) of the JAX package's PLSLAM at
# phase 7's configuration (endpoint lines, loop closure, refinement) on the
# same 20 frames, run on CPU (scripts/jax_slam_reference.py endpoint).
JAX_CPU_EP_ATE = 0.032678879923612035
EP_ATE_FLOOR = max(2.0 * JAX_CPU_EP_ATE, 0.01)

# Phase 8: tests/test_scale_e2e.py's scenario
RING_KF = 156          # one revolution + a 16-keyframe revisit overlap
RING_REVISIT = 134     # keyframes from here overlap the KF-0 sector
TIMING_REPS = 25
TIMING_WARMUP = 3

# Phase 9: the disk path.  Keyframe ATE (m, the CLI's JSON tail) of the JAX
# package's CLI (scripts/run_euroc.py --native-loader) on the same 40-frame
# fixture on CPU, and the frames it loses, recorded frame by frame by
#   python -m plslam_tpu_torch.io.mini_euroc DIR --frames 40 --euroc-size
#   PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_disk_e2e.py DIR configs/config_euroc.yaml
# That run tracks every frame but frame 34 (its pose solve fails, err -1):
# the port may lose no other frame.
JAX_CPU_DISK_ATE = 0.0347
JAX_CPU_DISK_LOST = (34,)
DISK_ATE_FLOOR = max(2.0 * JAX_CPU_DISK_ATE, 0.01)
DISK_FRAMES = 40
DISK_OVERLAY_EVERY = 10
ROOT = os.path.dirname(os.path.abspath(__file__))

# Phase 10: scripts/bench_batch_vo.py's configuration.  Stream s renders
# SyntheticScene(600, 60, seed=s) at 752x480 along circular_trajectory(16,
# step_t=0.05) with noise 1.0; 3 warm-up frames, then 12 timed.
BATCH_SIZES = (1, 2, 4, 8, 16)
BATCH_WARMUP = 3
BATCH_FRAMES = 12
BATCH_SCENE = dict(n_points=600, n_lines=60, width=752, height=480, fx=435.2, fy=435.2,
                   cx=367.4, cy=252.2)
BATCH_WIDTHS = dict(n_points=1200, n_lines=256)
# Per-stream ATE (m, unaligned, all 16 poses) of the JAX package's
# BatchedVisualOdometry(4) on the same frames, run on CPU
# (scripts/jax_batch_vo_reference.py); at B = BATCH_ATE_B each stream must
# stay under max(2x its value, 0.01 m).
JAX_CPU_BATCH_ATE = (0.022467623002017618, 0.03780642143164076, 0.045951607969494164,
                     0.04782139652707396)
BATCH_ATE_B = 4
BATCH_MATCH_B = 2   # streams held against single-stream VisualOdometry
# launches per batched frame, whatever B is
BATCH_LAUNCHES = {"fast_score_nms_batch": 4, "gather_patches_batch": 2,
                  "hamming_distance_matrix_cuda": 4}
RENDER_WORKERS = 8
# tests/test_rgbd.py's two-frame RGB-D scenario
RGBD_XI = (0.02, -0.01, 0.1, 0.005, -0.008, 0.01)

# Phase 3's timing.  Device time: TIMED_LAUNCHES back-to-back calls,
# captured once in a CUDA graph and replayed between two CUDA events.
TIMED_LAUNCHES = 100
GRAPH_REPLAYS = 5
PLAIN_REPS = 10
# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet):
# device memory, dense int8 tensor cores, float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12
# The float32 peak counts an FMA as two operations at 128 per clock per SM;
# an add issues at that rate, min, max and compare at 64 per clock per SM
# (the CUDA C++ guide's throughput table for compute capability 9.0).
F32_ADD_PER_S = F32_OPS_PER_S / 2
F32_MINMAX_PER_S = F32_OPS_PER_S / 4
# FAST + NMS float32 operations (csrc/fast.cu): every pixel pays the
# compass test (4 differences, 8 compares) and the 3x3 NMS (9 max, 2
# compares); a pixel that passes the compass test pays 12 more ring
# differences, 2 x 57 min/max for the bright and dark window folds, bright
# vs dark, and the threshold (compare + select).
FAST_PX_OPS = (4, 8 + 11)
FAST_CANDIDATE_OPS = (12, 2 * 57 + 1 + 2)
# Hamming matrices of one VO frame: stereo and f2f, points and lines
HAMMING_VO = {(1200, 1200): 2, (256, 256): 2}
HAMMING_SHAPES = ((1200, 1200), (256, 256), (2048, 1200), (160, 160), (24, 24))
# and batched, (B, N, 8)^2 at phase 10's point and line widths
HAMMING_BATCHES = (4, 16)


def say(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, reps: int = TIMING_REPS) -> float:
    """Median CUDA-event time of single calls of fn, after warm-up: the
    event pair brackets the host's work of one call too (``host_ms``)."""
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


def graph_ms(fn, n: int = TIMED_LAUNCHES) -> float:
    """Device time per call of fn: n back-to-back calls captured in one
    CUDA graph, replayed between two CUDA events, over n (median of
    GRAPH_REPLAYS replays after one warm replay).  Each captured call keeps
    its own output, as a caller's fresh allocation: n outputs exceed the
    50 MB L2 at the main path's shapes, so the writes reach device memory."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph, outs = torch.cuda.CUDAGraph(), []
    with torch.cuda.graph(graph):
        for _ in range(n):
            outs.append(fn())
    times = []
    for _ in range(GRAPH_REPLAYS + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    del graph, outs
    torch.cuda.empty_cache()
    return float(np.median(times[1:]))


def stream_ms(fn, reps: int = PLAIN_REPS) -> float:
    """CUDA-event time per call of reps calls of fn issued in a row."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, *ops: tuple[float, float]) -> tuple[float, str]:
    """Least time (ms) the card could take: the larger of the bytes over the
    memory rate and the operations, (count, peak rate for their type) pairs,
    each over its rate."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * sum(n / rate for n, rate in ops)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fast_ops(imgs: torch.Tensor, thr: torch.Tensor) -> tuple[tuple[float, float], ...]:
    """FAST + NMS's float32 operations on these images, as (count, rate)
    pairs: the compass test of csrc/fast.cu's first pass, in plain torch,
    counts the pixels that go on to the window folds (zero outside the
    image, as the kernel pads)."""
    c = torch.nn.functional.pad(imgs, (3, 3, 3, 3))
    H, W = imgs.shape[1:]
    ctr = c[:, 3:3 + H, 3:3 + W]
    e0, e8 = c[:, 0:H, 3:3 + W] - ctr, c[:, 6:6 + H, 3:3 + W] - ctr
    e4, e12 = c[:, 3:3 + H, 6:6 + W] - ctr, c[:, 3:3 + H, 0:W] - ctr
    th = thr[:, None, None]
    bright = ((e0 > th) | (e8 > th)) & ((e4 > th) | (e12 > th))
    dark = ((e0 < -th) | (e8 < -th)) & ((e4 < -th) | (e12 < -th))
    n_px, n_cand = imgs.numel(), int((bright | dark).sum())
    adds = FAST_PX_OPS[0] * n_px + FAST_CANDIDATE_OPS[0] * n_cand
    minmax = FAST_PX_OPS[1] * n_px + FAST_CANDIDATE_OPS[1] * n_cand
    return (adds, F32_ADD_PER_S), (minmax, F32_MINMAX_PER_S)


def check_equal(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {tuple(got.shape)} {got.dtype} vs "
                             f"{tuple(want.shape)} {want.dtype}")
    err = (got.double() - want.double()).abs().max().item() if got.numel() else 0.0
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel != plain, max |diff| {err}")
    return err


def time_shape(shape, kernel, plain, library, nbytes, *ops, launches=TIMED_LAUNCHES) -> dict:
    """One kernel at one shape: device, host, plain and library times and
    the bound, all in ms.  ``library`` maps a name to one PyTorch call that
    computes the same function (never called by the port).  ``launches``
    per CUDA graph: fewer where 100 outputs would not fit the card."""
    t_bound, by = bound(nbytes, *ops)
    row = dict(shape=list(shape), device_ms=graph_ms(kernel, launches),
               host_ms=median_ms(kernel), plain_ms=stream_ms(plain), bound_ms=t_bound,
               bound_by=by, bytes=int(nbytes))
    lib = {k: graph_ms(fn, launches) for k, fn in library.items()}
    row["library"] = lib
    row["library_ms"] = min(lib.values()) if lib else None
    row["share"] = t_bound / row["device_ms"]
    return row


def summarize(name: str, rows: list[dict], per_frame: list[int], errs: list[float],
              **info) -> dict:
    """A kernel's line of the JSON summary: times summed over one VO
    frame's calls (``per_frame`` calls of each row's shape), every shape's
    row beside them."""
    def total(key):
        vals = [(r[key], k) for r, k in zip(rows, per_frame) if k]
        return None if any(v is None for v, _ in vals) else sum(v * k for v, k in vals)

    dev, bnd = total("device_ms"), total("bound_ms")
    largest = max((r for r, k in zip(rows, per_frame) if k), key=lambda r: r["bound_ms"])
    return dict(name=name, route="cuda", **info, max_abs_err=max(errs), ms=dev,
                device_ms=dev, host_ms=total("host_ms"), plain_ms=total("plain_ms"),
                library_ms=total("library_ms"), bound_ms=bnd, bound_by=largest["bound_by"],
                share=bnd / dev, calls_per_vo_frame=sum(per_frame), shapes=rows)


def hamming_library(d1: torch.Tensor, d2: torch.Tensor) -> dict:
    """The Hamming matrix as one PyTorch call, on operands unpacked
    beforehand: fp16 +-1 addmm (128 - dot / 2, exact: integer sums <= 256)
    and cdist with p=0 on {0, 1} floats; for a (B, N, 8) batch the batched
    addmm (baddbmm) alone.  Each is checked once."""
    from plslam_tpu_torch.ops.cuda_hamming import hamming_plain
    from plslam_tpu_torch.ops.descriptors import unpack_bits

    b1, b2 = unpack_bits(d1), unpack_bits(d2)
    s1, s2 = (2 * b1 - 1).half(), (2 * b2 - 1).half().transpose(-1, -2)
    c = torch.full((1,), 128.0, dtype=torch.float16, device=d1.device)
    f1, f2 = b1.float(), b2.float()
    if d1.dim() == 3:
        lib = {"baddbmm_fp16": lambda: torch.baddbmm(c, s1, s2, alpha=-0.5)}
    else:
        lib = {"addmm_fp16": lambda: torch.addmm(c, s1, s2, alpha=-0.5),
               "cdist_p0": lambda: torch.cdist(f1, f2, p=0)}
    want = hamming_plain(d1, d2)
    for k, fn in lib.items():
        if not torch.equal(fn().round().int(), want):
            raise AssertionError(f"hamming library call {k} is not the Hamming matrix")
    return lib


def main_path_corners(levels, pair):
    """The patch gathers' inputs as the VO frame makes them from this pair
    (or the flat (2B, H, W) stack of a batched frame): ORB's (2, 1200)
    corners around the frame's FAST keypoints on the blurred pair, LBD's
    (4, 1536) along its segments on gx and gy of both images."""
    from plslam_tpu_torch.frontend.frame import FrontendConfig
    from plslam_tpu_torch.ops import fast, lbd, lines, orb
    from plslam_tpu_torch.ops.image import blur, sobel
    from plslam_tpu_torch.ops.patches import corners

    cfg = FrontendConfig()
    kp = fast.detect_pyramid_batch(levels, cfg.fast_th, cfg.n_points, cfg.edge_th,
                                   cfg.scale_factor)
    y0, x0 = corners(kp.xy, orb.CENTER)
    seg = lines.detect_segments(pair, lines.LineDetectorConfig(max_out=cfg.n_lines,
                                                               n_orient=cfg.line_orient_bins))
    ly, lx = corners(lbd._patch_centers(seg.sp, seg.ep).reshape(pair.shape[0], -1, 2),
                     lbd.CENTER)
    gx, gy = sobel(blur(pair, 1.4))
    return {"orb": (blur(pair, 2.0).contiguous(), y0, x0),
            "lbd": (torch.cat([gx, gy]).contiguous(), torch.cat([ly, ly]), torch.cat([lx, lx]))}


def phase_kernels(dev, levels, pair, card, flat=None):
    """Each kernel vs its plain version at the main path's shapes, with its
    device time, host time, bound and library yardstick; with ``flat``, the
    (2B, H, W) stack of a batched frame, the patch gather and FAST also at
    its shapes (``batched_shapes``)."""
    from plslam_tpu_torch.ops import cuda_fast, cuda_hamming, cuda_patches
    from plslam_tpu_torch.ops.image import build_pyramid

    gen = torch.Generator().manual_seed(0)
    H, W = pair.shape[1:]
    report = []
    stacks = [(levels, pair)]
    if flat is not None:
        stacks.append((build_pyramid(flat, 4, 1.2), flat))

    # patch gather: exact on the main path's inputs and on the same stacks
    # with corners up to 8 px past every edge; timed on the main path's
    # (and the batched frame's: 10 launches per graph, its outputs are
    # 0.35 and 0.91 GB at B = 16)
    errs, rows, batched, P = [], [], [], 48
    for (lv, stack), name, (imgs, y0, x0) in (
            (st, name, c) for st in stacks for name, c in main_path_corners(*st).items()):
        B, N = y0.shape
        wide_y = torch.randint(-P - 8, H + 8, (B, N), generator=gen, dtype=torch.int32).to(dev)
        wide_x = torch.randint(-P - 8, W + 8, (B, N), generator=gen, dtype=torch.int32).to(dev)
        errs.append(check_equal(f"patches {name} off the edges",
                                cuda_patches.gather_patches_batch(imgs, wide_y, wide_x, P),
                                cuda_patches.gather_patches_plain(imgs, wide_y, wide_x, P)))
        got = cuda_patches.gather_patches_batch(imgs, y0, x0, P)
        want = cuda_patches.gather_patches_plain(imgs, y0, x0, P)
        errs.append(check_equal(f"patches {name}", got, want))
        inside = float(((y0 >= 0) & (y0 <= H - P) & (x0 >= 0) & (x0 <= W - P)).float().mean())
        # the library yardstick: one advanced-indexing gather, its padded
        # image and index tensors built beforehand
        padded = torch.nn.functional.pad(imgs, (P, P, P, P))
        ar = torch.arange(P, device=dev)
        ys = (torch.clamp(y0.long(), -P, H)[..., None] + P + ar)[..., :, None]
        xs = (torch.clamp(x0.long(), -P, W)[..., None] + P + ar)[..., None, :]
        bi = torch.arange(B, device=dev)[:, None, None, None]
        nbytes = imgs.numel() * 4 + 2 * y0.numel() * 4 + want.numel() * 4
        row = time_shape((B, N, P, P),
                         lambda: cuda_patches.gather_patches_batch(imgs, y0, x0, P),
                         lambda: cuda_patches.gather_patches_plain(imgs, y0, x0, P),
                         {"index": lambda: padded[bi, ys, xs]}, nbytes,
                         launches=TIMED_LAUNCHES if stack is pair else 10)
        row["patches_inside"] = inside
        (rows if stack is pair else batched).append(row)
        del padded, ys, xs, want, got
        torch.cuda.empty_cache()
        say(f"kernel patches {name} {(B, N, P, P)}: exact; device {row['device_ms']:.6f} ms "
            f"(bound {row['bound_ms']:.6f} ms by {row['bound_by']}, share "
            f"{row['share']:.3f}; {inside:.3f} of the patches wholly inside), library "
            f"{row['library_ms']:.6f} ms, host {row['host_ms']:.6f} ms, plain "
            f"{row['plain_ms']:.6f} ms on {card}")
    report.append(summarize("gather_patches_batch", rows, [1, 1], errs,
                            source="plslam_tpu_torch/csrc/patches.cu",
                            replaces="plslam_tpu/ops/pallas_patches.py:100",
                            batched_shapes=batched))

    # FAST score + NMS on the four pyramid levels of the scene pair and of
    # uniform noise (dense corners); raw exact off the 3-px frame, nms off
    # the 4-px frame (the kernel zero-pads where the plain form wraps)
    errs, rows, batched = [], [], []
    for lvls, stack in stacks:
        thr = torch.full((stack.shape[0],), 20.0, device=dev)
        for li, lvl in enumerate(lvls):
            noise = torch.rand(lvl.shape, generator=gen).mul_(255).to(dev)
            for kind, imgs in (("scene", lvl.contiguous()), ("noise", noise)):
                raw, nms = cuda_fast.fast_score_nms_batch(imgs, thr)
                raw_p, nms_p = cuda_fast.fast_score_nms_plain(imgs, thr)
                errs.append(check_equal(f"fast raw L{li} {kind}", raw[:, 3:-3, 3:-3],
                                        raw_p[:, 3:-3, 3:-3]))
                errs.append(check_equal(f"fast nms L{li} {kind}", nms[:, 4:-4, 4:-4],
                                        nms_p[:, 4:-4, 4:-4]))
            imgs = lvl.contiguous()
            px = imgs.numel()
            row = time_shape(tuple(imgs.shape),
                             lambda: cuda_fast.fast_score_nms_batch(imgs, thr),
                             lambda: cuda_fast.fast_score_nms_plain(imgs, thr), {},
                             12 * px + 4 * thr.numel(), *fast_ops(imgs, thr),
                             launches=TIMED_LAUNCHES if stack is pair else 20)
            # the kernel's work depends on the data: noise makes most pixels candidates
            row["device_ms_noise"] = graph_ms(
                lambda: cuda_fast.fast_score_nms_batch(noise, thr),
                TIMED_LAUNCHES if stack is pair else 20)
            row["bound_ms_noise"] = bound(12 * px + 4 * thr.numel(), *fast_ops(noise, thr))[0]
            (rows if stack is pair else batched).append(row)
            say(f"kernel fast L{li} {tuple(imgs.shape)}: exact; device {row['device_ms']:.6f} ms "
                f"(bound {row['bound_ms']:.6f} ms by {row['bound_by']}, share "
                f"{row['share']:.3f}; on noise {row['device_ms_noise']:.6f} ms, bound "
                f"{row['bound_ms_noise']:.6f} ms), no single "
                f"PyTorch call, host {row['host_ms']:.6f} ms, plain {row['plain_ms']:.6f} ms "
                f"on {card}")
            del noise, raw, nms, raw_p, nms_p
            torch.cuda.empty_cache()
    report.append(summarize("fast_score_nms_batch", rows, [1] * len(rows), errs,
                            source="plslam_tpu_torch/csrc/fast.cu",
                            replaces="plslam_tpu/ops/pallas_fast.py:82",
                            batched_shapes=batched))

    # Hamming: stereo + f2f, points 1200x1200 and lines 256x256 (2 each per
    # VO frame); beside them Map2KF against a 2048-candidate local map (SLAM
    # paths) and the loop verification of two ring keyframes, points
    # 160x160 and lines 24x24 (loop path)
    errs, rows = [], []
    for n1, n2 in HAMMING_SHAPES:
        d1 = torch.randint(-2**31, 2**31, (n1, 8), generator=gen, dtype=torch.int64)
        d2 = torch.randint(-2**31, 2**31, (n2, 8), generator=gen, dtype=torch.int64)
        d1, d2 = d1.to(torch.int32).to(dev), d2.to(torch.int32).to(dev)
        got = cuda_hamming.hamming_distance_matrix_cuda(d1, d2)
        want = cuda_hamming.hamming_plain(d1, d2)
        errs.append(check_equal(f"hamming {n1}x{n2}", got, want))
        row = time_shape((n1, n2), lambda: cuda_hamming.hamming_distance_matrix_cuda(d1, d2),
                         lambda: cuda_hamming.hamming_plain(d1, d2), hamming_library(d1, d2),
                         (n1 + n2) * 32 + n1 * n2 * 4, (2.0 * n1 * n2 * 256, INT8_OPS_PER_S))
        rows.append(row)
        say(f"kernel hamming {n1}x{n2}: exact; device {row['device_ms']:.6f} ms (bound "
            f"{row['bound_ms']:.6f} ms by {row['bound_by']}, share {row['share']:.3f}), "
            f"library {row['library']} ms, host {row['host_ms']:.6f} ms, plain "
            f"{row['plain_ms']:.6f} ms on {card}")
    # the batched launch of phase 10's frames: B stereo or f2f matrices at
    # once, points (B, 1200, 8)^2 and lines (B, 256, 8)^2
    batched = []
    for B in HAMMING_BATCHES:
        for n in (1200, 256):
            d1 = torch.randint(-2**31, 2**31, (B, n, 8), generator=gen, dtype=torch.int64)
            d2 = torch.randint(-2**31, 2**31, (B, n, 8), generator=gen, dtype=torch.int64)
            d1, d2 = d1.to(torch.int32).to(dev), d2.to(torch.int32).to(dev)
            errs.append(check_equal(f"hamming batched {B}x{n}x{n}",
                                    cuda_hamming.hamming_distance_matrix_cuda(d1, d2),
                                    cuda_hamming.hamming_plain(d1, d2)))
            row = time_shape((B, n, n), lambda: cuda_hamming.hamming_distance_matrix_cuda(d1, d2),
                             lambda: cuda_hamming.hamming_plain(d1, d2), hamming_library(d1, d2),
                             B * (2 * n * 32 + n * n * 4), (2.0 * B * n * n * 256, INT8_OPS_PER_S))
            batched.append(row)
            say(f"kernel hamming batched {B}x{n}x{n}: exact; device {row['device_ms']:.6f} ms "
                f"(bound {row['bound_ms']:.6f} ms by {row['bound_by']}, share "
                f"{row['share']:.3f}), library {row['library']} ms, host {row['host_ms']:.6f} "
                f"ms, plain {row['plain_ms']:.6f} ms on {card}")
            del d1, d2
            torch.cuda.empty_cache()
    per_frame = [HAMMING_VO.get(s, 0) for s in HAMMING_SHAPES]
    report.append(summarize("hamming_distance_matrix_cuda", rows, per_frame, errs,
                            source="plslam_tpu_torch/csrc/hamming.cu",
                            replaces="plslam_tpu/ops/pallas_hamming.py:45",
                            batched_shapes=batched))
    return report


KERNEL_WRAPPERS = ("gather_patches_batch", "fast_score_nms_batch",
                   "hamming_distance_matrix_cuda")


def _wrappers():
    from plslam_tpu_torch.ops import cuda_fast, cuda_hamming, cuda_patches

    return {"gather_patches_batch": cuda_patches.gather_patches_batch,
            "fast_score_nms_batch": cuda_fast.fast_score_nms_batch,
            "hamming_distance_matrix_cuda": cuda_hamming.hamming_distance_matrix_cuda}


def phase_main_path(dev, scene, poses, frames):
    """VisualOdometry through the kernels at the bench configuration."""
    from plslam_tpu_torch.core.camera import StereoCamera
    from plslam_tpu_torch.frontend.frame import FrontendConfig
    from plslam_tpu_torch.frontend.tracker import TrackerConfig
    from plslam_tpu_torch.io import ate_rmse
    from plslam_tpu_torch.vo import VisualOdometry

    wrappers = _wrappers()
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

    # the step repeats: a second VisualOdometry over the same frames gives
    # every frame's pose bit for bit (the sums are in a fixed order)
    again = VisualOdometry(cam, vo.fcfg, vo.tcfg, device=dev)
    again.initialize(*frames[0])
    repeat = [again.process(*frames[i]) for i in range(1, len(results) + 1)]
    same = [torch.equal(a.T_f_w, b.T_f_w) for a, b in zip(results, repeat)]
    diff = max(float((a.T_f_w - b.T_f_w).abs().max()) for a, b in zip(results, repeat))
    say(f"main path repeat: {sum(same)}/{len(same)} frames' T_f_w bit-identical across two "
        f"runs (max |diff| {diff:.3g})")
    if not all(same):
        raise AssertionError(f"the VO step does not repeat: frames {same}")

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


def phase_slam(dev, scene, smi):
    """PLSLAM through the kernels at bench_slam.py's configuration."""
    from plslam_tpu_torch.backend.mapping import MapConfig
    from plslam_tpu_torch.config import PLSLAMConfig
    from plslam_tpu_torch.core.camera import StereoCamera
    from plslam_tpu_torch.io import ate_rmse, circular_trajectory
    from plslam_tpu_torch.pipeline import PLSLAM

    cam = StereoCamera.create(scene.fx, scene.fy, scene.cx, scene.cy, scene.b,
                              width=scene.width, height=scene.height)
    poses = circular_trajectory(SLAM_WARMUP + SLAM_FRAMES, step_t=0.05)
    frames = [tuple(torch.from_numpy(x).to(dev) for x in scene.render_stereo(T, noise=1.0))
              for T in poses]
    torch.cuda.synchronize()
    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    slam = PLSLAM(cam, PLSLAMConfig(orb_nfeatures=1200, lsd_nfeatures=256,
                                    min_entropy_ratio=0.99),
                  MapConfig(local_ba_kf=8, ba_points=2048, ba_lines=256, ba_pobs=8192,
                            ba_lobs=2048), device=dev)
    for i in range(SLAM_WARMUP):
        slam.process(*frames[i], timestamp=0.05 * i)
    slam.wait_until_idle()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(SLAM_WARMUP, SLAM_WARMUP + SLAM_FRAMES):
        slam.process(*frames[i], timestamp=0.05 * i)
    slam.wait_until_idle()
    torch.cuda.synchronize()
    fps = SLAM_FRAMES / (time.perf_counter() - t0)
    n_kf = len(slam.mapper.map.keyframes)
    n_lba = slam.mapper.n_local_ba_applied

    # local BA of the final 8-keyframe window, solved and copied back
    # (no write-back), host clock around a synchronized solve
    lba_ms = []
    with slam.mapper._map_lock:
        for _ in range(LBA_REPS):
            prob, meta = slam.mapper.build_local_ba()
            torch.cuda.synchronize()
            t = time.perf_counter()
            out, _ = slam.mapper._solve_local(prob, meta)
            out.cpu()
            lba_ms.append(1e3 * (time.perf_counter() - t))
    lba_shape = (int(prob.T_c_w.shape[0]), len(meta["pt_ids"]), len(meta["ls_ids"]),
                 int(prob.p_valid.sum()), int(prob.l_valid.sum()))

    t = time.perf_counter()
    traj = slam.finish(run_gba=True)
    torch.cuda.synchronize()
    gba_ms = 1e3 * (time.perf_counter() - t)
    by_thread = {k: fn.launches_by_thread() for k, fn in wrappers.items()}

    good = [lg.good for lg in slam.logs]
    est = np.stack([T[:3, 3] for T in traj])
    gt = np.stack([poses[int(round(ts / 0.05))][:3, 3] for ts in slam.kf_timestamps])
    ate = ate_rmse(est, gt, align=True)
    mapper_hamming = by_thread["hamming_distance_matrix_cuda"].get(MAPPER_THREAD, 0)
    say(f"slam: {fps:.3f} full-SLAM frames/s over {SLAM_FRAMES} frames; "
        f"{sum(good)}/{len(good)} frames good; {n_kf} keyframes; "
        f"{n_lba} local BAs written back")
    say(f"slam: local BA median {float(np.median(lba_ms)):.3f} ms (min {min(lba_ms):.3f}, "
        f"max {max(lba_ms):.3f}; {LBA_REPS} solves; K, points, lines, point obs, "
        f"line obs = {lba_shape}); GBA (finish) {gba_ms:.3f} ms over {len(traj)} "
        f"keyframes on {smi}")
    say(f"slam: keyframe ATE {ate:.6f} m (aligned; floor {SLAM_ATE_FLOOR:.6f}, "
        f"JAX CPU {JAX_CPU_SLAM_ATE:.6f})")
    say(f"slam launches by thread: {by_thread}")
    if slam._map_errors:
        raise AssertionError(f"mapping thread raised: {slam._map_errors!r}")
    if not all(good):
        raise AssertionError(f"frames lost tracking: {good}")
    if n_kf < 8:
        raise AssertionError(f"only {n_kf} keyframes")
    if n_lba < 1:
        raise AssertionError("no local BA was written back")
    if not np.isfinite(np.stack(traj)).all():
        raise AssertionError("GBA poses are not finite")
    if not ate <= SLAM_ATE_FLOOR:
        raise AssertionError(f"keyframe ATE {ate} above floor {SLAM_ATE_FLOOR}")
    if mapper_hamming <= 0:
        raise AssertionError("the mapping thread never launched the Hamming kernel")
    for k in KERNEL_WRAPPERS:
        if sum(by_thread[k].values()) <= 0:
            raise AssertionError(f"kernel {k} never launched on the SLAM path")
    return by_thread, fps, ate


def make_ba_problem_np(K=8, P=512, L=64, noise=0.0, pert=0.02, seed=11):
    """numpy twin of tests/test_ba.make_problem (same draws, same order):
    every camera sees every landmark, pose 0 fixed, perturbed start."""
    rng = np.random.default_rng(seed)
    poses_xi = np.concatenate([rng.uniform(-0.5, 0.5, (K, 2)), rng.uniform(-0.1, 0.1, (K, 1)),
                               rng.uniform(-0.05, 0.05, (K, 3))], axis=1)
    Pw = np.stack([rng.uniform(-3, 3, P), rng.uniform(-2, 2, P), rng.uniform(4, 10, P)], -1)
    LA = np.stack([rng.uniform(-3, 3, L), rng.uniform(-2, 2, L), rng.uniform(4, 10, L)], -1)
    LB = LA + np.stack([rng.uniform(-1.5, 1.5, L), rng.uniform(-1.5, 1.5, L),
                        rng.uniform(-0.5, 0.5, L)], -1)
    pert_xi = rng.normal(size=(K, 6)) * pert
    pert_xi[0] = 0.0
    pert_P = rng.normal(size=(P, 3)) * pert
    pert_orth = rng.normal(size=(L, 4)) * pert * 0.5
    noise_uv = rng.normal(size=(K * P, 2)) * noise
    noise_s = rng.normal(size=(K * L, 2)) * noise
    noise_e = rng.normal(size=(K * L, 2)) * noise
    return dict(poses_xi=poses_xi, Pw=Pw, LA=LA, LB=LB, pert_xi=pert_xi, pert_P=pert_P,
                pert_orth=pert_orth, noise_uv=noise_uv, noise_s=noise_s, noise_e=noise_e)


def phase_local_ba(dev, smi):
    """LM iterations/s of the local-BA solver (bench_slam.py's problem)."""
    from plslam_tpu_torch.backend import ba
    from plslam_tpu_torch.core import lie
    from plslam_tpu_torch.core.camera import StereoCamera
    from plslam_tpu_torch.core.plucker import plucker_from_two_points, plucker_to_orth

    K, P, L = 8, 512, 64
    d = {k: torch.from_numpy(v).to(dev) for k, v in make_ba_problem_np(K, P, L).items()}
    cam = StereoCamera.create(435.2, 435.2, 367.4, 252.2, 0.110074)
    T_c_w = lie.inv_se3(lie.exp_se3(d["poses_xi"]))
    cp = torch.arange(K, device=dev).repeat_interleave(P)
    lp = torch.arange(P, device=dev).repeat(K)
    cl = torch.arange(K, device=dev).repeat_interleave(L)
    ll = torch.arange(L, device=dev).repeat(K)
    uv = cam.project(lie.transform_point(T_c_w[cp], d["Pw"][lp])) + d["noise_uv"]
    sA = cam.project(lie.transform_point(T_c_w[cl], d["LA"][ll])) + d["noise_s"]
    eB = cam.project(lie.transform_point(T_c_w[cl], d["LB"][ll])) + d["noise_e"]
    Lw = plucker_from_two_points(d["LA"], d["LB"])
    scale = torch.linalg.norm(Lw, dim=-1)
    orth = plucker_to_orth(Lw / scale[:, None]) + d["pert_orth"]
    f32 = torch.float32
    ones = functools.partial(torch.ones, device=dev)
    prob = ba.BAProblem(
        T_c_w=(lie.exp_se3(d["pert_xi"]) @ T_c_w).to(f32),
        pose_fixed=torch.arange(K, device=dev) == 0, pose_valid=ones(K, dtype=torch.bool),
        points=(d["Pw"] + d["pert_P"]).to(f32), point_valid=ones(P, dtype=torch.bool),
        lines_orth=orth.to(f32), lines_scale=scale.to(f32), line_valid=ones(L, dtype=torch.bool),
        p_cam=cp, p_lm=lp, p_uv=uv.to(f32), p_sigma2=ones(K * P, dtype=f32),
        p_valid=ones(K * P, dtype=torch.bool),
        l_cam=cl, l_lm=ll, l_sobs=sA.to(f32), l_eobs=eB.to(f32),
        l_sigma2=ones(K * L, dtype=f32), l_valid=ones(K * L, dtype=torch.bool))
    cfg = ba.BAConfig()
    cost0 = float(ba.total_cost(prob, cam, cfg, prob.p_valid, prob.l_valid))

    def run():
        return ba.lm_rounds(prob, cam, cfg, prob.p_valid, prob.l_valid, LM_ITERS)

    first = run()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reps = []
    start.record()
    for _ in range(LM_REPS):
        reps.append(run())
    end.record()
    end.synchronize()
    res, cost, trips = reps[-1]
    # every run of the same problem gives the same iterates and cost, bit for bit
    fields = ("T_c_w", "points", "lines_orth")
    same = [all(torch.equal(getattr(r[0], f), getattr(first[0], f)) for f in fields)
            and torch.equal(r[1], first[1]) and torch.equal(r[2], first[2]) for r in reps]
    say(f"local BA repeat: {sum(same)}/{len(same)} lm_rounds runs bit-identical to the first "
        f"(poses, points, lines, cost, trips)")
    if not all(same):
        raise AssertionError(f"lm_rounds does not repeat: {same}")
    ms = start.elapsed_time(end)
    ips = LM_ITERS * LM_REPS / (ms / 1e3)
    cost, trips = float(cost), int(trips)
    say(f"local BA: {ips:.3f} LM iterations/s ({LM_ITERS} trips x {LM_REPS} reps, "
        f"{ms / LM_REPS:.3f} ms per lm_rounds; f32 K={K} P={P} L={L}); cost "
        f"{cost0:.6g} -> {cost:.6g}; {trips} trips before the early exit; on {smi}")
    if not (np.isfinite(cost) and cost < 1e-3 * cost0):
        raise AssertionError(f"LM did not converge: {cost0} -> {cost}")
    if not torch.isfinite(res.T_c_w).all():
        raise AssertionError("LM poses are not finite")
    return ips


def phase_endpoint_slam(dev, scene, smi):
    """PLSLAM with endpoint lines, loop closure and the keyframe refinement
    at phase 5's configuration."""
    from plslam_tpu_torch.backend.mapping import MapConfig
    from plslam_tpu_torch.config import PLSLAMConfig
    from plslam_tpu_torch.core.camera import StereoCamera
    from plslam_tpu_torch.io import ate_rmse, circular_trajectory
    from plslam_tpu_torch.pipeline import PLSLAM

    cam = StereoCamera.create(scene.fx, scene.fy, scene.cx, scene.cy, scene.b,
                              width=scene.width, height=scene.height)
    poses = circular_trajectory(SLAM_WARMUP + SLAM_FRAMES, step_t=0.05)
    frames = [tuple(torch.from_numpy(x).to(dev) for x in scene.render_stereo(T, noise=1.0))
              for T in poses]
    torch.cuda.synchronize()
    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    cfg = PLSLAMConfig(orb_nfeatures=1200, lsd_nfeatures=256, min_entropy_ratio=0.99,
                       use_line_plucker=False, use_loop_closure=True, has_refinement=True,
                       vocabulary_p=os.path.join(CONFIGS, "vocab_orb_k10L3.yml.gz"),
                       vocabulary_l=os.path.join(CONFIGS, "vocab_lbd_k10L3.yml.gz"))
    slam = PLSLAM(cam, cfg, MapConfig(local_ba_kf=8, ba_points=2048, ba_lines=256,
                                      ba_pobs=8192, ba_lobs=2048, plucker_lines=False,
                                      has_refinement=True), device=dev)
    t0 = time.perf_counter()
    for i in range(SLAM_WARMUP):
        slam.process(*frames[i], timestamp=0.05 * i)
    slam.wait_until_idle()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for i in range(SLAM_WARMUP, SLAM_WARMUP + SLAM_FRAMES):
        slam.process(*frames[i], timestamp=0.05 * i)
    slam.wait_until_idle()
    torch.cuda.synchronize()
    fps = SLAM_FRAMES / (time.perf_counter() - t1)
    n_kf = len(slam.mapper.map.keyframes)
    n_lba = slam.mapper.n_local_ba_applied
    n_bow = len(slam.loop_closer.bow)
    t = time.perf_counter()
    traj = slam.finish(run_gba=True)
    torch.cuda.synchronize()
    gba_ms = 1e3 * (time.perf_counter() - t)
    wall = time.perf_counter() - t0
    by_thread = {k: fn.launches_by_thread() for k, fn in wrappers.items()}

    good = [lg.good for lg in slam.logs]
    est = np.stack([T[:3, 3] for T in traj])
    gt = np.stack([poses[int(round(ts / 0.05))][:3, 3] for ts in slam.kf_timestamps])
    ate = ate_rmse(est, gt, align=True)
    say(f"endpoint slam: {fps:.3f} full-SLAM frames/s over {SLAM_FRAMES} frames "
        f"({wall:.3f} s for all {len(frames)} frames and the GBA); {sum(good)}/{len(good)} "
        f"frames good; {n_kf} keyframes; {n_lba} local BAs written back; {n_bow} keyframes "
        f"BoW-encoded; {len(slam.loop_reports)} loops; GBA (finish) {gba_ms:.3f} ms on {smi}")
    say(f"endpoint slam: keyframe ATE {ate:.6f} m (aligned; floor {EP_ATE_FLOOR:.6f}, "
        f"JAX CPU {JAX_CPU_EP_ATE:.6f})")
    say(f"endpoint slam launches by thread: {by_thread}")
    if slam._map_errors:
        raise AssertionError(f"a worker thread raised: {slam._map_errors!r}")
    if not all(good):
        raise AssertionError(f"frames lost tracking: {good}")
    if n_kf < 8:
        raise AssertionError(f"only {n_kf} keyframes")
    if n_lba < 1:
        raise AssertionError("no local BA was written back")
    if n_bow != n_kf:
        raise AssertionError(f"{n_bow} BoW records for {n_kf} keyframes")
    if slam.loop_reports:
        raise AssertionError(f"false loop closure: {slam.loop_reports}")
    if not np.isfinite(np.stack(traj)).all():
        raise AssertionError("GBA poses are not finite")
    if not ate <= EP_ATE_FLOOR:
        raise AssertionError(f"keyframe ATE {ate} above floor {EP_ATE_FLOOR}")
    if by_thread["hamming_distance_matrix_cuda"].get(MAPPER_THREAD, 0) <= 0:
        raise AssertionError("the mapping thread never launched the Hamming kernel")
    for k in KERNEL_WRAPPERS:
        if sum(by_thread[k].values()) <= 0:
            raise AssertionError(f"kernel {k} never launched on the endpoint SLAM path")
    return by_thread, fps, ate


class RingWorld:
    """numpy twin of tests/_map_fixtures.RingWorld (same draws, same order):
    points and wall-tangent segments on a cylindrical corridor wall."""

    def __init__(self, n_pts=3000, n_ls=300, seed=5, radius=8.0, depth=(3.0, 8.0),
                 height=2.5):
        rng = np.random.default_rng(seed)
        self.radius = radius
        phi = rng.uniform(0, 2 * np.pi, n_pts)
        rp = radius + rng.uniform(depth[0], depth[1], n_pts)
        self.pts = np.stack([rp * np.cos(phi), rng.uniform(-height, height, n_pts),
                             rp * np.sin(phi)], axis=-1)
        self.pt_desc = rng.integers(0, 2 ** 32, (n_pts, 8), dtype=np.uint32)
        phi = rng.uniform(0, 2 * np.pi, n_ls)
        rl = radius + rng.uniform(depth[0], depth[1], n_ls)
        A = np.stack([rl * np.cos(phi), rng.uniform(-height, height, n_ls),
                      rl * np.sin(phi)], axis=-1)
        tang = np.stack([-np.sin(phi), np.zeros(n_ls), np.cos(phi)], -1)
        vert = np.stack([np.zeros(n_ls), np.ones(n_ls), np.zeros(n_ls)], -1)
        is_v = rng.uniform(size=n_ls) < 0.4
        B = A + np.where(is_v[:, None], vert, tang) * rng.uniform(0.8, 2.0, n_ls)[:, None]
        self.ls_A, self.ls_B = A, B
        self.ls_desc = rng.integers(0, 2 ** 32, (n_ls, 8), dtype=np.uint32)

    def pose_at(self, theta: float) -> np.ndarray:
        """Camera->world pose on the ring at angle theta, looking outward."""
        z = np.array([np.cos(theta), 0.0, np.sin(theta)])
        y = np.array([0.0, 1.0, 0.0])
        T = np.eye(4)
        T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = np.cross(y, z), y, z, self.radius * z
        return T


def _desc_noise(desc, n_bits, rng):
    """Flip n_bits random bits per descriptor (a few bits differ between
    sightings of one feature)."""
    if n_bits <= 0 or not len(desc):
        return desc
    out = desc.copy()
    words = rng.integers(0, 8, (len(desc), n_bits))
    bits = rng.integers(0, 32, (len(desc), n_bits))
    for j in range(n_bits):
        out[np.arange(len(desc)), words[:, j]] ^= np.uint32(1) << bits[:, j].astype(np.uint32)
    return out


def render_ring_features(world, T_w_c, cam, rng, cap_pt=160, cap_ls=24, desc_noise_bits=6,
                         width=752, height=480):
    """numpy twin of tests/_map_fixtures.render_ring_features: the cap_pt
    points and cap_ls segments nearest the image centre, padded, as
    {"points": {...}, "lines": {...}} of numpy arrays (uint32 words);
    ``cam`` is (fx, fy, cx, cy, b) as floats, ``rng`` draws the descriptor
    noise."""
    fx, fy, cx, cy, bl = cam
    T_c_w = np.linalg.inv(T_w_c)
    R, t = T_c_w[:3, :3], T_c_w[:3, 3]

    def proj(Pw):
        Pc = Pw @ R.T + t
        z = np.maximum(Pc[:, 2], 1e-9)
        uv = np.stack([cx + fx * Pc[:, 0] / z, cy + fy * Pc[:, 1] / z], -1)
        ok = ((Pc[:, 2] > 0.5) & (uv[:, 0] >= 8) & (uv[:, 0] < width - 8)
              & (uv[:, 1] >= 8) & (uv[:, 1] < height - 8))
        return Pc, uv, ok

    Pc, uv, ok = proj(world.pts)
    d2 = (uv[:, 0] - cx) ** 2 + (uv[:, 1] - cy) ** 2
    d2[~ok] = np.inf
    sel = np.argsort(d2)[:cap_pt]
    sel = sel[np.isfinite(d2[sel])]
    n = len(sel)
    f32 = functools.partial(np.zeros, dtype=np.float32)
    points = dict(uv=f32((cap_pt, 2)), disp=np.ones(cap_pt, np.float32), P=f32((cap_pt, 3)),
                  desc=np.zeros((cap_pt, 8), np.uint32), sigma2=np.ones(cap_pt, np.float32),
                  valid=np.arange(cap_pt) < n)
    points["uv"][:n] = uv[sel]
    points["P"][:n] = Pc[sel]
    points["desc"][:n] = _desc_noise(world.pt_desc[sel], desc_noise_bits, rng)
    points["disp"][:n] = fx * bl / np.maximum(Pc[sel, 2], 1e-9)

    aC, auv, aok = proj(world.ls_A)
    bC, buv, bok = proj(world.ls_B)
    lok = aok & bok
    mid2 = ((0.5 * (auv + buv) - np.array([cx, cy])) ** 2).sum(-1)
    mid2[~lok] = np.inf
    lsel = np.argsort(mid2)[:cap_ls]
    lsel = lsel[np.isfinite(mid2[lsel])]
    m = len(lsel)
    lines = dict(sp=f32((cap_ls, 2)), ep=f32((cap_ls, 2)), sdisp=np.ones(cap_ls, np.float32),
                 edisp=np.ones(cap_ls, np.float32), sP=f32((cap_ls, 3)), eP=f32((cap_ls, 3)),
                 le=f32((cap_ls, 3)), angle=None, NDc=f32((cap_ls, 6)),
                 desc=np.zeros((cap_ls, 8), np.uint32), sigma2=np.ones(cap_ls, np.float32),
                 valid=np.arange(cap_ls) < m)
    if m:
        a2, b2 = auv[lsel], buv[lsel]
        le = np.cross(np.concatenate([a2, np.ones((m, 1))], 1),
                      np.concatenate([b2, np.ones((m, 1))], 1))
        lines["le"][:m] = le / np.maximum(np.hypot(le[:, 0], le[:, 1]), 1e-9)[:, None]
        lines["sp"][:m], lines["ep"][:m] = a2, b2
        lines["sP"][:m], lines["eP"][:m] = aC[lsel], bC[lsel]
        lines["NDc"][:m] = np.concatenate([np.cross(aC[lsel], bC[lsel]),
                                           bC[lsel] - aC[lsel]], axis=-1)
        lines["desc"][:m] = _desc_noise(world.ls_desc[lsel], desc_noise_bits, rng)
    lines["angle"] = np.arctan2(lines["ep"][:, 1] - lines["sp"][:, 1],
                                lines["ep"][:, 0] - lines["sp"][:, 0]).astype(np.float32)
    return {"points": points, "lines": lines}


def _ate_translation(T_est, T_true) -> float:
    """ATE RMSE with translation-only alignment (both gauges KF0-fixed)."""
    e = np.stack([T[:3, 3] for T in T_est])
    g = np.stack([T[:3, 3] for T in T_true])
    e = e - e[0] + g[0]
    return float(np.sqrt(((e - g) ** 2).sum(-1).mean()))


class _Messages(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def phase_loop_closure(dev, smi):
    """tests/test_scale_e2e.py's ring replay through PLSLAM on the card."""
    from plslam_tpu_torch.backend.mapping import MapConfig
    from plslam_tpu_torch.config import PLSLAMConfig
    from plslam_tpu_torch.convert import stereo_features_from_numpy
    from plslam_tpu_torch.core import lie
    from plslam_tpu_torch.core.camera import StereoCamera
    from plslam_tpu_torch.pipeline import PLSLAM

    cam = StereoCamera.create(458.0, 457.0, 376.0, 240.0, 0.11, width=752, height=480)
    cam_k = cam[:5]   # the f32-rounded intrinsics, as the fixture renders
    world = RingWorld(n_pts=3000, n_ls=300, seed=5)
    thetas = np.linspace(0.0, 2 * np.pi * RING_KF / 140.0, RING_KF, endpoint=False)
    T_true = [world.pose_at(th) for th in thetas]
    rng = np.random.default_rng(11)
    T_est = [T_true[0]]
    for i in range(1, RING_KF):
        rel = np.linalg.inv(T_true[i - 1]) @ T_true[i]
        eps = np.concatenate([rng.normal(0, 0.010, 3), rng.normal(0, 0.0025, 3)])
        T_est.append(T_est[-1] @ rel @ lie.exp_se3(torch.from_numpy(eps)).numpy())
    desc_rng = np.random.default_rng(1234)
    feats = [stereo_features_from_numpy(render_ring_features(world, T, cam_k, desc_rng), dev)
             for T in T_true]
    torch.cuda.synchronize()

    cfg = PLSLAMConfig(use_line_plucker=False, use_loop_closure=True, multithread_slam=True)
    if cfg.lc_kf_dist != 50:
        raise AssertionError(f"lc_kf_dist {cfg.lc_kf_dist}: the reference gating is 50")
    slam = PLSLAM(cam, cfg, MapConfig(use_lines=True, plucker_lines=False, local_ba_kf=8,
                                      ba_points=512, ba_lines=64, ba_pobs=2048, ba_lobs=512),
                  device=dev)
    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    for i in range(RING_KF):
        slam.insert_keyframe_features(T_est[i], feats[i], timestamp=0.1 * i)
    slam.wait_until_idle()
    torch.cuda.synchronize()
    kf_per_s = RING_KF / (time.perf_counter() - t0)
    mp = slam.mapper.map
    ate_closed = _ate_translation([k.T_w_k for k in mp.keyframes], T_true)

    log = logging.getLogger("plslam")
    handler, old_level = _Messages(), log.level
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    try:
        t = time.perf_counter()
        traj = slam.finish(run_gba=True)
        torch.cuda.synchronize()
        gba_ms = 1e3 * (time.perf_counter() - t)
    finally:
        log.removeHandler(handler)
        log.setLevel(old_level)
    by_thread = {k: fn.launches_by_thread() for k, fn in wrappers.items()}
    gba_msgs = [m for m in handler.messages if m.startswith("GBA:")]
    n_chunks = int(gba_msgs[-1].split(" in ")[1].split()[0]) if gba_msgs else 0
    ate_gba = _ate_translation(traj, T_true)
    drift_odo = _ate_translation(T_est, T_true)
    reports = slam.loop_reports
    r = reports[-1] if reports else None
    say(f"loop: {kf_per_s:.3f} keyframes/s over the {RING_KF}-keyframe replay; "
        f"{len(mp.keyframes)} keyframes, {int(mp.pt_valid.sum())} points, "
        f"{int(mp.ls_valid.sum())} lines; on {smi}")
    for rep in reports:
        say(f"loop: closure kf {rep['kf']} -> candidate {rep['candidate']}: PGO "
            f"{rep['pgo_ms']:.3f} ms, fusion {rep['fuse_ms']:.3f} ms, fused {rep['fused']}, "
            f"correction {rep['correction']:.6f} m on {smi}")
    say(f"loop: ATE odometry {drift_odo:.6f} m, after the closure {ate_closed:.6f} m, after "
        f"the GBA {ate_gba:.6f} m; GBA (finish) {gba_ms:.3f} ms in {n_chunks} chunks on {smi}")
    say(f"loop launches by thread: {by_thread}")
    if slam._map_errors:
        raise AssertionError(f"a worker thread raised: {slam._map_errors!r}")
    if r is None:
        raise AssertionError("no loop closure at lc_kf_dist=50")
    for rep in reports:
        if not (rep["kf"] >= RING_REVISIT and rep["candidate"] <= 20):
            raise AssertionError(f"false loop closure: {rep}")
    if not (r["candidate"] <= r["kf"] - 50):
        raise AssertionError(f"candidate within lc_kf_dist: {r}")
    if not (drift_odo > 0.1 and ate_closed < drift_odo):
        raise AssertionError(f"ATE after the closure {ate_closed} vs odometry {drift_odo}")
    k = r["kf"]
    err_odo = np.linalg.norm(T_est[k][:3, 3] - T_true[k][:3, 3])
    err_map = np.linalg.norm(mp.keyframes[k].T_w_k[:3, 3] - T_true[k][:3, 3])
    say(f"loop: closure keyframe error {err_map:.6f} m vs odometry {err_odo:.6f} m")
    if not (err_odo > 0.1 and err_map < 0.5 * err_odo):
        raise AssertionError(f"closure keyframe error {err_map} vs odometry {err_odo}")
    if sum(r["fused"].values()) < 10:
        raise AssertionError(f"too little fusion: {r['fused']}")
    if n_chunks < 2:
        raise AssertionError(f"GBA ran in {n_chunks} chunk(s): {gba_msgs}")
    if not (np.isfinite(np.stack(traj)).all() and ate_gba < 1.0):
        raise AssertionError(f"GBA poses: finite {np.isfinite(np.stack(traj)).all()}, "
                             f"ATE {ate_gba}")
    if by_thread["hamming_distance_matrix_cuda"].get(LOOP_THREAD, 0) <= 0:
        raise AssertionError("the loop-closure thread never launched the Hamming kernel")
    return by_thread, kf_per_s



def start_disk_fixture(path: str) -> subprocess.Popen:
    """Write phase 9's fixture in a background process (rendering 40 frames
    at 752x480 takes tens of seconds of host time); ``wait_disk_fixture``
    ends it before any timed phase."""
    return subprocess.Popen(
        [sys.executable, "-m", "plslam_tpu_torch.io.mini_euroc", path, "--frames",
         str(DISK_FRAMES), "--euroc-size"], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def wait_disk_fixture(writer: subprocess.Popen) -> None:
    t = time.perf_counter()
    out, _ = writer.communicate(timeout=900)
    if writer.returncode != 0:
        raise AssertionError(f"fixture writer failed ({writer.returncode}): {out[-2000:]}")
    say(f"build: phase 9's fixture ready ({out.strip()}; waited {time.perf_counter() - t:.3f} s "
        "after the build, before phase 3)")


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    return type(tree)(*(_to_cpu(x) for x in tree))


def check_diagnostics_on_card(dev, fixture, cfg, frames, smi) -> None:
    """Without matplotlib: frame diagnostics of fixture ``frames`` on the
    card against the same call on the CPU, and their residual records."""
    from plslam_tpu_torch import config as C
    from plslam_tpu_torch import viz_frame
    from plslam_tpu_torch.core.camera import StereoCamera
    from plslam_tpu_torch.io import euroc
    from plslam_tpu_torch.vo import VisualOdometry

    calib = euroc.load_euroc_calib(os.path.join(fixture, "params.yaml"))
    cam = StereoCamera.create(calib.fx, calib.fy, calib.cx, calib.cy, calib.baseline,
                              width=calib.width, height=calib.height)
    ds = euroc.EurocDataset(fixture, calib)
    tcfg = C.tracker(cfg)
    vo = VisualOdometry(cam, C.frontend(cfg, 752), tcfg, device=dev)
    jsonl = os.path.join(fixture, "residuals.jsonl")
    for frame in frames:
        vo.initialize(*(torch.from_numpy(x).to(dev) for x in ds[frame - 1][:2]))
        prev = vo.current_features
        res = vo.process(*(torch.from_numpy(x).to(dev) for x in ds[frame][:2]))
        curr = vo.current_features
        got = viz_frame.compute_frame_diagnostics(prev, curr, res.DT, cam, tcfg)
        want = viz_frame.compute_frame_diagnostics(_to_cpu(prev), _to_cpu(curr),
                                                   res.DT.cpu(), cam, tcfg)
        for k, w in want.items():
            g = got[k]
            if w.dtype == bool:
                if not np.array_equal(g, w):
                    raise AssertionError(f"diagnostics {k} of frame {frame}: card != CPU")
            elif not np.allclose(g, w, rtol=0, atol=1e-4):
                raise AssertionError(f"diagnostics {k} of frame {frame}: max |card - CPU| "
                                     f"{np.abs(g - w).max()}")
        viz_frame.dump_residuals_jsonl(got, jsonl, frame)
        say(f"disk: frame {frame} diagnostics on the card = CPU ({int(got['p_valid'].sum())} "
            f"points, {int(got['l_valid'].sum())} lines tracked) on {smi}")
    with open(jsonl) as f:
        written = [json.loads(ln)["frame"] for ln in f]
    if written != list(frames):
        raise AssertionError(f"residual records of frames {written}")
    say("disk: overlay PNGs not rendered: the card's machine has no matplotlib; residual "
        f"records written by dump_residuals_jsonl for frames {written}")


def check_remap_on_card(dev, fixture, smi) -> tuple[float, float]:
    """configs/euroc_params.yaml's rectification of one fixture pair on the
    card against the plain CPU remap; the maps' host build time and the
    remap's device time per pair."""
    from plslam_tpu_torch.io import euroc
    from plslam_tpu_torch.ops.image import remap

    t = time.perf_counter()
    calib = euroc.load_euroc_calib(os.path.join(CONFIGS, "euroc_params.yaml"))
    maps_ms = 1e3 * (time.perf_counter() - t)
    if calib.identity_maps or (calib.width, calib.height) != (752, 480):
        raise AssertionError("configs/euroc_params.yaml did not give 752x480 maps")
    ds = euroc.EurocDataset(fixture, calib, rectify_on_host=False)
    pair = np.stack([euroc.read_image(ds.files_l[0]), euroc.read_image(ds.files_r[0])])
    mx = torch.from_numpy(np.stack([calib.map_l[0], calib.map_r[0]]))
    my = torch.from_numpy(np.stack([calib.map_l[1], calib.map_r[1]]))
    want = remap(torch.from_numpy(pair).float(), mx, my)
    raw, mxd, myd = torch.from_numpy(pair).to(dev), mx.to(dev), my.to(dev)
    got = remap(raw.float(), mxd, myd)
    err = (got.cpu() - want).abs().max().item()
    if not err <= 1e-3:
        raise AssertionError(f"device remap vs CPU: max |diff| {err}")
    # device time from a CUDA graph of 100 calls (a stream of eager calls
    # measures the host's issue rate: ~25 small kernels per call); host time
    # of one call between events; bound: the uint8 pair and the two maps
    # read once, the float32 pair written once
    fn = lambda: remap(raw.float(), mxd, myd)  # noqa: E731
    remap_us, host_us = 1e3 * graph_ms(fn), 1e3 * median_ms(fn)
    bound_us = 1e3 * bound(raw.numel() + 4 * (mxd.numel() + myd.numel()) + 4 * mxd.numel())[0]
    say(f"disk: rectification maps of configs/euroc_params.yaml built on the host in "
        f"{maps_ms:.3f} ms; device remap = CPU remap (max |diff| {err:.3g} grey levels); "
        f"(2, 480, 752) pair, uint8 -> float32 + remap: device {remap_us:.3f} us (bound "
        f"{bound_us:.3f} us by bytes), host {host_us:.3f} us per call on {smi}")
    return maps_ms, remap_us


def phase_disk(dev, smi, fixture):
    """``run_euroc.main`` over the on-disk fixture on the card."""
    from plslam_tpu_torch import run_euroc
    from plslam_tpu_torch.config import PLSLAMConfig

    config = os.path.join(CONFIGS, "config_euroc.yaml")
    overlays = importlib.util.find_spec("matplotlib") is not None
    traj = os.path.join(fixture, "trajectory_tum.txt")
    ov_dir = os.path.join(fixture, "overlays")
    argv = [fixture, "--params", os.path.join(fixture, "params.yaml"), "--config", config,
            "--gt", os.path.join(fixture, "groundtruth.csv"), "--native-loader", "--out", traj,
            "--device", str(dev)]
    if overlays:
        argv += ["--overlay-every", str(DISK_OVERLAY_EVERY), "--overlay-dir", ov_dir]
    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    res = run_euroc.main(argv)
    torch.cuda.synchronize()
    by_thread = {k: fn.launches_by_thread() for k, fn in wrappers.items()}
    assert_no_jax()
    slam = res["slam"]
    good = [lg.good for lg in slam.logs]
    lost = [lg.frame for lg in slam.logs if not lg.good]
    n_kf = len(slam.mapper.map.keyframes)
    with open(traj) as f:
        rows = [ln for ln in f.read().splitlines() if ln.strip()]
    fps = res["frames"] / res["seconds"]
    say(f"disk: {fps:.3f} CLI frames/s (host clock, {res['frames']} frames); "
        f"{sum(good)}/{len(good)} frames good (lost {lost}; the JAX CPU run lost "
        f"{list(JAX_CPU_DISK_LOST)}); {n_kf} keyframes; "
        f"{slam.mapper.n_local_ba_applied} local BAs written back; keyframe ATE "
        f"{res['ate_rmse_m']:.6f} m (floor {DISK_ATE_FLOOR:.6f}, JAX CPU {JAX_CPU_DISK_ATE}) "
        f"on {smi}")
    stages = {k: v["mean_ms"] for k, v in res["stages"].items()}
    say(f"disk: loader decode {res['decode_ms']:.3f} ms per frame (worker threads, both "
        f"images); stage means (host clock, ms per frame): {stages} on {smi}")
    say(f"disk launches by thread: {by_thread}")
    if slam._map_errors:
        raise AssertionError(f"a worker thread raised: {slam._map_errors!r}")
    if len(good) != DISK_FRAMES - 1 or not set(lost) <= set(JAX_CPU_DISK_LOST):
        raise AssertionError(f"frames lost tracking: {lost} (the JAX run lost "
                             f"{list(JAX_CPU_DISK_LOST)})")
    if n_kf < 3:
        raise AssertionError(f"only {n_kf} keyframes")
    if slam.mapper.n_local_ba_applied < 1:
        raise AssertionError("no local BA was written back")
    if len(rows) != n_kf:
        raise AssertionError(f"{len(rows)} TUM rows for {n_kf} keyframes")
    if not res["ate_rmse_m"] <= DISK_ATE_FLOOR:
        raise AssertionError(f"keyframe ATE {res['ate_rmse_m']} above floor {DISK_ATE_FLOOR}")
    for k in KERNEL_WRAPPERS:
        if sum(by_thread[k].values()) <= 0:
            raise AssertionError(f"kernel {k} never launched on the disk path")
    marks = [DISK_OVERLAY_EVERY * k for k in range(1, (DISK_FRAMES - 1) // DISK_OVERLAY_EVERY + 1)]
    if overlays:
        pngs = sorted(n for n in os.listdir(ov_dir) if n.endswith(".png"))
        with open(os.path.join(ov_dir, "residuals.jsonl")) as f:
            frames = [json.loads(ln)["frame"] for ln in f]
        if pngs != [f"overlay_{k:06d}.png" for k in marks] or frames != marks:
            raise AssertionError(f"overlays {pngs}, residual records {frames}")
        say(f"disk: overlays and residual records of frames {frames}")
    else:
        check_diagnostics_on_card(dev, fixture, PLSLAMConfig.from_yaml(config), marks[:2], smi)
    maps_ms, remap_us = check_remap_on_card(dev, fixture, smi)
    assert_no_jax()
    return by_thread, fps, res["ate_rmse_m"], remap_us


def render_stream(seed: int, n_poses: int, scene_kw: dict) -> np.ndarray:
    """One phase-10 stream, (n_poses, 2, H, W) float32 left and right,
    rendered in pose order (the scene's noise stream runs in that order)."""
    from plslam_tpu_torch.io import SyntheticScene, circular_trajectory

    scene = SyntheticScene(seed=seed, **scene_kw)
    return np.stack([np.stack(scene.render_stereo(T, noise=1.0))
                     for T in circular_trajectory(n_poses, step_t=0.05)])


def start_batch_render():
    """Render phase 10's streams in spawned worker processes (rendering one
    752x480 pair takes ~0.8 s of host time) while the build and phase 9's
    fixture writer run; ``wait_batch_render`` collects them before phase 3,
    so no timed phase shares the host with them."""
    import concurrent.futures
    import multiprocessing

    n_poses = 1 + BATCH_WARMUP + BATCH_FRAMES
    pool = concurrent.futures.ProcessPoolExecutor(
        RENDER_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    return pool, [pool.submit(render_stream, s, n_poses, BATCH_SCENE)
                  for s in range(max(BATCH_SIZES))]


def wait_batch_render(job) -> list:
    pool, futures = job
    t = time.perf_counter()
    try:
        streams = [f.result(timeout=900) for f in futures]
    finally:
        pool.shutdown(cancel_futures=True)
    say(f"build: phase 10's {len(streams)} streams of {streams[0].shape[0]} pairs rendered "
        f"({RENDER_WORKERS} worker processes; waited {time.perf_counter() - t:.3f} s after "
        "the fixture)")
    return streams


def phase_batch(dev, smi, streams):
    """``BatchedVisualOdometry`` at scripts/bench_batch_vo.py's
    configuration: the B sweep (aggregate and per-stream frames/s, every
    frame of every stream good, the launches per frame), the per-stream ATE
    floors at BATCH_ATE_B, a step without host sync, and at BATCH_MATCH_B
    each stream against single-stream ``VisualOdometry`` on its frames.
    functorch's per-example fallback is off: a missing batching rule raises."""
    from torch._C import _functorch

    from plslam_tpu_torch.batch_vo import BatchedVisualOdometry
    from plslam_tpu_torch.core.camera import StereoCamera
    from plslam_tpu_torch.frontend.frame import FrontendConfig
    from plslam_tpu_torch.frontend.tracker import TrackerConfig
    from plslam_tpu_torch.io import SyntheticScene, ate_rmse, circular_trajectory
    from plslam_tpu_torch.vo import VisualOdometry

    sc = SyntheticScene(seed=0, **BATCH_SCENE)
    cam = StereoCamera.create(sc.fx, sc.fy, sc.cx, sc.cy, sc.b, width=sc.width,
                              height=sc.height)
    fcfg, tcfg = FrontendConfig(**BATCH_WIDTHS), TrackerConfig()
    n_poses = 1 + BATCH_WARMUP + BATCH_FRAMES
    gt = np.stack([T[:3, 3] for T in circular_trajectory(n_poses, step_t=0.05)])
    # every stream's frames staged on the card: (S, H, W) per pose and side
    L = [torch.from_numpy(np.ascontiguousarray(np.stack([st[i, 0] for st in streams]))).to(dev)
         for i in range(n_poses)]
    R = [torch.from_numpy(np.ascontiguousarray(np.stack([st[i, 1] for st in streams]))).to(dev)
         for i in range(n_poses)]
    torch.cuda.synchronize()
    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    rows, kept = {}, {}
    _functorch._set_vmap_fallback_enabled(False)
    try:
        for B in BATCH_SIZES:
            bvo = BatchedVisualOdometry(B, cam, fcfg, tcfg, device=dev)
            bvo.initialize(L[0][:B], R[0][:B])
            results = [bvo.process(L[i][:B], R[i][:B]) for i in range(1, BATCH_WARMUP + 1)]
            torch.cuda.synchronize()
            before = {k: fn.launches for k, fn in wrappers.items()}
            t0 = time.perf_counter()
            for i in range(BATCH_WARMUP + 1, n_poses):
                results.append(bvo.process(L[i][:B], R[i][:B]))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            per_frame = {k: (fn.launches - before[k]) / BATCH_FRAMES for k, fn in wrappers.items()}
            good = torch.stack([r.good for r in results]).cpu().numpy()    # (frames, B)
            agg = B * BATCH_FRAMES / dt
            row = dict(B=B, frames_per_s=agg, per_stream_frames_per_s=agg / B,
                       launches_per_frame=per_frame, good=int(good.sum()), frames=good.size)
            row["per_stream_vs_single"] = row["per_stream_frames_per_s"] / rows.get(
                BATCH_SIZES[0], row)["per_stream_frames_per_s"]
            rows[B] = row
            say(f"batch B={B}: {agg:.3f} aggregate frames/s, {agg / B:.3f} per stream "
                f"(per_stream_vs_single {row['per_stream_vs_single']:.3f}) over {BATCH_FRAMES} "
                f"timed frames; {int(good.sum())}/{good.size} stream-frames good; launches per "
                f"frame {per_frame} on {smi}")
            if not good.all():
                raise AssertionError(f"B={B}: frames lost tracking (frame, stream): "
                                     f"{np.argwhere(~good).tolist()}")
            for k in KERNEL_WRAPPERS:
                if per_frame[k] != BATCH_LAUNCHES[k]:
                    raise AssertionError(f"B={B}: {k} launched {per_frame[k]} times per frame, "
                                         f"want {BATCH_LAUNCHES[k]} at every B")
            if B == BATCH_ATE_B:
                # the batched step keeps its state on the card: one more step
                # (repeating the last frame) under sync-debug "error"
                torch.cuda.set_sync_debug_mode("error")
                bvo.process(L[-1][:B], R[-1][:B])
                torch.cuda.set_sync_debug_mode(0)
                say(f"batch B={B}: a step made no host sync (sync debug mode 'error')")
                kept["ate"] = results
            if B == BATCH_MATCH_B:
                kept["match"] = results
        launches = {k: fn.launches for k, fn in wrappers.items()}
    finally:
        torch.cuda.set_sync_debug_mode(0)
        _functorch._set_vmap_fallback_enabled(True)

    ates = []
    for b in range(BATCH_ATE_B):
        est = np.stack([np.zeros(3)] + [r.T_f_w[b, :3, 3].cpu().numpy() for r in kept["ate"]])
        ates.append(ate_rmse(est, gt, align=False))
    floors = [max(2.0 * j, 0.01) for j in JAX_CPU_BATCH_ATE]
    say(f"batch B={BATCH_ATE_B}: per-stream ATE {[round(a, 6) for a in ates]} m (floors "
        f"{[round(f, 6) for f in floors]}, JAX CPU {list(JAX_CPU_BATCH_ATE)})")
    for b, (a, f) in enumerate(zip(ates, floors)):
        if not a <= f:
            raise AssertionError(f"stream {b}: ATE {a} above floor {f}")

    # each stream of the BATCH_MATCH_B run against single-stream VO on its frames
    for b in range(BATCH_MATCH_B):
        vo = VisualOdometry(cam, fcfg, tcfg, device=dev)
        vo.initialize(L[0][b], R[0][b])
        single = [vo.process(L[i][b], R[i][b]) for i in range(1, n_poses)]
        pairs = list(zip(kept["match"], single))
        good_eq = all(bool(rb.good[b]) == bool(rs.good) for rb, rs in pairs)
        dT = max(float((rb.T_f_w[b] - rs.T_f_w).abs().max()) for rb, rs in pairs)
        dn = max(abs(int(rb.n_inliers[b]) - int(rs.n_inliers)) for rb, rs in pairs)
        bitwise = all(torch.equal(rb.T_f_w[b], rs.T_f_w) for rb, rs in pairs)
        say(f"batch B={BATCH_MATCH_B} stream {b} vs single-stream VO: good equal {good_eq}, max "
            f"|T_f_w diff| {dT:.3g}, max |inlier diff| {dn}, bitwise {bitwise}")
        if not (good_eq and dT <= 2e-2 and dn <= 6):
            raise AssertionError(f"stream {b} departs from single-stream VO: good {good_eq}, "
                                 f"dT {dT}, inliers {dn}")
    return launches, rows, ates


def render_depth(scene, T_w_c) -> np.ndarray:
    """numpy copy of tests/test_rgbd.render_depth: the depth map matching
    the rendered intensity image (z of the nearest splat; background far)."""
    T_c_w = np.linalg.inv(T_w_c)
    depth = np.full((scene.height, scene.width), 50.0, np.float32)
    for X in np.concatenate([scene.P, scene.LA, scene.LB]):
        Xc = T_c_w[:3, :3] @ X + T_c_w[:3, 3]
        if Xc[2] <= 0.3:
            continue
        u = scene.cx + scene.fx * Xc[0] / Xc[2]
        v = scene.cy + scene.fy * Xc[1] / Xc[2]
        x0, y0 = int(round(u)), int(round(v))
        if 3 <= x0 < scene.width - 3 and 3 <= y0 < scene.height - 3:
            depth[y0 - 3:y0 + 4, x0 - 3:x0 + 4] = np.minimum(
                depth[y0 - 3:y0 + 4, x0 - 3:x0 + 4], Xc[2])
    for A, B in zip(scene.LA, scene.LB):
        for t in np.linspace(0, 1, 200):
            X = A + t * (B - A)
            Xc = T_c_w[:3, :3] @ X + T_c_w[:3, 3]
            if Xc[2] <= 0.3:
                continue
            u = scene.cx + scene.fx * Xc[0] / Xc[2]
            v = scene.cy + scene.fy * Xc[1] / Xc[2]
            x0, y0 = int(round(u)), int(round(v))
            if 2 <= x0 < scene.width - 2 and 2 <= y0 < scene.height - 2:
                depth[y0 - 2:y0 + 3, x0 - 2:x0 + 3] = np.minimum(
                    depth[y0 - 2:y0 + 3, x0 - 2:x0 + 3], Xc[2])
    return depth


def phase_rgbd(dev, smi):
    """tests/test_rgbd.py's two-frame RGB-D track on the card: extraction
    through the FAST and patch kernels, f2f, the point-only pose solve."""
    from plslam_tpu_torch.core import lie
    from plslam_tpu_torch.core.camera import StereoCamera
    from plslam_tpu_torch.frontend import f2f
    from plslam_tpu_torch.frontend.frame import FrontendConfig
    from plslam_tpu_torch.frontend.rgbd import extract_rgbd_features
    from plslam_tpu_torch.frontend.tracker import TrackerConfig, optimize_pose
    from plslam_tpu_torch.io import SyntheticScene

    scene = SyntheticScene(seed=13)
    cam = StereoCamera.create(scene.fx, scene.fy, scene.cx, scene.cy, scene.b,
                              width=scene.width, height=scene.height)
    cfg = FrontendConfig(n_points=512, n_lines=64, fast_th=15.0)
    T1 = lie.exp_se3(torch.tensor(RGBD_XI, dtype=torch.float64)).numpy()
    imgs = [(scene.render_stereo(T)[0], render_depth(scene, T)) for T in (np.eye(4), T1)]
    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    f0, f1 = (extract_rgbd_features(torch.from_numpy(il).to(dev), torch.from_numpy(d).to(dev),
                                    cam, cfg, max_depth=30.0) for il, d in imgs)
    pts, ls, _, _ = f2f.track_frame_to_frame(f0, f1)
    est, _, _ = optimize_pose(pts, ls, cam, TrackerConfig(use_lines=False))
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in wrappers.items()}
    err = float(np.abs(est.DT.cpu().numpy() - np.linalg.inv(T1))[:3, 3].max())
    n_pts = int(f0.points.valid.sum())
    say(f"rgbd: two-frame track, translation error {err:.6f} m (limit 0.02), {n_pts} points "
        f"with depth on frame 0, good {bool(est.good)}; launches {launches} on {smi}")
    if not (bool(est.good) and err < 0.02 and n_pts > 80):
        raise AssertionError(f"RGB-D track: good {bool(est.good)}, error {err}, points {n_pts}")
    for k in KERNEL_WRAPPERS:
        if k != "hamming_distance_matrix_cuda" and launches[k] <= 0:
            raise AssertionError(f"kernel {k} never launched on the RGB-D path")
    return launches, err


def assert_no_jax() -> None:
    """The port imports nothing of JAX or of the JAX package."""
    bad = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "plslam_tpu"))
    if bad:
        raise AssertionError(f"modules of JAX or of the JAX package were imported: {bad}")


def main(argv=()) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", action="store_true",
                    help="stop after phase 3 and print its kernel summary")
    args = ap.parse_args(argv)
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

    fixture = writer = render = None
    if not args.kernels:
        fixture = tempfile.mkdtemp(prefix="chip_smoke_disk_")
        writer = start_disk_fixture(fixture)
        render = start_batch_render()
    try:
        return run_phases(args, dev, smi, kind, fixture, writer, render)
    finally:
        if writer is not None and writer.poll() is None:
            writer.kill()
            writer.wait()
        if render is not None:
            render[0].shutdown(cancel_futures=True)
        if fixture is not None:
            shutil.rmtree(fixture, ignore_errors=True)


def run_phases(args, dev, smi, kind, fixture, writer, render=None) -> int:
    from plslam_tpu_torch.io import SyntheticScene, circular_trajectory
    from plslam_tpu_torch.ops import cuda_lib
    from plslam_tpu_torch.ops.image import build_pyramid

    assert_no_jax()
    build = cuda_lib.load()
    say(f"build: {build.seconds:.2f} s -> {build.path.name}")
    for line in build.log.splitlines():
        if "Used" in line or "spill" in line:
            say(f"  ptxas: {line.strip()}")
    if writer is not None:
        wait_disk_fixture(writer)
    streams = wait_batch_render(render) if render is not None else None

    # bench.py's configuration, frames staged on the device
    scene = SyntheticScene(n_points=600, n_lines=60, seed=0, width=752, height=480,
                           fx=435.2, fy=435.2, cx=367.4, cy=252.2)
    poses = circular_trajectory(1 + N_WARMUP + N_FRAMES, step_t=0.05)
    frames = [tuple(torch.from_numpy(x).to(dev) for x in scene.render_stereo(T, noise=1.0))
              for T in poses]
    pair = torch.stack(frames[0])
    levels = build_pyramid(pair, 4, 1.2)

    flat = None
    if streams is not None:
        # a batched frame at the sweep's largest B: frame 0 of every stream,
        # (2B, H, W) as BatchedVisualOdometry stacks it
        flat = torch.from_numpy(np.stack([st[0] for st in streams]).reshape(
            (-1,) + streams[0].shape[2:])).to(dev)
    report = phase_kernels(dev, levels, pair, smi, flat)
    del flat
    if args.kernels:
        assert_no_jax()
        say(json.dumps({"kernels": report}))
        return 0
    launches, fps, ate = phase_main_path(dev, scene, poses, frames)
    slam_launches, slam_fps, slam_ate = phase_slam(dev, scene, smi)
    lm_ips = phase_local_ba(dev, smi)
    ep_launches, ep_fps, ep_ate = phase_endpoint_slam(dev, scene, smi)
    loop_launches, loop_kf_s = phase_loop_closure(dev, smi)
    disk_launches, disk_fps, disk_ate, remap_us = phase_disk(dev, smi, fixture)
    batch_launches, batch_rows, batch_ates = phase_batch(dev, smi, streams)
    rgbd_launches, rgbd_err = phase_rgbd(dev, smi)
    for k in report:
        by_thread = {"slam": slam_launches[k["name"]], "slam_endpoint": ep_launches[k["name"]],
                     "loop": loop_launches[k["name"]], "disk": disk_launches[k["name"]]}
        by_path = {"vo": launches[k["name"]], **by_thread, "batch": batch_launches[k["name"]],
                   "rgbd": rgbd_launches[k["name"]]}
        k["launches"] = (by_path["vo"] + by_path["batch"] + by_path["rgbd"]
                         + sum(sum(v.values()) for v in by_thread.values()))
        k["launches_by_path"] = by_path
    assert_no_jax()
    say(f"main path: {fps:.3f} frames/s, ATE {ate:.6f} m on {smi}")
    say(f"slam path: {slam_fps:.3f} frames/s, keyframe ATE {slam_ate:.6f} m; local BA "
        f"{lm_ips:.3f} LM iterations/s on {smi}")
    say(f"endpoint slam path: {ep_fps:.3f} frames/s, keyframe ATE {ep_ate:.6f} m; loop "
        f"replay {loop_kf_s:.3f} keyframes/s on {smi}")
    say(f"disk path: {disk_fps:.3f} CLI frames/s, keyframe ATE {disk_ate:.6f} m; device remap "
        f"{remap_us:.3f} us per pair on {smi}")
    fps_by_b = {B: round(r["frames_per_s"], 3) for B, r in batch_rows.items()}
    say(f"batch path: aggregate frames/s by B {fps_by_b}, B={BATCH_ATE_B} ATEs "
        f"{[round(a, 6) for a in batch_ates]} m; RGB-D track error {rgbd_err:.6f} m on {smi}")
    say(json.dumps({"batch_vo": list(batch_rows.values())}))
    say(json.dumps({"kernels": report}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
