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
     1200 points, 256 line slots) on the synthetic scene, its step one
     CUDA graph (``prewarm``, then one replay per frame): every frame must
     track, ATE must stay under the floor, 2 / 4 / 4 patch / FAST / Hamming
     launches per frame through the replays' accounting, one replay and
     one graph launch per frame, no host sync in a graphed step, every
     frame's ``T_f_w`` bit-identical to the same step with
     ``capture=False``; frames/s of both forms in interleaved windows from
     the state after the warm-up frames and of one more graphed window in
     the first loop's form, each with the card's SM clock and power draw
     at its end, and whether the graphed windows' frames equal the first
     loop's; a profile of each form (device busy, device kernels and host
     CUDA calls per frame); the ms of the eager ``initialize``;
  5. SLAM path: ``PLSLAM`` at bench_slam.py's configuration (tracking, the
     mapping worker thread, deferred local BA, chunked GBA at finish),
     the tracker, the fused association and the local BA graphed, beside
     the same run eagerly: for both, every frame good, >= 8 keyframes, a
     local BA written back, finite GBA poses, keyframe ATE under the
     floor, the keyframe trajectories bit-identical; the graphed run's
     association and local-BA programs captured and the Hamming kernel
     launched from the mapping thread; local-BA ms per solve of both; per
     program kind captures, replays and pool bytes; the mapping thread's
     keyframes replayed serially on a fresh mapper of each form under the
     profiler (host CUDA calls, graph launches, device kernels and ms per
     keyframe); a third, graphed run's timed frames under the profiler
     (device busy, kernels per frame, the kernels taking the most time);
     the GBA at finish of both forms: wall ms, its trips run eagerly (the
     capture's warm-ups) and by replay of the one captured LM trip (all
     but the 2 warm-ups of 15 graphed, none eager), the trip graph's pool
     bytes, and a rerun on a copy of the map it met under the profiler
     (device-busy ms, kernels, host CUDA calls) that must leave the same
     poses;
  6. local BA: LM iterations/s of ``lm_rounds`` (f32, K=8, P=512, L=64),
     eager and as one CUDA graph; the graphed iterates and the graphed
     ``bundle_adjust`` bit for bit the eager ones;
  7. endpoint SLAM from images: phase 5's configuration with endpoint
     lines, loop closure (the shipped DBoW2 vocabularies) and the keyframe
     pose refinement, graphed beside eager; for both every frame good,
     >= 8 keyframes, a local BA written back, every keyframe BoW-encoded,
     no loop (20 frames lie under ``lc_kf_dist``), keyframe ATE under the
     floor; the Hamming kernel launched from the mapping thread; the split
     association (KF2KF, Map2KF), the refinement and the BoW transform
     captured; phase 5's program counts, mapping profile and GBA report;
  8. loop closure at reference scale: the 156-keyframe ring replay of
     tests/test_scale_e2e.py through ``insert_keyframe_features`` (drifted
     odometry, ``lc_kf_dist=50``, online vocabulary), graphed beside eager,
     each: a closure against the KF-0 region, no false loop, ATE and
     closure-keyframe error below the odometry's, real fusion, a
     multi-chunk endpoint GBA at finish, the Hamming kernel launched from
     the loop-closure thread; keyframes/s and per program kind captures,
     replays and pool bytes; the association, local-BA and BoW programs
     captured; the GBA's ms and trips, each closure's PGO ms and
     iterations run eagerly and by replay (graphed: all but the 2
     warm-ups of 25), every candidate's verification ms and the pose
     solve's captures and replays per capture (graphed: every solve a
     replay; eager: none); the two runs' keyframe trajectories bit for
     bit unless their closures corrected maps of different keyframes
     (the loop closer corrects the map it finds when its verification
     ends, so the threads' timing moves the result); on the same maps a
     difference fails unless a second eager run differs from the first too;
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
     worker processes during phase 2) for B in 1, 2, 4, 8, 16, its step
     one CUDA graph per B: aggregate and per-stream frames/s of the
     graphed step beside the eager one, every frame's ``T_f_w``
     bit-identical between the two, every frame of every stream good, 4
     FAST / 2 patch / 4 Hamming launches per graphed frame at every B, no
     host sync, no vmap fallback; at B = 4 each stream's ATE under max(2x the JAX
     package's CPU value, 0.01 m); at B = 2 each stream against
     single-stream ``VisualOdometry``; then tests/test_rgbd.py's two-frame
     RGB-D track (error under 0.02 m, the FAST and patch kernels launched);
 11. distribution: a process group of one rank (NCCL, a FileStore in a
     temporary directory), a 1-D and a (1, 1) ("dcn", "ici") mesh, and the
     JAX package's multichip dry run at its sizes: landmark-sharded BA
     (K=32, P=4096, L=512, 6-keyframe windows, 2 trips; 1-axis and 2-axis)
     against ``lm_rounds``, the sharded matcher (Q=1280, all rows valid and
     5% masked) equal to the single-device matcher, the edge-sharded PGO
     (256 poses, 5 iterations) against ``pgo.optimize``, the kf-block GBA
     (1-axis and 2-axis) on the 32-keyframe ring map bit-identical to the
     chunked GBA run in this process on the same partition, and against
     the single-device GBA (both errors fall, points within
     max(1.5x, 0.01 m)); the chunked GBA at 2 and 4 chunks in float32 and
     float64 (f64 must not move with the split); and
     ``BatchedVisualOdometry(4, sharding=)`` on phase 10's first 4 streams
     bit-identical to the unsharded batch, 4 / 2 / 4 launches per frame.
     tests/test_torch_gpu_dist.py runs this phase over every card of a
     machine with more than one, one NCCL rank each;
 12. evaluation: the port of the JAX package's evaluation programs, each
     through its ``main`` in this process at its default device, held
     against the JAX package's CPU values (scripts/jax_eval_reference.py):
     ``e2e_robust`` at 752x480 in both line modes with the depth cut to 48
     nuisance frames (rendered in worker processes during phase 2; each
     mode through ``run_mode``; keyframe ATE under max(2x JAX's largest
     over six nuisance draws, 0.01 m), good frames within 5% of N, every
     kernel launched, Hamming from the mapping thread; the endpoint -
     Plücker gap), ``evaluate_ate`` on its Plücker
     dump (= ``io/trajectory.ate_rmse`` to 1e-6), ``compare_line_modes``
     (30 frames, both modes, ATE under max(2x JAX's, 0.01 m)),
     ``line_match_quality`` (eight rows: the wrong rate within 1.0
     percentage point, the correct count within 2%), ``endpoint_gba_ab``
     (both f32 GBAs under the error before them, the Plücker GBA under
     1.39x JAX's point error, the endpoint GBA within max(10%, 5e-4 m) of
     JAX's, the f64 oracle's iterations equal, its last cost and median point
     error to 1e-6 relative), the 190-keyframe ``loop_stress``
     (tests/test_loop_stress.py's properties, Hamming from the
     loop-closure thread, no more local BAs discarded by the divergence
     guard than JAX's test on the CPU: one, the corridor's first
     keyframe) and ``train_vocabulary`` at 1 scene x 2 frames
     (the files load back); plots only where matplotlib is installed;
 13. bench twins: each benchmark twin's ``run`` in this process on frames
     already staged (no rendering), its JSON lines printed:
     ``plslam_tpu_torch.bench`` on phase 4's 24 frames (every frame of its
     3 windows good, the best window's count equal to bench.py's on the
     CPU, 2 / 4 / 4 patch / FAST / Hamming launches per timed frame),
     ``bench_slam`` on phase 5's 20 (keyframes within 1 of bench_slam.py's
     on the CPU, the program captures inside its timed window and the
     allocator cache releases before them, the LM cost
     after 10 trips under 1e-3 of the start), ``bench_batch_vo`` on phase
     10's 16 streams (every timed frame of every stream good at every B,
     the launches per frame) and ``bench_dist_gba`` at N_KF 128 over one
     NCCL rank per visible card (the error before the GBA equal to the JAX
     script's to 1e-6 m, its chunk count, every form's point error under
     the error before it and the mesh forms' within max(1.5x, 0.01 m) of
     the single-device GBA's); all three kernels launched;
 14. measurement programs and the demo, at full width, each graphed and
     held bit for bit against its ``capture=False`` form:
     ``plslam_tpu_torch.roofline`` (every program's ms, device-busy ms,
     counted work and bound finite, its table and JSON line printed),
     ``profile_detect`` (every row), ``ab_fused_step`` at 2 rounds on phase
     4's frames (every timed frame of both GN forms good, each form's last
     window equal to the same window run eagerly, its ATE under phase 4's
     floor; each window's SM clock and power draw), ``profile_mapping`` on
     phase 4's first 15 frames (the graphed map's keyframe poses equal to
     the eager map's) and a 20-frame ``demo_synthetic`` (every frame good,
     keyframe ATE under max(2x the JAX demo's on the CPU, 0.01 m), the
     artifacts written, the graphed keyframe trajectory equal to the eager
     one's); all three kernels launched.  It meets the earlier phases'
     reserve (~74 GiB) as it is: a capture that does not fit beside it
     has ``graphs.Program`` empty the allocator's cache first.
Phase 4 runs the VO graphed and eagerly over its frames and phase 6
``lm_rounds`` six times eagerly and five times graphed on one problem:
both must repeat bit for bit.  After phases 4, 5, 7, 9, 10, 12, 13 and 14 a line
gives the process's CUDA graphs: captures, replays, the graphs alive with
their pools' bytes, the allocator cache releases before a capture (in
all and in the phase), and the card's memory allocated, reserved and
free; phases 4-7 of this fresh process must release nothing.  Phase 3 also
times the batched Hamming launch at (B, 1200, 8)^2 and (B, 256, 8)^2.
Then come the summary lines, the kernel summary as one JSON line, and the
result as the last line.  Any failure raises and exits non-zero, and so
does an import of JAX or of the JAX package (``plslam_tpu``).
"""

import argparse
import copy
import gc
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

from plslam_tpu_torch.roofline import (F32_ADD_PER_S, F32_MINMAX_PER_S,  # noqa: F401
                                       FAST_CANDIDATE_OPS, FAST_PX_OPS, INT8_OPS_PER_S, bound,
                                       fast_bytes, fast_ops, hamming_work, patches_bytes)

# ATE (m, no alignment, all 24 poses) of the JAX package's VisualOdometry
# on the same 24 frames, run on CPU; the port must stay within 2x of it.
JAX_CPU_ATE = 0.03175965853455335
ATE_FLOOR = max(2.0 * JAX_CPU_ATE, 0.01)

N_WARMUP = 3
N_FRAMES = 20
VO_WINDOWS = 2        # interleaved graphed / eager windows of the N_FRAMES frames
PROFILE_FRAMES = 5    # frames of each form under torch.profiler

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
# phases 5 and 7 replay the mapping thread's keyframes serially and profile
# all but the first MAP_PROFILE_SKIP of them (whose calls capture most
# programs)
MAP_PROFILE_SKIP = 3
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
# launches per VO frame, and per batched frame whatever B is
FRAME_LAUNCHES = {"fast_score_nms_batch": 4, "gather_patches_batch": 2,
                  "hamming_distance_matrix_cuda": 4}
RENDER_WORKERS = 8
# tests/test_rgbd.py's two-frame RGB-D scenario
RGBD_XI = (0.02, -0.01, 0.1, 0.005, -0.008, 0.01)

# Phase 11: the JAX package's multichip dry run (__graft_entry__.py
# dryrun_multichip) at its sizes: landmark-sharded BA (K poses, P points, L
# lines, each seen from an obs_k-keyframe window; `iters` LM trips), the
# sharded matcher (q queries; a variant with `masked` of the rows masked),
# the edge-sharded PGO (pgo_k poses, pgo_iters trips), the kf-block GBA on
# the ring map, then BatchedVisualOdometry(b, sharding=) on phase 10's first
# b streams over `frames` frames.  World 1 here; tests/test_torch_gpu_dist.py
# runs the phase over every card of the machine.
DIST = dict(ba=dict(K=32, P=4096, L=512, obs_k=6), iters=2, q=1280, masked=0.05, pgo_k=256,
            pgo_iters=5, ring=dict(rng_seed=3, n_kf=32, n_pts=4096, n_ls=512, pose_noise=0.01,
                                   lm_noise=0.03),
            b=4, frames=4, scene=BATCH_SCENE, widths=BATCH_WIDTHS)

# Phase 12: the evaluation path (the port of the JAX package's evaluation
# programs) in-process: e2e_robust's run_mode per line mode, each other
# module's main.  The JAX CPU values are those of
# scripts/jax_eval_reference.py {e2e 48,compare,lmq,gba,gba-seeds} and, for
# the spread of the nuisance ATE, scripts/e2e_mode_divergence.py.
# e2e_robust at full width with the depth cut to EVAL_FRAMES frames: per
# mode (good frames, keyframes, keyframe ATE m of this run's nuisance draw,
# the largest keyframe ATE m over six draws at N = 48); the port must keep
# every frame but 5% of N that JAX keeps, and its ATE under max(2x that
# largest ATE, 0.01 m).  The ATE is chaotic in the nuisance draw on both
# sides: over this draw and the draws of --noise-seed 1-5
# (scripts/e2e_mode_divergence.py run jax|torch MODE 48, a CPU, one thread)
# JAX's endpoint ATE is 0.0090 / 0.0233 / 0.0145 / 0.0062 / 0.0157 /
# 0.0109 m and the port's 0.0333 / 0.0059 / 0.0121 / 0.0113 / 0.0261 /
# 0.0146 m; Plücker, JAX 0.0181 / 0.0040 / 0.0220 / 0.0105 / 0.0188 /
# 0.0210 m, the port 0.0259 / 0.0062 / 0.0147 / 0.0120 / 0.0138 / 0.0274 m.
EVAL_FRAMES = 48
JAX_CPU_E2E = {"plucker": (47, 12, 0.01807218508547855, 0.022040719599415688),
               "endpoint": (47, 12, 0.008977076076091097, 0.023334326469678014)}
# compare_line_modes: each mode's aligned keyframe ATE (m), 30 frames
JAX_CPU_COMPARE = {"endpoint": 0.049063676866237256, "plucker": 0.06483893442144012}
# line_match_quality: (label, matches, correct) of the eight rows; per row
# the wrong rate within 1.0 percentage point and the correct count within 2%
JAX_CPU_LMQ = (("baseline (full-segment)", 578, 528), ("PRODUCTION (+twoway 25px)", 547, 528),
               ("baseline oneside", 578, 528), ("baseline midpoint", 589, 535),
               ("long-lines full-segment", 983, 836), ("long-lines +twoway 25px", 880, 836),
               ("long-lines oneside", 983, 836), ("long-lines midpoint", 1006, 852))
# endpoint_gba_ab: median point errors (m) of (a) and (b) and the f64
# oracle's iterations (equal), last cost and median point error (1e-6
# relative).  Both f32 GBAs must end under the error before them.  (a), the
# Plücker GBA, under GBA_PLUCKER_RATIO x JAX's: the largest port/JAX ratio
# over the ring's seeds 1-7 on the CPU, 1.29 (seed 3, this ring: 0.006309
# against 0.004888 m; seeds 1, 2, 4-7 0.94-1.18; scripts/jax_eval_reference.py
# gba-seeds), plus a margin of 0.10.  (b), the endpoint GBA, within
# max(10%, 5e-4 m) of JAX's: on the card it reads 0.006250 m, the same to the
# digit in every run; on the CPU its f32 outcome is chaotic on both sides
# (seed 3: the port 0.047 m; seed 6: JAX 0.078, the port 0.18 m).
GBA_PLUCKER_RATIO = 1.29 + 0.10
JAX_CPU_GBA = {"ours_plucker": 0.004888185405764885, "ours_endpoint": 0.006422390450644931,
               "oracle_pt": 0.005751876630915977, "oracle_last": 1.5451575653142723e-08,
               "oracle_iters": 40}
# loop_stress: the local BAs the divergence guard (MapConfig.lba_max_jump)
# throws out.  The JAX package's tests/test_loop_stress.py on the CPU logs
# one, "local BA discarded: max pose jump 63.48 m": the corridor's first
# keyframe (100), whose window [98, 99, 100] pulls it 60 m back towards
# ring A (63.483711 m unrounded, the pose jump read in the same run).  The
# port may discard no more than JAX.
JAX_CPU_STRESS_DISCARDS = [63.483711]
VOCAB_SCENES, VOCAB_FRAMES = 1, 2

# Phase 13: the benchmark twins (plslam_tpu_torch.bench, bench_slam,
# bench_batch_vo, bench_dist_gba) through their ``run`` on the frames of
# phases 4, 5 and 10, held against the unedited JAX programs run on the CPU:
# bench.py's good frames of its best window (its standard error:
# good_frames=20/20), bench_slam.py's keyframes ("# keyframes mapped during
# bench: 10"; the port may map one more or one less: the mapping thread's
# pace decides whether the last keyframe is in by the end of the window), and
# scripts/jax_bench_reference.py's values of scripts/bench_dist_gba.py's ring
# map at N_KF 128: the median point error before the GBA (to 1e-6 m) and the
# kf-block GBA's chunk count on a mesh of 1, 2, 4 or 8 devices.
JAX_CPU_BENCH_GOOD = 20
JAX_CPU_BENCH_SLAM_KF = 10
JAX_CPU_DIST_GBA_PRE = 0.04611433123828923
JAX_CPU_DIST_GBA_CHUNKS = {1: 4, 2: 4, 4: 4, 8: 8}

# Phase 14: the measurement programs and the demo (plslam_tpu_torch.roofline,
# profile_detect, ab_fused_step, profile_mapping, demo_synthetic).  The JAX
# package's examples/demo_synthetic.py 20 on the CPU: 10 keyframes, keyframe
# ATE (aligned) 0.04127278800852883 m, from its trajectory.txt.
AB_ROUNDS = 2
DEMO_FRAMES = 20
JAX_CPU_DEMO_ATE = 0.04127278800852883
JAX_CPU_DEMO_KF = 10
DEMO_ATE_FLOOR = max(2.0 * JAX_CPU_DEMO_ATE, 0.01)

# Phase 3's timing.  Device time: TIMED_LAUNCHES back-to-back calls,
# captured once in a CUDA graph and replayed between two CUDA events.
TIMED_LAUNCHES = 100
GRAPH_REPLAYS = 5
PLAIN_REPS = 10
# The H100's published peaks (HBM_BYTES_PER_S, INT8_OPS_PER_S, F32_OPS_PER_S
# and the f32 add and min/max rates), ``bound`` and the kernels' work
# formulas (FAST's operations counted on the data) are the package's
# (plslam_tpu_torch/roofline.py), which its roofline program uses too.
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
        nbytes = patches_bytes(imgs, y0, P)
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
            row = time_shape(tuple(imgs.shape),
                             lambda: cuda_fast.fast_score_nms_batch(imgs, thr),
                             lambda: cuda_fast.fast_score_nms_plain(imgs, thr), {},
                             fast_bytes(imgs, thr), *fast_ops(imgs, thr),
                             launches=TIMED_LAUNCHES if stack is pair else 20)
            # the kernel's work depends on the data: noise makes most pixels candidates
            row["device_ms_noise"] = graph_ms(
                lambda: cuda_fast.fast_score_nms_batch(noise, thr),
                TIMED_LAUNCHES if stack is pair else 20)
            row["bound_ms_noise"] = bound(fast_bytes(noise, thr), *fast_ops(noise, thr))[0]
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
        nbytes, ops = hamming_work(d1, d2)
        row = time_shape((n1, n2), lambda: cuda_hamming.hamming_distance_matrix_cuda(d1, d2),
                         lambda: cuda_hamming.hamming_plain(d1, d2), hamming_library(d1, d2),
                         nbytes, (ops, INT8_OPS_PER_S))
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
            nbytes, ops = hamming_work(d1, d2)
            row = time_shape((B, n, n), lambda: cuda_hamming.hamming_distance_matrix_cuda(d1, d2),
                             lambda: cuda_hamming.hamming_plain(d1, d2), hamming_library(d1, d2),
                             nbytes, (ops, INT8_OPS_PER_S))
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
    from plslam_tpu_torch.bench import KERNELS

    return KERNELS


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The same bits (a NaN equals a NaN of the same bits)."""
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def results_equal(a, b) -> bool:
    """Two results (NamedTuples of tensors) bit for bit, field by field."""
    return all(bits_equal(x, y) for x, y in zip(a, b))


def phase_main_path(dev, scene, poses, frames, smi):
    """VisualOdometry through the kernels at the bench configuration: the
    graphed step (one CUDA-graph replay per frame) against the same step
    with ``capture=False``."""
    from plslam_tpu_torch.ab_fused_step import clocks as ab_clocks
    from plslam_tpu_torch.core.camera import StereoCamera
    from plslam_tpu_torch.frontend.frame import FrontendConfig
    from plslam_tpu_torch.frontend.tracker import TrackerConfig
    from plslam_tpu_torch.io import ate_rmse
    from plslam_tpu_torch.profile_vo import profile_window
    from plslam_tpu_torch.vo import VisualOdometry

    wrappers = _wrappers()
    cam = StereoCamera.create(scene.fx, scene.fy, scene.cx, scene.cy, scene.b,
                              width=scene.width, height=scene.height)
    fcfg, tcfg = FrontendConfig(n_points=1200, n_lines=256), TrackerConfig()
    vo = VisualOdometry(cam, fcfg, tcfg, device=dev)
    eager = VisualOdometry(cam, fcfg, tcfg, device=dev, capture=False)

    for fn in wrappers.values():
        fn.launches = 0
    t = time.perf_counter()
    vo.prewarm(frames[0][0].shape, progress=lambda m: say(f"main path prewarm: {m}"))
    _sync(dev)
    capture_s = time.perf_counter() - t
    prog = vo.programs()[0]
    t = time.perf_counter()
    vo.initialize(*frames[0])
    _sync(dev)
    init_ms = 1e3 * (time.perf_counter() - t)
    results = [vo.process(*frames[i]) for i in range(1, N_WARMUP + 1)]
    _sync(dev)
    warm_state = vo.state
    before = {k: fn.launches for k, fn in wrappers.items()}
    replays = prog.replays
    t0 = time.perf_counter()
    for i in range(N_WARMUP + 1, N_WARMUP + 1 + N_FRAMES):
        results.append(vo.process(*frames[i]))
    _sync(dev)
    dt = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    replays = prog.replays - replays

    # the graphed step keeps its state on the card: one more step
    # (repeating the last frame) under sync-debug "error" raises on any
    # host sync
    torch.cuda.set_sync_debug_mode("error")
    vo.process(*frames[-1])
    torch.cuda.set_sync_debug_mode(0)
    say("main path: a graphed step made no host sync (sync debug mode 'error')")

    # the graphed step against the same step run eagerly, frame by frame
    eager.initialize(*frames[0])
    ref = [eager.process(*frames[i]) for i in range(1, len(results) + 1)]
    same = [bits_equal(a.T_f_w, b.T_f_w) for a, b in zip(results, ref)]
    every = sum(results_equal(a, b) for a, b in zip(results, ref))
    diff = max(float((a.T_f_w - b.T_f_w).abs().max()) for a, b in zip(results, ref))
    say(f"main path graphed vs eager: {sum(same)}/{len(same)} frames' T_f_w bit-identical, "
        f"{every}/{len(same)} frames' every result field (max |T_f_w diff| {diff:.3g})")
    if not all(same):
        raise AssertionError(f"the graphed VO step departs from the eager one: frames {same}")

    # frames/s of both forms in interleaved windows over the timed frames,
    # each from the state after the warm-up frames; then the graphed step
    # in the first loop's form (initialize, the warm-up frames, the timed
    # frames) once more; the card's SM clock and power draw after each
    # window, and whether each graphed form's frames equal the first loop's
    timed = frames[N_WARMUP + 1:N_WARMUP + 1 + N_FRAMES]
    fps = {"graphed": [], "eager": [], "graphed_init": []}
    clocks, same_form = [], {}
    for name in ("graphed", "eager") * VO_WINDOWS + ("graphed_init",):
        v = vo if name != "eager" else eager
        if name == "graphed_init":
            v.initialize(*frames[0])
            for i in range(1, N_WARMUP + 1):
                v.process(*frames[i])
        else:
            v.state = warm_state
        _sync(dev)
        t = time.perf_counter()
        out = [v.process(*f) for f in timed]
        _sync(dev)
        fps[name].append(len(timed) / (time.perf_counter() - t))
        clocks.append(f"{name} {fps[name][-1]:.3f} [{ab_clocks(dev)}]")
        if name != "eager":
            same_form[name] = all(results_equal(a, b) for a, b in zip(out, results[N_WARMUP:]))
        del out
    prof = {}
    for name, v in (("graphed", vo), ("eager", eager)):
        v.state = warm_state
        w = profile_window(lambda i, v=v: v.process(*timed[i]), PROFILE_FRAMES)
        prof[name] = {k: w[k] for k in ("wall_ms", "busy_ms", "busy_share", "kernels",
                                         "host_cuda_calls", "graph_launches")}
        say(f"main path profile {name} ({PROFILE_FRAMES} frames): wall {w['wall_ms']:.3f} "
            f"ms/frame, device busy {w['busy_ms']:.3f} ms/frame ({100 * w['busy_share']:.2f}% "
            f"of wall), {w['kernels']:.1f} device kernels/frame, {w['host_cuda_calls']:.1f} "
            f"host CUDA calls/frame, {w['graph_launches']:.1f} graph launches/frame on {smi}")
    say(f"main path frames/s in interleaved windows of {len(timed)} frames: graphed "
        f"{[round(x, 3) for x in fps['graphed']]}, eager {[round(x, 3) for x in fps['eager']]}, "
        f"graphed in the first loop's form {[round(x, 3) for x in fps['graphed_init']]} (the "
        f"first loop {N_FRAMES / dt:.3f}) on {smi}")
    say(f"main path windows, frames/s [SM clock, power draw at the window's end]: "
        f"{'; '.join(clocks)}; the graphed windows' frames equal the first loop's: {same_form}")
    say(f"main path: initialize (eager: the first pair's detection and stereo match) "
        f"{init_ms:.3f} ms on {smi}")
    say(f"main path graph: captured in {capture_s:.3f} s (prewarm: {fcfg.n_points} points, "
        f"{fcfg.n_lines} line slots, {frames[0][0].shape[1]}x{frames[0][0].shape[0]}), pool "
        f"{prog.pool_bytes() / 2**20:.3f} MiB, {replays} replays over {N_FRAMES} timed frames, "
        f"launches per replay {prog.launches_per_replay()}")

    est = np.stack([np.eye(4)] + [r.T_f_w.cpu().numpy() for r in results])
    if est.shape != (len(poses), 4, 4) or not np.isfinite(est).all():
        raise AssertionError(f"bad poses: shape {est.shape}, finite "
                             f"{np.isfinite(est).all()}")
    good = [bool(r.good) for r in results]
    gt = np.stack([p[:3, 3] for p in poses])
    ate = ate_rmse(est[:, :3, 3], gt, align=False)
    timed_good = sum(good[N_WARMUP:])
    say(f"main path: {timed_good}/{N_FRAMES} timed frames good, "
        f"{sum(good)}/{len(good)} overall; ATE {ate:.6f} m (floor {ATE_FLOOR:.6f}, "
        f"JAX CPU {JAX_CPU_ATE:.6f}); {N_FRAMES / dt:.3f} graphed frames/s over {N_FRAMES} "
        f"frames")
    per_frame = {k: (launches[k] - before[k]) / N_FRAMES for k in wrappers}
    say(f"main path launches (prewarm, init + {len(results)} frames): {launches}; "
        f"per timed frame: {per_frame}")
    if not all(good):
        raise AssertionError(f"frames lost tracking: {good}")
    if not ate <= ATE_FLOOR:
        raise AssertionError(f"ATE {ate} above floor {ATE_FLOOR}")
    if dev.type == "cuda" and (replays != N_FRAMES or prof["graphed"]["graph_launches"] != 1):
        raise AssertionError(f"{replays} replays over {N_FRAMES} frames, "
                             f"{prof['graphed']['graph_launches']} graph launches per frame")
    for k in KERNEL_WRAPPERS:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} never launched on the main path")
        if per_frame[k] != FRAME_LAUNCHES[k]:
            raise AssertionError(f"{k} launched {per_frame[k]} times per graphed frame, "
                                 f"want {FRAME_LAUNCHES[k]}")
    return launches, {k: float(np.median(v)) for k, v in fps.items()}, ate, prof


def run_slam(dev, cam, poses, frames, cfg, mcfg, capture: bool) -> dict:
    """PLSLAM over ``frames`` (the first SLAM_WARMUP untimed), its tracker
    and mapper graphed or with ``capture=False``; the launch counts are set
    to 0 before the run and read after it.  Then LBA_REPS local BAs of the
    final window, solved and copied back (no write-back), host clock around
    a synchronized solve, and the GBA at finish."""
    from plslam_tpu_torch.io import ate_rmse
    from plslam_tpu_torch.pipeline import PLSLAM

    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    slam = PLSLAM(cam, cfg, mcfg, device=dev, capture=capture)
    jobs = record_keyframes(slam.mapper)
    t0 = time.perf_counter()
    for i in range(SLAM_WARMUP):
        slam.process(*frames[i], timestamp=0.05 * i)
    slam.wait_until_idle()
    _sync(dev)
    t1 = time.perf_counter()
    for i in range(SLAM_WARMUP, len(frames)):
        slam.process(*frames[i], timestamp=0.05 * i)
    slam.wait_until_idle()
    _sync(dev)
    r = {"slam": slam, "fps": (len(frames) - SLAM_WARMUP) / (time.perf_counter() - t1),
         "n_kf": len(slam.mapper.map.keyframes), "n_lba": slam.mapper.n_local_ba_applied,
         "n_bow": len(slam.loop_closer.bow) if slam.loop_closer is not None else None}
    lba_ms = []
    with slam.mapper._map_lock:
        for _ in range(LBA_REPS):
            prob, meta = slam.mapper.build_local_ba()
            _sync(dev)
            t = time.perf_counter()
            out, _ = slam.mapper._solve_local(prob, meta)
            out.cpu()
            lba_ms.append(1e3 * (time.perf_counter() - t))
    r["lba_ms"] = lba_ms
    r["lba_shape"] = (int(prob.T_c_w.shape[0]), len(meta["pt_ids"]), len(meta["ls_ids"]),
                      int(prob.p_valid.sum()), int(prob.l_valid.sum()))
    r["programs"] = program_stats(slam)
    r["vo_pool"] = sum(p.pool_bytes() for p in slam.vo.programs())
    # the map the GBA at finish meets (the GBA flushes the deferred local
    # BA first: flushed here, so the copy holds it)
    slam.mapper.flush_ba()
    gba_map = copy.deepcopy(slam.mapper.map)
    _sync(dev)
    t = time.perf_counter()
    r["traj"] = traj = slam.finish(run_gba=True)
    _sync(dev)
    r["gba_ms"] = 1e3 * (time.perf_counter() - t)
    r["gba"] = dict(slam.mapper.gba_trips)
    r["wall"] = time.perf_counter() - t0
    r["by_thread"] = _by_thread(wrappers)
    r["gba_prof"] = profile_gba(dev, slam.mapper, gba_map, capture)
    r["map_prof"] = profile_mapping(dev, slam.mapper, jobs, capture)
    r["good"] = [lg.good for lg in slam.logs]
    est = np.stack([T[:3, 3] for T in traj])
    gt = np.stack([poses[int(round(ts / 0.05))][:3, 3] for ts in slam.kf_timestamps])
    r["ate"] = ate_rmse(est, gt, align=True)
    return r


def profile_gba(dev, mapper, mp, capture: bool) -> dict:
    """The GBA at finish once more, on a fresh ``MapHandler`` of
    ``mapper``'s configuration over ``mp`` (a copy of the map that GBA
    met), under ``torch.profiler``: wall and device-busy ms, device
    kernels, host CUDA calls and graph launches, its trips and the
    keyframe poses it left."""
    from plslam_tpu_torch.backend.mapping import MapHandler
    from plslam_tpu_torch.profile_vo import profile_window

    fresh = MapHandler(mapper.cam, mapper.cfg, mapper.ba_cfg, tracker_cfg=mapper.tracker_cfg,
                       device=dev, capture=capture)
    fresh.map = mp
    w = profile_window(lambda i: fresh.global_bundle_adjustment(), 1)
    return {**{k: w[k] for k in ("wall_ms", "busy_ms", "kernels", "host_cuda_calls",
                                 "graph_launches")},
            "trips": dict(fresh.gba_trips), "traj": fresh.keyframe_trajectory()}


def trips_phrase(trips: dict) -> str:
    """A program's trips run eagerly (its warm-ups) and by replay, and its
    graph's pool."""
    return (f"{trips['eager']} trips eager / {trips['replayed']} by replay, pool "
            f"{trips['pool_bytes'] / 2**20:.3f} MiB")


def check_trips(name: str, trips: dict, total: int, graphed: bool) -> None:
    """A program of ``total`` trips: graphed, all but the warm-ups replay
    one captured trip; eager, none does."""
    from plslam_tpu_torch import graphs

    want = (graphs.WARMUP, total - graphs.WARMUP) if graphed else (total, 0)
    if (trips["eager"], trips["replayed"]) != want:
        raise AssertionError(f"{name}: trips eager / replayed {trips}, want {want}")


def record_keyframes(mapper) -> list:
    """The (pose, features) of every keyframe ``mapper`` takes from now on,
    ``initialize``'s first, for ``profile_mapping``."""
    jobs = []
    init, add = mapper.initialize, mapper.add_keyframe

    def initialize(pose, feats):
        jobs.append((pose, feats))
        return init(pose, feats)

    def add_keyframe(pose, feats, **kw):
        jobs.append((pose, feats))
        return add(pose, feats, **kw)

    mapper.initialize, mapper.add_keyframe = initialize, add_keyframe
    return jobs


def program_stats(slam) -> dict:
    """Per program kind of the mapper and the loop closer: built, evicted,
    captures, replays, pool bytes (``graphs.ProgramCache.stats``)."""
    out = slam.mapper.graph_stats()
    if slam.loop_closer is not None:
        out["bow"] = slam.loop_closer.programs.stats()
    return out


def say_programs(label: str, stats: dict, smi: str) -> None:
    """One line: captures, replays, replays per capture and pool MiB per
    program kind that ran."""
    parts = []
    for kind, st in stats.items():
        if st["built"]:
            per = st["replays"] / st["captures"] if st["captures"] else 0.0
            parts.append(f"{kind} {st['captures']} captures / {st['replays']} replays "
                         f"({per:.1f} per capture), {st['built']} built, {st['evicted']} "
                         f"evicted, pool {st['pool_bytes'] / 2**20:.3f} MiB")
    say(f"{label} programs: {'; '.join(parts)} on {smi}")


def profile_mapping(dev, mapper, jobs: list, capture: bool) -> dict:
    """The mapping thread's work replayed serially on this thread: a fresh
    ``MapHandler`` of ``mapper``'s configuration takes ``jobs`` as the
    mapping worker did (``add_keyframe`` with the deferred local BA), the
    first MAP_PROFILE_SKIP unprofiled, the rest under ``torch.profiler``:
    per keyframe wall and device-busy ms, device kernels, host CUDA calls
    and graph launches, and the captures made inside the window."""
    from plslam_tpu_torch import graphs
    from plslam_tpu_torch.backend.mapping import MapHandler
    from plslam_tpu_torch.profile_vo import profile_window

    fresh = MapHandler(mapper.cam, mapper.cfg, mapper.ba_cfg, tracker_cfg=mapper.tracker_cfg,
                       device=dev, capture=capture)
    fresh.initialize(*jobs[0])
    for job in jobs[1:1 + MAP_PROFILE_SKIP]:
        fresh.add_keyframe(*job, defer_ba=True)
    rest = jobs[1 + MAP_PROFILE_SKIP:]
    before = graphs.stats()["captures"]
    w = profile_window(lambda i: fresh.add_keyframe(*rest[i], defer_ba=True), len(rest))
    fresh.flush_ba()
    out = {k: w[k] for k in ("wall_ms", "busy_ms", "busy_share", "kernels", "host_cuda_calls",
                             "graph_launches")}
    return {**out, "keyframes": len(rest), "captures": graphs.stats()["captures"] - before}


def check_slam(name: str, g: dict, e: dict, floor: float, jax_ate: float, smi: str,
               kinds: tuple) -> None:
    """Report the graphed run ``g`` beside the eager run ``e`` and hold
    both to the SLAM checks; the graphed run also to its kernel launches
    and to a capture of each program kind in ``kinds``."""
    same = _same_poses(g["traj"], e["traj"])
    for form, r in (("graphed", g), ("eager", e)):
        say(f"{name} {form}: {r['fps']:.3f} full-SLAM frames/s over {SLAM_FRAMES} frames "
            f"({r['wall']:.3f} s for all {len(r['good'])} frames and the GBA); "
            f"{sum(r['good'])}/{len(r['good'])} frames good; {r['n_kf']} keyframes; "
            f"{r['n_lba']} local BAs written back; keyframe ATE {r['ate']:.6f} m (aligned; "
            f"floor {floor:.6f}, JAX CPU {jax_ate:.6f}); GBA (finish) {r['gba_ms']:.3f} ms on "
            f"{smi}")
        say(f"{name} {form}: local BA median {float(np.median(r['lba_ms'])):.3f} ms per solve "
            f"(min {min(r['lba_ms']):.3f}, max {max(r['lba_ms']):.3f}; {LBA_REPS} solves of the "
            f"final window; K, points, lines, point obs, line obs = {r['lba_shape']}); VO "
            f"graph pool {r['vo_pool'] / 2**20:.3f} MiB")
        say_programs(f"{name} {form}", r["programs"], smi)
        p = r["map_prof"]
        say(f"{name} {form}: the mapping thread's keyframes replayed serially, {p['keyframes']} "
            f"profiled: {p['host_cuda_calls']:.1f} host CUDA calls, {p['graph_launches']:.1f} "
            f"graph launches, {p['kernels']:.1f} device kernels, wall {p['wall_ms']:.3f} ms, "
            f"device busy {p['busy_ms']:.3f} ms ({100 * p['busy_share']:.2f}%) per keyframe; "
            f"{p['captures']} captures in the window on {smi}")
    for form, r in (("graphed", g), ("eager", e)):
        p = r["gba_prof"]
        say(f"{name} {form}: GBA at finish {r['gba_ms']:.3f} ms wall, "
            f"{trips_phrase(r['gba'])}, {r['gba']['chunks']} chunk(s); under the "
            f"profiler (a rerun on a copy of the map it met) wall {p['wall_ms']:.3f} ms, device "
            f"busy {p['busy_ms']:.3f} ms, {p['kernels']:.0f} device kernels, "
            f"{p['host_cuda_calls']:.0f} host CUDA calls, {p['graph_launches']:.0f} graph "
            f"launches; the rerun's poses bit-identical: "
            f"{_same_poses(p['traj'], r['traj'])} on {smi}")
    say(f"{name}: graphed and eager keyframe trajectories bit-identical: {same} (after the "
        f"GBA: keyframe ATE graphed {g['ate']:.9f}, eager {e['ate']:.9f} m)")
    say(f"{name} launches by thread (graphed run): {g['by_thread']}")
    for form, r in (("graphed", g), ("eager", e)):
        slam = r["slam"]
        if slam._map_errors:
            raise AssertionError(f"{name} {form}: a worker thread raised: {slam._map_errors!r}")
        if not all(r["good"]):
            raise AssertionError(f"{name} {form}: frames lost tracking: {r['good']}")
        if r["n_kf"] < 8:
            raise AssertionError(f"{name} {form}: only {r['n_kf']} keyframes")
        if r["n_lba"] < 1:
            raise AssertionError(f"{name} {form}: no local BA was written back")
        if r["n_bow"] is not None and r["n_bow"] != r["n_kf"]:
            raise AssertionError(f"{name} {form}: {r['n_bow']} BoW records for {r['n_kf']} "
                                 "keyframes")
        if slam.loop_reports:
            raise AssertionError(f"{name} {form}: false loop closure: {slam.loop_reports}")
        if not np.isfinite(np.stack(r["traj"])).all():
            raise AssertionError(f"{name} {form}: GBA poses are not finite")
        if not r["ate"] <= floor:
            raise AssertionError(f"{name} {form}: keyframe ATE {r['ate']} above floor {floor}")
        total = slam.mapper.ba_cfg.iters1 + slam.mapper.ba_cfg.iters2
        check_trips(f"{name} {form} GBA", r["gba"], total, form == "graphed")
        check_trips(f"{name} {form} GBA rerun", r["gba_prof"]["trips"], total, form == "graphed")
        if not _same_poses(r["gba_prof"]["traj"], r["traj"]):
            raise AssertionError(f"{name} {form}: the GBA on a copy of its map left other poses")
    if not same:
        raise AssertionError(f"{name}: graphed and eager keyframe trajectories differ")
    for kind in kinds:
        if g["programs"][kind]["captures"] < 1:
            raise AssertionError(f"{name}: no {kind} program was captured: {g['programs']}")
    if g["map_prof"]["graph_launches"] < 1:
        raise AssertionError(f"{name}: the graphed mapping replay launched "
                             f"{g['map_prof']['graph_launches']} graphs per keyframe")
    if g["by_thread"]["hamming_distance_matrix_cuda"].get(MAPPER_THREAD, 0) <= 0:
        raise AssertionError(f"{name}: the mapping thread never launched the Hamming kernel")
    for k in KERNEL_WRAPPERS:
        if sum(g["by_thread"][k].values()) <= 0:
            raise AssertionError(f"{name}: kernel {k} never launched")


def _same_poses(a, b) -> bool:
    return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


def slam_frames(dev, scene):
    from plslam_tpu_torch.core.camera import StereoCamera
    from plslam_tpu_torch.io import circular_trajectory

    cam = StereoCamera.create(scene.fx, scene.fy, scene.cx, scene.cy, scene.b,
                              width=scene.width, height=scene.height)
    poses = circular_trajectory(SLAM_WARMUP + SLAM_FRAMES, step_t=0.05)
    frames = [tuple(torch.from_numpy(x).to(dev) for x in scene.render_stereo(T, noise=1.0))
              for T in poses]
    _sync(dev)
    return cam, poses, frames


def slam_profile(dev, cam, frames, cfg, mcfg, smi) -> None:
    """Where a graphed SLAM frame's time goes: one more graphed run, its
    timed frames under ``torch.profiler``, which traces the device work of
    every thread: wall and device-busy ms per frame, the busy share, device
    kernels per frame and the kernels that take the most device time."""
    from plslam_tpu_torch.pipeline import PLSLAM
    from plslam_tpu_torch.profile_vo import _device_us, profile_window

    slam = PLSLAM(cam, cfg, mcfg, device=dev)
    for i in range(SLAM_WARMUP):
        slam.process(*frames[i], timestamp=0.05 * i)
    slam.wait_until_idle()
    timed = frames[SLAM_WARMUP:]

    def run(i):
        slam.process(*timed[i], timestamp=0.05 * (SLAM_WARMUP + i))
        if i == len(timed) - 1:
            slam.wait_until_idle()

    w = profile_window(run, len(timed))
    slam.finish(run_gba=False)
    avg = sorted((e for e in w["prof"].key_averages() if _device_us(e) > 0), key=_device_us,
                 reverse=True)
    top = "; ".join(f"{e.key[:60]} {_device_us(e) / 1e3 / w['n']:.3f} ms x{e.count / w['n']:.1f}"
                    for e in avg[:10])
    say(f"slam profile (graphed, {w['n']} frames, the mapping thread included): wall "
        f"{w['wall_ms']:.3f} ms/frame, device busy {w['busy_ms']:.3f} ms/frame "
        f"({100 * w['busy_share']:.2f}% of wall), {w['kernels']:.1f} device kernels/frame, "
        f"{w['host_cuda_calls']:.1f} host CUDA calls/frame on {smi}")
    say(f"slam profile: top device kernels per frame: {top}")


def slam_configs():
    """Phase 5's ``PLSLAMConfig`` and ``MapConfig`` (bench_slam.py's)."""
    from plslam_tpu_torch.backend.mapping import MapConfig
    from plslam_tpu_torch.config import PLSLAMConfig

    return (PLSLAMConfig(orb_nfeatures=1200, lsd_nfeatures=256, min_entropy_ratio=0.99),
            MapConfig(local_ba_kf=8, ba_points=2048, ba_lines=256, ba_pobs=8192, ba_lobs=2048))


def phase_slam(dev, scene, smi):
    """PLSLAM through the kernels at bench_slam.py's configuration, the
    tracker and the mapper graphed, beside the same run eagerly, and a
    profile of the graphed run."""
    cam, poses, frames = slam_frames(dev, scene)
    cfg, mcfg = slam_configs()
    g = run_slam(dev, cam, poses, frames, cfg, mcfg, capture=True)
    e = run_slam(dev, cam, poses, frames, cfg, mcfg, capture=False)
    check_slam("slam", g, e, SLAM_ATE_FLOOR, JAX_CPU_SLAM_ATE, smi, ("local_ba", "assoc"))
    slam_profile(dev, cam, frames, cfg, mcfg, smi)
    return g["by_thread"], {"graphed": g["fps"], "eager": e["fps"]}, g["ate"], frames


def phase_local_ba(dev, smi):
    """LM iterations/s of the local-BA solver (bench_slam.py's problem),
    eager and as one CUDA graph, and the graphed iterates and
    ``bundle_adjust`` against eager bit for bit."""
    from plslam_tpu_torch import graphs
    from plslam_tpu_torch.backend import ba
    from plslam_tpu_torch.bench_slam import LBA_CAM, local_ba_problem
    from plslam_tpu_torch.core.camera import StereoCamera

    K, P, L = 8, 512, 64
    cam = StereoCamera.create(*LBA_CAM)
    prob = local_ba_problem(dev, K, P, L)
    cfg = ba.BAConfig()
    cost0 = float(ba.total_cost(prob, cam, cfg, prob.p_valid, prob.l_valid))

    def run():
        return ba.lm_rounds(prob, cam, cfg, prob.p_valid, prob.l_valid, LM_ITERS)

    def timed(fn):
        """LM_REPS calls of fn between two CUDA events: (results, ms)."""
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        out = []
        start.record()
        for _ in range(LM_REPS):
            out.append(fn())
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    first = run()  # warm-up
    reps, ms = timed(run)
    # every run of the same problem gives the same iterates and cost, bit for bit
    fields = ("T_c_w", "points", "lines_orth")

    def same_as_first(r):
        return (all(bits_equal(getattr(r[0], f), getattr(first[0], f)) for f in fields)
                and bits_equal(r[1], first[1]) and bits_equal(r[2], first[2]))

    same = [same_as_first(r) for r in reps]
    say(f"local BA repeat: {sum(same)}/{len(same)} lm_rounds runs bit-identical to the first "
        f"(poses, points, lines, cost, trips)")
    if not all(same):
        raise AssertionError(f"lm_rounds does not repeat: {same}")
    res, cost, trips = reps[-1]

    # the same trips as one CUDA graph: LM_REPS replays timed, then the
    # iterates of the last, bit for bit those of the eager runs
    t = time.perf_counter()
    prog = graphs.Program(run, dev)
    capture_s = time.perf_counter() - t
    _, gms = timed(prog)
    gsame = same_as_first(prog.outputs)
    ips = LM_ITERS * LM_REPS / (ms / 1e3)
    gips = LM_ITERS * LM_REPS / (gms / 1e3)
    say(f"local BA graphed: lm_rounds replay bit-identical to the eager runs {gsame} "
        f"(poses, points, lines, cost, trips); captured in {capture_s:.3f} s, pool "
        f"{prog.pool_bytes() / 2**20:.3f} MiB, {prog.launches_per_replay()} kernel launches "
        f"per replay")
    if not gsame:
        raise AssertionError("graphed lm_rounds departs from eager")

    # the two-round bundle_adjust (LM, chi^2 gate, LM) graphed against eager
    want = ba.bundle_adjust(prob, cam, cfg)
    bprog = graphs.Program(lambda: ba.bundle_adjust(prob, cam, cfg), dev)
    got = bprog()
    bsame = (all(bits_equal(getattr(got.problem, f), getattr(want.problem, f)) for f in fields)
             and all(bits_equal(getattr(got, f), getattr(want, f))
                     for f in ("p_active", "l_active", "cost")))
    say(f"local BA graphed bundle_adjust: bit-identical to eager {bsame} (poses, points, "
        f"lines, gates, cost)")
    if not bsame:
        raise AssertionError("graphed bundle_adjust departs from eager")
    del prog, bprog

    cost, trips = float(cost), int(trips)
    say(f"local BA: eager {ips:.3f}, graphed {gips:.3f} LM iterations/s ({LM_ITERS} trips x "
        f"{LM_REPS} reps, {ms / LM_REPS:.3f} / {gms / LM_REPS:.3f} ms per lm_rounds; f32 K={K} "
        f"P={P} L={L}); cost {cost0:.6g} -> {cost:.6g}; {trips} trips before the early exit; "
        f"on {smi}")
    if not (np.isfinite(cost) and cost < 1e-3 * cost0):
        raise AssertionError(f"LM did not converge: {cost0} -> {cost}")
    if not torch.isfinite(res.T_c_w).all():
        raise AssertionError("LM poses are not finite")
    return {"eager": ips, "graphed": gips}


def phase_endpoint_slam(dev, scene, smi):
    """PLSLAM with endpoint lines, loop closure and the keyframe refinement
    at phase 5's configuration, graphed beside eager."""
    from plslam_tpu_torch.backend.mapping import MapConfig
    from plslam_tpu_torch.config import PLSLAMConfig

    cam, poses, frames = slam_frames(dev, scene)
    cfg = PLSLAMConfig(orb_nfeatures=1200, lsd_nfeatures=256, min_entropy_ratio=0.99,
                       use_line_plucker=False, use_loop_closure=True, has_refinement=True,
                       vocabulary_p=os.path.join(CONFIGS, "vocab_orb_k10L3.yml.gz"),
                       vocabulary_l=os.path.join(CONFIGS, "vocab_lbd_k10L3.yml.gz"))
    mcfg = MapConfig(local_ba_kf=8, ba_points=2048, ba_lines=256, ba_pobs=8192, ba_lobs=2048,
                     plucker_lines=False, has_refinement=True)
    g = run_slam(dev, cam, poses, frames, cfg, mcfg, capture=True)
    e = run_slam(dev, cam, poses, frames, cfg, mcfg, capture=False)
    check_slam("endpoint slam", g, e, EP_ATE_FLOOR, JAX_CPU_EP_ATE, smi,
               ("local_ba", "kf2kf", "refine", "map2kf", "bow"))
    say(f"endpoint slam: {g['n_bow']} keyframes BoW-encoded, {len(g['slam'].loop_reports)} loops")
    return g["by_thread"], {"graphed": g["fps"], "eager": e["fps"]}, g["ate"]


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


def run_ring(dev, cam, feats, T_est, T_true, capture: bool) -> dict:
    """The ring replay through PLSLAM with ``capture`` (launch counts set
    to 0 before it, read after it): keyframes/s, the keyframe poses after
    the replay and after the GBA, the closures, the GBA's chunks, the
    program counts and the launches by thread."""
    from plslam_tpu_torch.backend.mapping import MapConfig
    from plslam_tpu_torch.config import PLSLAMConfig
    from plslam_tpu_torch.pipeline import PLSLAM

    cfg = PLSLAMConfig(use_line_plucker=False, use_loop_closure=True, multithread_slam=True)
    if cfg.lc_kf_dist != 50:
        raise AssertionError(f"lc_kf_dist {cfg.lc_kf_dist}: the reference gating is 50")
    slam = PLSLAM(cam, cfg, MapConfig(use_lines=True, plucker_lines=False, local_ba_kf=8,
                                      ba_points=512, ba_lines=64, ba_pobs=2048, ba_lobs=512),
                  device=dev, capture=capture)
    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    for i in range(RING_KF):
        slam.insert_keyframe_features(T_est[i], feats[i], timestamp=0.1 * i)
    slam.wait_until_idle()
    torch.cuda.synchronize()
    r = {"slam": slam, "kf_per_s": RING_KF / (time.perf_counter() - t0),
         "closed": [k.T_w_k.copy() for k in slam.mapper.map.keyframes]}
    r["ate_closed"] = _ate_translation(r["closed"], T_true)
    r["programs"] = program_stats(slam)

    log = logging.getLogger("plslam")
    handler, old_level = _Messages(), log.level
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    try:
        t = time.perf_counter()
        r["traj"] = slam.finish(run_gba=True)
        torch.cuda.synchronize()
        r["gba_ms"] = 1e3 * (time.perf_counter() - t)
    finally:
        log.removeHandler(handler)
        log.setLevel(old_level)
    r["by_thread"] = {k: fn.launches_by_thread() for k, fn in wrappers.items()}
    r["gba"] = dict(slam.mapper.gba_trips)
    r["verify_ms"] = list(slam.loop_closer.verify_ms)
    r["solves"] = dict(slam.loop_closer.solve_counts)
    gba_msgs = [m for m in handler.messages if m.startswith("GBA:")]
    r["gba_msgs"] = gba_msgs
    r["n_chunks"] = int(gba_msgs[-1].split(" in ")[1].split()[0]) if gba_msgs else 0
    r["ate_gba"] = _ate_translation(r["traj"], T_true)
    return r


def check_ring(form: str, r: dict, T_est, T_true, smi: str) -> None:
    """Phase 8's report and checks of one ring run."""
    slam = r["slam"]
    mp = slam.mapper.map
    drift_odo = _ate_translation(T_est, T_true)
    reports = slam.loop_reports
    say(f"loop {form}: {r['kf_per_s']:.3f} keyframes/s over the {RING_KF}-keyframe replay; "
        f"{len(mp.keyframes)} keyframes, {int(mp.pt_valid.sum())} points, "
        f"{int(mp.ls_valid.sum())} lines; on {smi}")
    for rep in reports:
        say(f"loop {form}: closure kf {rep['kf']} -> candidate {rep['candidate']} on the map "
            f"of {rep['map_keyframes']} keyframes: verification {rep['verify_ms']:.3f} ms, PGO "
            f"{rep['pgo_ms']:.3f} ms ({trips_phrase(rep['pgo_trips'])}), fusion "
            f"{rep['fuse_ms']:.3f} ms, fused {rep['fused']}, "
            f"correction {rep['correction']:.6f} m on {smi}")
    v, sc = r["verify_ms"], r["solves"]
    per = sc["replays"] / sc["captures"] if sc["captures"] else 0.0
    say(f"loop {form}: {len(v)} candidates verified, ms per candidate median "
        f"{float(np.median(v)) if v else float('nan'):.3f} (first {v[0] if v else float('nan'):.3f}, "
        f"min {min(v, default=float('nan')):.3f}, max {max(v, default=float('nan')):.3f}); the "
        f"pose solve {sc['solves']} times: {sc['captures']} captures / {sc['replays']} replays "
        f"({per:.1f} per capture) on {smi}")
    say(f"loop {form}: ATE odometry {drift_odo:.6f} m, after the closure {r['ate_closed']:.6f} "
        f"m, after the GBA {r['ate_gba']:.6f} m; GBA (finish) {r['gba_ms']:.3f} ms in "
        f"{r['n_chunks']} chunks, {trips_phrase(r['gba'])} on {smi}")
    say_programs(f"loop {form}", r["programs"], smi)
    say(f"loop {form} launches by thread: {r['by_thread']}")
    if slam._map_errors:
        raise AssertionError(f"loop {form}: a worker thread raised: {slam._map_errors!r}")
    if not reports:
        raise AssertionError(f"loop {form}: no loop closure at lc_kf_dist=50")
    rep = reports[-1]
    for x in reports:
        if not (x["kf"] >= RING_REVISIT and x["candidate"] <= 20):
            raise AssertionError(f"loop {form}: false loop closure: {x}")
    if not (rep["candidate"] <= rep["kf"] - 50):
        raise AssertionError(f"loop {form}: candidate within lc_kf_dist: {rep}")
    if not (drift_odo > 0.1 and r["ate_closed"] < drift_odo):
        raise AssertionError(f"loop {form}: ATE after the closure {r['ate_closed']} vs "
                             f"odometry {drift_odo}")
    k = rep["kf"]
    err_odo = np.linalg.norm(T_est[k][:3, 3] - T_true[k][:3, 3])
    err_map = np.linalg.norm(mp.keyframes[k].T_w_k[:3, 3] - T_true[k][:3, 3])
    say(f"loop {form}: closure keyframe error {err_map:.6f} m vs odometry {err_odo:.6f} m")
    if not (err_odo > 0.1 and err_map < 0.5 * err_odo):
        raise AssertionError(f"loop {form}: closure keyframe error {err_map} vs odometry "
                             f"{err_odo}")
    if sum(rep["fused"].values()) < 10:
        raise AssertionError(f"loop {form}: too little fusion: {rep['fused']}")
    if r["n_chunks"] < 2:
        raise AssertionError(f"loop {form}: GBA ran in {r['n_chunks']} chunk(s): "
                             f"{r['gba_msgs']}")
    if not (np.isfinite(np.stack(r["traj"])).all() and r["ate_gba"] < 1.0):
        raise AssertionError(f"loop {form}: GBA poses: finite "
                             f"{np.isfinite(np.stack(r['traj'])).all()}, ATE {r['ate_gba']}")
    if r["by_thread"]["hamming_distance_matrix_cuda"].get(LOOP_THREAD, 0) <= 0:
        raise AssertionError(f"loop {form}: the loop-closure thread never launched Hamming")
    graphed = form == "graphed"
    bcfg = slam.mapper.ba_cfg
    check_trips(f"loop {form} GBA", r["gba"], bcfg.iters1 + bcfg.iters2, graphed)
    for x in reports:
        check_trips(f"loop {form} PGO", x["pgo_trips"], slam.loop_closer.cfg.pgo_iters, graphed)
    sc = r["solves"]
    want = sc["solves"] if graphed else 0
    if sc["solves"] < 1 or sc["replays"] != want or (sc["captures"] >= 1) != graphed:
        raise AssertionError(f"loop {form}: the verification's pose solve {sc}")


def _closures(r: dict) -> list:
    """A ring run's closures: (keyframe, candidate, keyframes in the map
    the correction met)."""
    return [(x["kf"], x["candidate"], x["map_keyframes"]) for x in r["slam"].loop_reports]


def _same_trajectories(a: dict, b: dict) -> tuple[bool, float]:
    """Two ring runs' keyframe poses after the replay and after the GBA:
    bit for bit, and the largest difference."""
    pairs = [(x, y) for key in ("closed", "traj") for x, y in zip(a[key], b[key])]
    same = (len(a["closed"]) == len(b["closed"]) and len(a["traj"]) == len(b["traj"])
            and all(np.array_equal(x, y) for x, y in pairs))
    diff = max((float(np.abs(x - y).max()) for x, y in pairs), default=float("inf"))
    return same, diff


def phase_loop_closure(dev, smi):
    """tests/test_scale_e2e.py's ring replay through PLSLAM on the card,
    graphed beside eager (a second eager run when the two differ)."""
    from plslam_tpu_torch.convert import stereo_features_from_numpy
    from plslam_tpu_torch.core import lie
    from plslam_tpu_torch.core.camera import StereoCamera
    from plslam_tpu_torch.io.ring_world import RingWorld, render_ring_features

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

    g = run_ring(dev, cam, feats, T_est, T_true, capture=True)
    check_ring("graphed", g, T_est, T_true, smi)
    e = run_ring(dev, cam, feats, T_est, T_true, capture=False)
    check_ring("eager", e, T_est, T_true, smi)
    same, diff = _same_trajectories(g, e)
    say(f"loop: graphed and eager keyframe trajectories (after the replay and after the GBA) "
        f"bit-identical: {same} (max |difference| {diff:.3g}); keyframes/s graphed "
        f"{g['kf_per_s']:.3f}, eager {e['kf_per_s']:.3f} on {smi}")
    if not same:
        # the loop closer corrects the map it finds when its verification
        # ends: the threads' timing sets how many keyframes that map holds,
        # and two runs whose corrections met different maps part.  Runs
        # whose corrections met maps of the same keyframes must agree,
        # unless the eager replay does not repeat itself either.
        met = [_closures(r) for r in (g, e)]
        say(f"loop: closures as (keyframe, candidate, keyframes in the map it corrected): "
            f"graphed {met[0]}, eager {met[1]}")
        if met[0] == met[1]:
            e2 = run_ring(dev, cam, feats, T_est, T_true, capture=False)
            check_ring("eager (again)", e2, T_est, T_true, smi)
            repeat, rdiff = _same_trajectories(e, e2)
            say(f"loop: two eager runs bit-identical: {repeat} (max |difference| {rdiff:.3g}); "
                f"closures {_closures(e2)}")
            if repeat:
                raise AssertionError(f"loop: the graphed replay departs from an eager replay "
                                     f"that repeats itself on the same maps (max |difference| "
                                     f"{diff:.3g})")
    for kind in ("local_ba", "assoc", "bow"):
        if g["programs"][kind]["captures"] < 1:
            raise AssertionError(f"loop: no {kind} program was captured: {g['programs']}")
    return g["by_thread"], {"graphed": g["kf_per_s"], "eager": e["kf_per_s"]}


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
    configuration: the B sweep (the graphed step's aggregate and
    per-stream frames/s beside the eager step's, graphed and eager results
    bit for bit, every frame of every stream good, the launches per graphed
    frame), the per-stream ATE
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
            _sync(dev)
            before = {k: fn.launches for k, fn in wrappers.items()}
            t0 = time.perf_counter()
            for i in range(BATCH_WARMUP + 1, n_poses):
                results.append(bvo.process(L[i][:B], R[i][:B]))
            _sync(dev)
            dt = time.perf_counter() - t0
            per_frame = {k: (fn.launches - before[k]) / BATCH_FRAMES for k, fn in wrappers.items()}
            # the same streams eagerly (capture=False), timed the same way
            eager = BatchedVisualOdometry(B, cam, fcfg, tcfg, device=dev, capture=False)
            eager.initialize(L[0][:B], R[0][:B])
            ref = [eager.process(L[i][:B], R[i][:B]) for i in range(1, BATCH_WARMUP + 1)]
            _sync(dev)
            t0 = time.perf_counter()
            for i in range(BATCH_WARMUP + 1, n_poses):
                ref.append(eager.process(L[i][:B], R[i][:B]))
            _sync(dev)
            dt_eager = time.perf_counter() - t0
            same = sum(bits_equal(a.T_f_w, b.T_f_w) for a, b in zip(results, ref))
            every = sum(results_equal(a, b) for a, b in zip(results, ref))
            good = torch.stack([r.good for r in results]).cpu().numpy()    # (frames, B)
            agg, agg_eager = B * BATCH_FRAMES / dt, B * BATCH_FRAMES / dt_eager
            prog = bvo.programs()[0]
            row = dict(B=B, frames_per_s=agg, per_stream_frames_per_s=agg / B,
                       eager_frames_per_s=agg_eager, launches_per_frame=per_frame,
                       good=int(good.sum()), frames=good.size,
                       pool_mib=prog.pool_bytes() / 2**20, need_mib=prog.need / 2**20)
            row["per_stream_vs_single"] = row["per_stream_frames_per_s"] / rows.get(
                BATCH_SIZES[0], row)["per_stream_frames_per_s"]
            rows[B] = row
            say(f"batch B={B}: graphed {agg:.3f} aggregate frames/s, {agg / B:.3f} per stream "
                f"(per_stream_vs_single {row['per_stream_vs_single']:.3f}), eager "
                f"{agg_eager:.3f} aggregate frames/s, over {BATCH_FRAMES} timed frames; "
                f"{int(good.sum())}/{good.size} stream-frames good; launches per graphed frame "
                f"{per_frame}; graphed vs eager T_f_w bit-identical on {same}/{len(results)} "
                f"frames, every result field on {every}; graph pool {row['pool_mib']:.3f} MiB "
                f"(last warm-up's peak {row['need_mib']:.3f} MiB) on {smi}")
            if not good.all():
                raise AssertionError(f"B={B}: frames lost tracking (frame, stream): "
                                     f"{np.argwhere(~good).tolist()}")
            if same != len(results):
                raise AssertionError(f"B={B}: the graphed batched step departs from the eager "
                                     f"one on {len(results) - same} frames")
            for k in KERNEL_WRAPPERS:
                if per_frame[k] != FRAME_LAUNCHES[k]:
                    raise AssertionError(f"B={B}: {k} launched {per_frame[k]} times per frame, "
                                         f"want {FRAME_LAUNCHES[k]} at every B")
            if B == BATCH_ATE_B:
                # the graphed batched step keeps its state on the card: one
                # more step (repeating the last frame) under sync-debug "error"
                torch.cuda.set_sync_debug_mode("error")
                bvo.process(L[-1][:B], R[-1][:B])
                torch.cuda.set_sync_debug_mode(0)
                say(f"batch B={B}: a graphed step made no host sync (sync debug mode 'error')")
                kept["ate"] = results
            if B == BATCH_MATCH_B:
                kept["match"] = results
            del bvo, eager, prog
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


def make_dist_ba_problem(dev, rng, K, P, L, obs_k):
    """The dry run's landmark-sharded BA problem (float32), built with the
    same draws in the same order; landmark indices global, observations
    landmark-major (a contiguous block of landmarks owns a contiguous block
    of observations)."""
    from plslam_tpu_torch.backend import ba
    from plslam_tpu_torch.core import lie
    from plslam_tpu_torch.core.plucker import plucker_from_two_points, plucker_to_orth

    fx = fy = 435.2
    cx, cy = 367.4, 252.2
    f32 = np.float32
    xi = np.concatenate([rng.uniform(-0.3, 0.3, (K, 3)), rng.uniform(-0.05, 0.05, (K, 3))], 1)
    T_c_w = np.linalg.inv(lie.exp_se3(torch.from_numpy(xi).float()).numpy()).astype(f32)
    Pw = np.stack([rng.uniform(-3, 3, P), rng.uniform(-2, 2, P), rng.uniform(4, 10, P)],
                  -1).astype(f32)
    LA = np.stack([rng.uniform(-3, 3, L), rng.uniform(-2, 2, L), rng.uniform(4, 10, L)],
                  -1).astype(f32)
    LB = (LA + np.stack([rng.uniform(-1.5, 1.5, L), rng.uniform(-1.5, 1.5, L),
                         rng.uniform(-0.5, 0.5, L)], -1)).astype(f32)

    def proj(cams, X):
        Xc = np.einsum("nij,nj->ni", T_c_w[cams, :3, :3], X) + T_c_w[cams, :3, 3]
        return np.stack([cx + fx * Xc[:, 0] / Xc[:, 2], cy + fy * Xc[:, 1] / Xc[:, 2]],
                        -1).astype(f32)

    p_cam = (rng.integers(0, K - obs_k + 1, P)[:, None] + np.arange(obs_k)[None]).reshape(-1)
    p_lm = np.repeat(np.arange(P), obs_k)
    l_cam = (rng.integers(0, K - obs_k + 1, L)[:, None] + np.arange(obs_k)[None]).reshape(-1)
    l_lm = np.repeat(np.arange(L), obs_k)
    Lw = plucker_from_two_points(torch.from_numpy(LA), torch.from_numpy(LB))
    scale = torch.linalg.norm(Lw, dim=-1)
    orth = plucker_to_orth(Lw / scale[:, None])
    pert = rng.normal(size=(K, 6)).astype(f32) * 0.02
    pert[0] = 0
    T_init = lie.exp_se3(torch.from_numpy(pert)) @ torch.from_numpy(T_c_w)
    pts = Pw + rng.normal(size=Pw.shape).astype(f32) * 0.02
    t = lambda a: torch.as_tensor(a).to(dev)  # noqa: E731
    ones = lambda n: torch.ones(n, dtype=torch.bool, device=dev)  # noqa: E731
    return ba.BAProblem(
        T_c_w=t(T_init), pose_fixed=t(np.arange(K) == 0), pose_valid=ones(K), points=t(pts),
        point_valid=ones(P), lines_orth=t(orth), lines_scale=t(scale), line_valid=ones(L),
        p_cam=t(p_cam), p_lm=t(p_lm), p_uv=t(proj(p_cam, Pw[p_lm])),
        p_sigma2=torch.ones(len(p_cam), device=dev), p_valid=ones(len(p_cam)),
        l_cam=t(l_cam), l_lm=t(l_lm), l_sobs=t(proj(l_cam, LA[l_lm])),
        l_eobs=t(proj(l_cam, LB[l_lm])), l_sigma2=torch.ones(len(l_cam), device=dev),
        l_valid=ones(len(l_cam)))


def make_dist_pose_graph(dev, rng, K, n_shards):
    """The dry run's pose graph (odometry chain, skip edges every 3 poses,
    one loop edge; noisy starts) in float64, as the port's PGO runs, its
    edges padded with invalid rows to a multiple of ``n_shards``."""
    from plslam_tpu_torch.backend.pgo import PoseGraph
    from plslam_tpu_torch.core import lie

    xi = rng.normal(size=(K, 6)).astype(np.float32) * 0.05
    xi[0] = 0
    T_gt = lie.exp_se3(torch.from_numpy(np.cumsum(xi, 0).astype(np.float64)))
    cov = np.arange(0, K - 5, 3)
    e_i = np.concatenate([np.arange(K - 1), cov, [0]])
    e_j = np.concatenate([np.arange(1, K), cov + 5, [K - 1]])
    e_T = torch.linalg.inv(T_gt[e_i]) @ T_gt[e_j]
    noise = rng.normal(size=(K, 6)).astype(np.float32) * 0.03 * (np.arange(K) > 0)[:, None]
    noisy = lie.exp_se3(torch.from_numpy(noise.astype(np.float64))) @ T_gt
    E, pad = len(e_i), -len(e_i) % n_shards
    f64 = torch.float64
    return PoseGraph(T_w_k=noisy.to(dev), fixed=(torch.arange(K) == 0).to(dev),
                     valid=torch.ones(K, dtype=torch.bool, device=dev),
                     e_i=torch.from_numpy(np.pad(e_i, (0, pad))).to(dev),
                     e_j=torch.from_numpy(np.pad(e_j, (0, pad))).to(dev),
                     e_T=torch.cat([e_T, torch.eye(4, dtype=f64).expand(pad, 4, 4)]).to(dev),
                     e_info=torch.ones(E + pad, dtype=f64, device=dev),
                     e_valid=(torch.arange(E + pad) < E).to(dev))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(dev, fn, warm=False):
    """(result, host ms) of fn between two device synchronizations; with
    ``warm``, after one untimed call (first-call costs: cuSOLVER, NCCL)."""
    if warm:
        fn()
    _sync(dev)
    t = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, 1e3 * (time.perf_counter() - t)


def _ring_errors(mapper, truth):
    """(mean keyframe position error, median point error) against the ring
    map's truth, as the dry run measures them."""
    T_true, pt_true = truth
    mp = mapper.map
    T = np.stack([k.T_w_k[:3, 3] for k in mp.keyframes])
    el = np.where(mp.pt_valid & (mp.pt_nobs >= 2))[0]
    return (float(np.linalg.norm(T - T_true[:, :3, 3], axis=1).mean()),
            float(np.median(np.linalg.norm(mp.pt_w[el] - pt_true[el], axis=1))))


def _same_map(a, b) -> bool:
    """Whether two mappers hold the same poses, landmarks and observation
    masks, bit for bit."""
    ma, mb = a.map, b.map
    poses = [np.stack([k.T_w_k for k in m.keyframes]) for m in (ma, mb)]
    pairs = [poses, (ma.pt_w, mb.pt_w), (ma.ls_w, mb.ls_w), (ma.ls_epw, mb.ls_epw),
             (ma.pobs.valid[: ma.pobs.n], mb.pobs.valid[: mb.pobs.n]),
             (ma.lobs.valid[: ma.lobs.n], mb.lobs.valid[: mb.lobs.n])]
    return all(np.array_equal(x, y) for x, y in pairs)


def run_dist(dev, smi, streams, cfg):
    """Every distributed program of the JAX package's multichip dry run at
    ``cfg``'s sizes on the initialized process group (this rank's card is
    ``dev``), each against its single-device form on this rank: a 1-D mesh
    and a 2-axis ("dcn", "ici") one ((2, n / 2) when the world n is even,
    else (1, n)), landmark-sharded BA, the sharded matcher, the
    edge-sharded PGO, the kf-block GBA, and ``BatchedVisualOdometry(b,
    sharding=)`` against the unsharded batch: bit for bit at world 1,
    otherwise within phase 10's batched-vs-single bars (rank 0 checks).
    Returns this rank's kernel launches (sharded matcher and batched VO),
    the programs' times (ms) and the report lines, each printed too.
    Launch counts are checked on the card only: CPU tensors never reach a
    kernel."""
    import torch.distributed as dist

    from plslam_tpu_torch.backend import ba, pgo
    from plslam_tpu_torch.batch_vo import BatchedVisualOdometry
    from plslam_tpu_torch.convert import ba_problem_from_numpy
    from plslam_tpu_torch.core.camera import StereoCamera
    from plslam_tpu_torch.frontend.frame import FrontendConfig
    from plslam_tpu_torch.frontend.tracker import TrackerConfig
    from plslam_tpu_torch.io import SyntheticScene
    from plslam_tpu_torch.io.ring_map import build_ring_map
    from plslam_tpu_torch.ops import matching as M
    from plslam_tpu_torch.ops.cuda_hamming import hamming_distance_matrix
    from plslam_tpu_torch.parallel import dist_ba, dist_gba, dist_match, multihost
    from plslam_tpu_torch.parallel.mesh import allgather, make_mesh, shard_leading

    lines = []

    def note(msg):
        say(msg)
        lines.append(msg)

    t_phase = time.perf_counter()
    n, rank = dist.get_world_size(), dist.get_rank()
    mesh = make_mesh("lm", dev.type)
    mesh2 = multihost.make_multihost_mesh(*((2, n // 2) if n % 2 == 0 else (1, n)),
                                          device_type=dev.type)
    note(f"dist: process group {dist.get_backend()} world {n}, meshes {tuple(mesh.shape)} "
         f"and {tuple(mesh2.shape)} {mesh2.mesh_dim_names} up in "
         f"{time.perf_counter() - t_phase:.3f} s on {smi}")
    wrappers = _wrappers()
    kernels = KERNEL_WRAPPERS if dev.type == "cuda" else ()
    rng = np.random.default_rng(0)
    ms = {}

    # landmark-sharded BA against lm_rounds on the unsharded problem
    sz = cfg["ba"]
    prob = make_dist_ba_problem(dev, rng, **sz)
    local = prob._replace(p_lm=prob.p_lm % (sz["P"] // n), l_lm=prob.l_lm % (sz["L"] // n))
    cam = StereoCamera.create(435.2, 435.2, 367.4, 252.2, 0.110074)
    run = dist_ba.make_dist_bundle_adjust(mesh, cam, ba.BAConfig(), cfg["iters"])
    (out, cost), ms["dist_ba"] = _timed(dev, lambda: run(dist_ba.shard_problem(mesh, local)),
                                        warm=True)
    (ref, ref_cost, _), ms["single_ba"] = _timed(dev, lambda: ba.lm_rounds(
        prob, cam, ba.BAConfig(early_exit=False), prob.p_valid, prob.l_valid, cfg["iters"]),
        warm=True)
    run2 = multihost.make_dist_bundle_adjust_2d(mesh2, cam, ba.BAConfig(), cfg["iters"])
    (out2, cost2), ms["dist_ba_2d"] = _timed(
        dev, lambda: run2(multihost.shard_problem_2d(mesh2, local)), warm=True)
    dT = max(float((o.T_c_w - ref.T_c_w).abs().max()) for o in (out, out2))
    dc = max(abs(float(c) - float(ref_cost)) for c in (cost, cost2)) / max(
        abs(float(ref_cost)), 1.0)
    note(f"dist BA K={sz['K']} P={sz['P']} L={sz['L']} obs {int(prob.p_valid.sum())}+"
         f"{int(prob.l_valid.sum())}, {cfg['iters']} trips: cost {float(cost):.6g} (single "
         f"{float(ref_cost):.6g}); against the single-device solve dT={dT:.3g} dcost={dc:.3g} "
         f"(dry run's bars 5e-3, 1e-3); 1-axis {ms['dist_ba']:.3f} ms, 2-axis "
         f"{ms['dist_ba_2d']:.3f} ms, single {ms['single_ba']:.3f} ms")
    if not (np.isfinite(float(cost)) and dT < 5e-3 and dc < 1e-3):
        raise AssertionError(f"dist BA departs from the single-device solve: dT {dT}, dcost {dc}")

    # the sharded matcher, all rows valid and with masked rows, against the
    # single-device matcher
    Q = cfg["q"]
    desc_q = rng.integers(0, 2**32, (Q, 8), dtype=np.uint64).astype(np.uint32)
    desc_t = np.concatenate([desc_q[: Q // 2], rng.integers(
        0, 2**32, (Q - Q // 2, 8), dtype=np.uint64).astype(np.uint32)])
    masks = [(np.ones(Q, bool), np.ones(Q, bool)),
             (rng.random(Q) >= cfg["masked"], rng.random(Q) >= cfg["masked"])]
    dq = torch.from_numpy(desc_q.view(np.int32)).to(dev)
    dt = torch.from_numpy(desc_t.view(np.int32)).to(dev)
    vs = [(torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)) for a, b in masks]
    matcher = dist_match.make_dist_matcher(mesh)

    def match_all():
        return [matcher(shard_leading(dq, mesh), shard_leading(vq, mesh), dt, vt)
                for vq, vt in vs]

    match_all()     # untimed first call, outside the counts
    for fn in wrappers.values():
        fn.launches = 0
    got, ms["dist_match"] = _timed(dev, match_all)
    launches = {k: fn.launches for k, fn in wrappers.items()}
    for (vq, vt), g, name in zip(vs, got, ("all rows valid", "masked rows")):
        want = M.match_mutual_nnr(hamming_distance_matrix(dq, dt), vq[:, None] & vt[None, :], 0.9)
        idx, dd = allgather(g.idx, mesh), allgather(g.dist, mesh)
        same = torch.equal(idx, want.idx) and torch.equal(dd, want.dist)
        note(f"dist matcher Q={Q} ({name}): {int((idx >= 0).sum())} matches, equal to the "
             f"single-device matcher: {same}")
        if not same or int((idx >= 0).sum()) < Q // 4:
            raise AssertionError(f"sharded matcher ({name}) != single-device matcher")
    note(f"dist matcher: {ms['dist_match'] / len(vs):.3f} ms per call; launches {launches}")
    if launches["hamming_distance_matrix_cuda"] != len(vs) and kernels:
        raise AssertionError(f"sharded matcher launched Hamming {launches}")

    # the edge-sharded PGO against pgo.optimize
    g = make_dist_pose_graph(dev, rng, cfg["pgo_k"], n)
    pgo_run = dist_match.make_dist_pgo(mesh, iters=cfg["pgo_iters"])
    g_out, ms["dist_pgo"] = _timed(
        dev, lambda: pgo_run(dist_match.shard_posegraph(mesh, g)), warm=True)
    g_ref, ms["single_pgo"] = _timed(dev, lambda: pgo.optimize(g, cfg["pgo_iters"]), warm=True)
    dP = float((g_out.T_w_k - g_ref.T_w_k).abs().max())
    note(f"dist PGO K={cfg['pgo_k']} E={int(g.e_valid.sum())}, {cfg['pgo_iters']} iterations: "
         f"dP={dP:.3g} (bar 5e-3); {ms['dist_pgo']:.3f} ms, single {ms['single_pgo']:.3f} ms")
    if not dP < 5e-3:
        raise AssertionError(f"dist PGO departs from pgo.optimize: {dP}")

    # the chunked GBA in this process on the ring map: at 1 and 4 blocks of
    # chunks in float32 and float64 (rank 0; no collectives), then on the
    # ranks' partition, written back: the reference of the kf-block GBA
    def chunked(mapper, n_blocks, dtype=torch.float32):
        blk = dist_gba.partition_map(mapper, n_blocks)
        prob = ba_problem_from_numpy(blk.prob, dev)
        prob = prob._replace(**{f: v.to(dtype) for f, v in prob._asdict().items()
                                if v is not None and v.is_floating_point()})
        return blk, ba.bundle_adjust_chunked(prob, mapper.cam, mapper.ba_cfg)

    ref, truth = build_ring_map(**cfg["ring"], device=dev)
    if rank == 0:
        split = {}
        for n_blocks in (1, 4):
            for dtype in (torch.float32, torch.float64):
                (blk, res), t = _timed(dev, lambda: chunked(ref, n_blocks, dtype))
                Ng = len(blk.pt_ids_glob)
                own = blk.own_pt & (blk.pt_gid >= 0) & (blk.pt_gid < Ng)
                pts = np.zeros((Ng, 3))
                pts[blk.pt_gid[own]] = res.problem.points.double().cpu().numpy()[own]
                split[n_blocks, dtype] = (len(blk.metas), res.problem.T_c_w.double().cpu()
                                          .numpy(), pts, float(res.cost), t)
        spread = {}
        for dtype in (torch.float32, torch.float64):
            (c1, T1, x1, cost1, t1), (c4, T4, x4, cost4, t4) = split[1, dtype], split[4, dtype]
            spread[dtype] = (float(np.abs(T1 - T4).max()), float(np.abs(x1 - x4).max()))
            note(f"chunked GBA {str(dtype)[6:]}: {c1} chunks cost {cost1:.6g} ({t1:.3f} ms), "
                 f"{c4} chunks cost {cost4:.6g} ({t4:.3f} ms); {c1} vs {c4} chunks: max |dT| "
                 f"{spread[dtype][0]:.3g}, max |dpoint| {spread[dtype][1]:.3g} m")
        if not max(spread[torch.float64]) < 1e-6:
            raise AssertionError(f"the f64 chunked GBA moves with its chunk split: {spread}")
    ref_blk, ref_res = chunked(ref, n)
    rp = ref_res.problem
    dist_gba.write_back(ref, ref_blk, (rp.T_c_w, rp.points, rp.lines_orth, rp.lines_scale,
                                       ref_res.p_active, ref_res.l_active))

    # the kf-block GBA, 1-axis and 2-axis: bit for bit the chunked GBA on the
    # same partition; against the single-device GBA (other chunks) the dry
    # run's bars
    mapper_b, _ = build_ring_map(**cfg["ring"], device=dev)
    pre_p, pre_x = _ring_errors(mapper_b, truth)
    _, ms["single_gba"] = _timed(dev, mapper_b.global_bundle_adjustment)
    single_p, single_x = _ring_errors(mapper_b, truth)
    for name, axes_mesh in (("1-axis", make_mesh(dist_gba.AXIS, dev.type)), ("2-axis", mesh2)):
        mapper, _ = build_ring_map(**cfg["ring"], device=dev)
        blk, ms["dist_gba " + name] = _timed(
            dev, lambda: dist_gba.distributed_global_bundle_adjustment(mapper, axes_mesh))
        p, x = _ring_errors(mapper, truth)
        same = _same_map(mapper, ref)
        note(f"dist GBA {name} ({cfg['ring']['n_kf']} KF, {len(blk.pt_ids_glob)} points + "
             f"{len(blk.ls_ids_glob)} lines in {len(blk.metas)} chunks): bit-identical to the "
             f"chunked GBA on the same partition {same}; pose {pre_p:.6f} -> {p:.6f}, points "
             f"{pre_x:.6f} -> {x:.6f} m; single-device {single_p:.6f}, {single_x:.6f}; "
             f"{ms['dist_gba ' + name]:.3f} ms, single {ms['single_gba']:.3f} ms")
        if not (same and p < pre_p and x < pre_x and x < max(1.5 * single_x, 0.01)
                and np.isfinite(np.stack([k.T_w_k for k in mapper.map.keyframes])).all()):
            raise AssertionError(f"dist GBA {name}: same {same}, pose {pre_p}->{p}, points "
                                 f"{pre_x}->{x}, single {single_x}")

    # BatchedVisualOdometry(sharding=) against the unsharded batch
    B, F = cfg["b"], cfg["frames"]
    sc = SyntheticScene(seed=0, **cfg["scene"])
    bcam = StereoCamera.create(sc.fx, sc.fy, sc.cx, sc.cy, sc.b, width=sc.width,
                               height=sc.height)
    fcfg, tcfg = FrontendConfig(**cfg["widths"]), TrackerConfig()
    L = [torch.from_numpy(np.ascontiguousarray(np.stack([st[i, 0] for st in streams[:B]])))
         .to(dev) for i in range(F + 1)]
    R = [torch.from_numpy(np.ascontiguousarray(np.stack([st[i, 1] for st in streams[:B]])))
         .to(dev) for i in range(F + 1)]
    seq = make_mesh("seq", dev.type)

    def track(sharding):
        """The gathered results, and the launches counted after the first
        frame (whose ``process`` captures the step: warm-up calls included)."""
        bvo = BatchedVisualOdometry(B, bcam, fcfg, tcfg, device=dev, sharding=sharding)
        bvo.initialize(L[0], R[0])
        out = [bvo.gather_result(bvo.process(L[1], R[1]))]
        first = {k: fn.launches for k, fn in wrappers.items()}
        out += [bvo.gather_result(bvo.process(L[i], R[i])) for i in range(2, F + 1)]
        return out, first

    _sync(dev)
    for fn in wrappers.values():
        fn.launches = 0
    (sharded, first), ms["dist_batch_vo"] = _timed(dev, lambda: track(seq))
    bvo_launches = {k: fn.launches for k, fn in wrappers.items()}
    # the unsharded batch on rank 0, then sharded again: the order's share of the times
    plain = None
    if rank == 0:
        (plain, _), ms["batch_vo"] = _timed(dev, lambda: track(None))
    (again, _), ms["dist_batch_vo again"] = _timed(dev, lambda: track(seq))
    repeat = all(torch.equal(a, c) for rs, ra in zip(sharded, again) for a, c in zip(rs, ra))
    good = torch.stack([r.good for r in sharded])
    if plain is not None:
        bitwise = all(torch.equal(a, b) for rs, rp in zip(sharded, plain) for a, b in zip(rs, rp))
        dT = max(float((rs.T_f_w - rp.T_f_w).abs().max()) for rs, rp in zip(sharded, plain))
        dn = max(int((rs.n_inliers - rp.n_inliers).abs().max()) for rs, rp in zip(sharded, plain))
        good_eq = all(torch.equal(rs.good, rp.good) for rs, rp in zip(sharded, plain))
        note(f"dist batch VO B={B} over {n} rank(s), {F} frames (+ init): against the unsharded "
             f"batch bitwise {bitwise}, max |T_f_w diff| {dT:.3g}, max |inlier diff| {dn}, good "
             f"equal {good_eq}; the two sharded runs bit-identical {repeat}; "
             f"{int(good.sum())}/{good.numel()} stream-frames good; {ms['dist_batch_vo']:.3f} ms "
             f"sharded, {ms['batch_vo']:.3f} ms unsharded, {ms['dist_batch_vo again']:.3f} ms "
             f"sharded again; launches {bvo_launches}")
        # one rank runs the unsharded step's program: bit for bit; more ranks
        # run it at B / n streams, whose batched products round apart
        if not (good_eq and (bitwise if n == 1 else dT <= 2e-2 and dn <= 6)):
            raise AssertionError(f"sharded batch VO departs from the unsharded batch: bitwise "
                                 f"{bitwise}, dT {dT}, inliers {dn}, good {good_eq}")
    if not (repeat and bool(good.all())):
        raise AssertionError(f"sharded batch VO: repeat {repeat}, good {good.tolist()}")
    for k in kernels:
        per_frame = (bvo_launches[k] - first[k]) / (F - 1)
        if per_frame != FRAME_LAUNCHES[k]:
            raise AssertionError(f"sharded batch VO launched {k} {per_frame} times per frame, "
                                 f"want {FRAME_LAUNCHES[k]}")
    for k in launches:
        launches[k] += bvo_launches[k]
    note(f"dist: phase 11 took {time.perf_counter() - t_phase:.3f} s on {smi}")
    return launches, ms, lines


def phase_dist(dev, smi, streams, cfg=None):
    """Phase 11 at world 1: a process group of one rank (NCCL on the card;
    gloo for a CPU rehearsal) over a ``FileStore`` in a temporary
    directory, then ``run_dist``.  Returns its launches and times."""
    import torch.distributed as dist

    store_dir = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)      # the rank's card, before NCCL and the meshes
    t = time.perf_counter()
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.FileStore(os.path.join(store_dir, "store"), 1),
                            rank=0, world_size=1)
    say(f"dist: init_process_group took {time.perf_counter() - t:.3f} s")
    try:
        launches, ms, _ = run_dist(dev, smi, streams, cfg or DIST)
        return launches, ms
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store_dir, ignore_errors=True)


def start_eval_render():
    """Render phase 12's nuisance frames (e2e_robust's scene at 752x480,
    EVAL_FRAMES frames) in spawned worker processes during the build; the
    frames equal the serial render."""
    from plslam_tpu_torch import e2e_robust

    poses = e2e_robust.circular_trajectory(EVAL_FRAMES, step_t=0.02, step_r=0.002)
    return e2e_robust.FrameRender(e2e_robust.make_scene(), poses, RENDER_WORKERS)


def wait_eval_render(job) -> list:
    t = time.perf_counter()
    frames = job.result(timeout=900)
    say(f"build: phase 12's {len(frames)} nuisance pairs rendered ({RENDER_WORKERS} worker "
        f"processes; waited {time.perf_counter() - t:.3f} s)")
    return frames


def _by_thread(wrappers) -> dict:
    return {k: fn.launches_by_thread() for k, fn in wrappers.items()}


def _launches_since(before: dict, after: dict) -> dict:
    """Per kernel and thread, the launches between two ``_by_thread`` reads."""
    return {k: {t: n - before[k].get(t, 0) for t, n in after[k].items()
                if n - before[k].get(t, 0)} for k in after}


def phase_eval(dev, smi, frames):
    """Phase 12: the evaluation programs on the card (``e2e_robust`` through
    ``run_mode`` once per line mode, the others through their ``main``),
    each held to its bar against the JAX package's CPU values; returns the
    launches by kernel and thread over the whole phase and the values of
    the summary line."""
    from plslam_tpu_torch import (compare_line_modes, e2e_robust, endpoint_gba_ab,
                                  evaluate_ate, line_match_quality, loop_stress,
                                  train_vocabulary)
    from plslam_tpu_torch.backend import vocab

    # on the card each program runs at its default device, a bare "cuda"
    device_flag = [] if dev.type == "cuda" else ["--device", str(dev)]
    device_kw = {} if dev.type == "cuda" else {"device": str(dev)}
    wrappers = _wrappers()
    kernels = KERNEL_WRAPPERS if dev.type == "cuda" else ()
    for fn in wrappers.values():
        fn.launches = 0
    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_eval_")
    summary = {}
    try:
        # e2e_robust, both modes, each mode's launches read around its run
        scene = e2e_robust.make_scene()
        poses = e2e_robust.circular_trajectory(EVAL_FRAMES, step_t=0.02, step_r=0.002)
        e2e_robust.save_gt(work, poses)
        per_mode, rows = {}, []
        t = time.perf_counter()
        for plucker in (True, False):
            before = _by_thread(wrappers)
            rows.append(e2e_robust.run_mode(plucker, frames, poses, e2e_robust.camera(scene),
                                            work, **device_kw))
            per_mode[rows[-1]["mode"]] = _launches_since(before, _by_thread(wrappers))
        _sync(dev)
        say(f"eval e2e_robust: {EVAL_FRAMES} frames at {frames[0][0].shape[1]}x"
            f"{frames[0][0].shape[0]} in both modes in "
            f"{time.perf_counter() - t:.3f} s on {smi}")
        ate = {}
        for r in rows:
            good, nkf, jate, jate_max = JAX_CPU_E2E[r["mode"]]
            ate[r["mode"]] = a = r["ate_rmse_unrounded"]
            floor = max(2.0 * jate_max, 0.01)
            say(f"eval e2e_robust {r['mode']}: {r['good_frames']}/{r['frames']} good (JAX CPU "
                f"{good}), {r['keyframes']} keyframes (JAX CPU {nkf}), keyframe ATE {a:.6f} m "
                f"(floor {floor:.6f}, JAX CPU {jate:.6f}), path {r['path_len_m']} m, "
                f"{r['track_fps']} tracking frames/s; launches {per_mode[r['mode']]}")
            if not a <= floor:
                raise AssertionError(f"e2e_robust {r['mode']}: ATE {a} above floor {floor}")
            if not r["good_frames"] >= good - 0.05 * EVAL_FRAMES:
                raise AssertionError(f"e2e_robust {r['mode']}: {r['good_frames']} good frames, "
                                     f"JAX CPU {good}")
            for k in kernels:
                if sum(per_mode[r["mode"]][k].values()) <= 0:
                    raise AssertionError(f"e2e_robust {r['mode']}: {k} never launched")
            if kernels and per_mode[r["mode"]]["hamming_distance_matrix_cuda"].get(
                    MAPPER_THREAD, 0) <= 0:
                raise AssertionError(f"e2e_robust {r['mode']}: the mapping thread never "
                                     "launched the Hamming kernel")
        summary["e2e_gap"] = ate["endpoint"] - ate["plucker"]
        summary["e2e"] = ate
        say(f"eval e2e_robust: endpoint - Plücker keyframe ATE gap {summary['e2e_gap']:+.6f} m "
            f"(JAX CPU {JAX_CPU_E2E['endpoint'][2] - JAX_CPU_E2E['plucker'][2]:+.6f} m at "
            f"{EVAL_FRAMES} frames)")

        # the ATE tool on the Plücker dump against the ground truth
        got = evaluate_ate.main([os.path.join(work, "e2e_robust_plucker.tum"),
                                 os.path.join(work, "e2e_robust_gt.tum")])
        d = abs(got["ate_rmse"] - ate["plucker"])
        say(f"eval evaluate_ate: {got['ate_rmse']:.9f} m over {got['n_pairs']} pairs against "
            f"io/trajectory.ate_rmse {ate['plucker']:.9f} m (|diff| {d:.3g})")
        n_kf = {r["mode"]: r["keyframes"] for r in rows}["plucker"]
        if not (d <= 1e-6 and got["n_pairs"] == n_kf):
            raise AssertionError(f"evaluate_ate {got} vs ate_rmse {ate['plucker']}, {n_kf} "
                                 "keyframes")

        # the line-mode comparison, in full
        t = time.perf_counter()
        cmp = compare_line_modes.main(device_flag)
        _sync(dev)
        for mode, jate in JAX_CPU_COMPARE.items():
            a, floor = cmp[mode]["ate_rmse_m"], max(2.0 * jate, 0.01)
            say(f"eval compare_line_modes {mode}: keyframe ATE {a:.6f} m (floor {floor:.6f}, JAX "
                f"CPU {jate:.6f}), {cmp[mode]['keyframes']} keyframes")
            if not a <= floor:
                raise AssertionError(f"compare_line_modes {mode}: ATE {a} above floor {floor}")
        summary["compare_diff"] = cmp["difference_m"]
        say(f"eval compare_line_modes: |difference| {cmp['difference_m']:.6f} m over "
            f"{cmp['travel_m']:.2f} m in {time.perf_counter() - t:.3f} s on {smi}")

        # line-match quality, the eight rows
        t = time.perf_counter()
        rows = line_match_quality.main(device_flag)
        if len(rows) != len(JAX_CPU_LMQ):
            raise AssertionError(f"line_match_quality: {len(rows)} rows, JAX {len(JAX_CPU_LMQ)}")
        for r, (label, jm, jok) in zip(rows, JAX_CPU_LMQ):
            rate, jrate = 100.0 * r["wrong"] / max(r["matches"], 1), 100.0 * (jm - jok) / jm
            ok = (r["label"] == label and abs(rate - jrate) <= 1.0
                  and abs(r["correct"] - jok) <= 0.02 * jok)
            say(f"eval line_match_quality {label}: wrong {rate:.2f}% (JAX CPU {jrate:.2f}%), "
                f"correct {r['correct']} (JAX CPU {jok}), matches {r['matches']} (JAX CPU {jm})")
            if not ok:
                raise AssertionError(f"line_match_quality {label}: {r} vs JAX {jm}, {jok}")
        summary["lmq_production"] = 100.0 * rows[1]["wrong"] / max(rows[1]["matches"], 1)
        say(f"eval line_match_quality: {len(rows)} rows in {time.perf_counter() - t:.3f} s on {smi}")

        # the endpoint-GBA oracle
        t = time.perf_counter()
        gba = endpoint_gba_ab.main(device_flag)
        o = gba["oracle_endpoint_f64"]
        for name in ("ours_plucker", "ours_endpoint"):
            want = JAX_CPU_GBA[name]
            say(f"eval endpoint_gba_ab {name}: median point error {gba[name]['pt']:.6f} m (JAX "
                f"CPU {want:.6f}; before {gba['pre']['pt']:.6f}), "
                f"{1e3 * gba[name]['wall_s']:.3f} ms")
        pt_a, pt_b, pre = gba["ours_plucker"]["pt"], gba["ours_endpoint"]["pt"], gba["pre"]["pt"]
        jb = JAX_CPU_GBA["ours_endpoint"]
        if not (pt_a < pre and pt_a <= GBA_PLUCKER_RATIO * JAX_CPU_GBA["ours_plucker"]
                and pt_b < pre and abs(pt_b - jb) <= max(0.10 * jb, 5e-4)):
            raise AssertionError(f"endpoint_gba_ab: {gba['ours_plucker']}, {gba['ours_endpoint']}"
                                 f" vs JAX {JAX_CPU_GBA}, before {pre}")
        d_cost = abs(o["cost_hist"][-1] / JAX_CPU_GBA["oracle_last"] - 1)
        d_pt = abs(o["pt"] / JAX_CPU_GBA["oracle_pt"] - 1)
        say(f"eval endpoint_gba_ab oracle: {o['iters_used']} iterations (JAX CPU "
            f"{JAX_CPU_GBA['oracle_iters']}), cost {o['cost_hist'][0]:.6g} -> "
            f"{o['cost_hist'][-1]:.10g} (relative to JAX CPU {d_cost:.3g}), median point "
            f"error {o['pt']:.9f} m (relative {d_pt:.3g}); first Jacobian call "
            f"{o['first_call_s']:.3f} s, solve {o['wall_s']:.3f} s; phase step "
            f"{time.perf_counter() - t:.3f} s on {smi}")
        if not (o["iters_used"] == JAX_CPU_GBA["oracle_iters"] and d_cost <= 1e-6
                and d_pt <= 1e-6):
            raise AssertionError(f"endpoint_gba_ab oracle: iterations {o['iters_used']}, cost "
                                 f"{d_cost}, point error {d_pt} relative to JAX")
        summary["gba"] = (gba["ours_plucker"]["pt"], gba["ours_endpoint"]["pt"], o["pt"])

        # the loop-closure stress at full size
        t = time.perf_counter()
        before = _by_thread(wrappers)
        log, handler = logging.getLogger("plslam"), _Messages()
        log.addHandler(handler)
        try:
            out = loop_stress.main(device_flag)
        finally:
            log.removeHandler(handler)
        stress = _launches_since(before, _by_thread(wrappers))
        jumps = [float(m.split("max pose jump ")[1].split(" m")[0]) for m in handler.messages
                 if m.startswith("local BA discarded")]
        say(f"eval loop_stress: {out['keyframes']} keyframes, closures {out['closures']}, conf "
            f"rows {out['conf_rows']} in {time.perf_counter() - t:.3f} s; launches {stress} "
            f"on {smi}")
        say(f"eval loop_stress: local BAs discarded by the divergence guard {len(jumps)}, pose "
            f"jumps {jumps} m (JAX CPU {len(JAX_CPU_STRESS_DISCARDS)}, "
            f"{JAX_CPU_STRESS_DISCARDS} m) on {smi}")
        if kernels and stress["hamming_distance_matrix_cuda"].get(LOOP_THREAD, 0) <= 0:
            raise AssertionError("loop_stress: the loop-closure thread never launched Hamming")
        if len(jumps) > len(JAX_CPU_STRESS_DISCARDS):
            raise AssertionError(f"loop_stress: {len(jumps)} local BAs discarded (jumps {jumps} "
                                 f"m), JAX {len(JAX_CPU_STRESS_DISCARDS)}")
        summary["closures"] = out["closures"]

        # the vocabulary trainer, cut to VOCAB_SCENES x VOCAB_FRAMES
        t = time.perf_counter()
        paths = train_vocabulary.main([os.path.join(work, "vocab"), "--scenes",
                                       str(VOCAB_SCENES), "--frames", str(VOCAB_FRAMES),
                                       *device_flag])
        words = [vocab.load_dbow2_vocabulary(p).num_words for p in paths]
        say(f"eval train_vocabulary: {VOCAB_SCENES} scene x {VOCAB_FRAMES} frames, words {words}"
            f" loaded back in {time.perf_counter() - t:.3f} s")
        if words != [train_vocabulary.K ** train_vocabulary.DEPTH] * 2:
            raise AssertionError(f"train_vocabulary: words {words}")

        if importlib.util.find_spec("matplotlib") is None:
            say("eval plots: not rendered: the card's machine has no matplotlib (viz.py is held "
                "pixel for pixel against the JAX package on the CPU)")
        else:
            from plslam_tpu_torch import viz
            from plslam_tpu_torch.evaluate_ate import read_tum

            est = read_tum(os.path.join(work, "e2e_robust_plucker.tum"))[1]
            traj = np.tile(np.eye(4), (len(est), 1, 1))
            traj[:, :3, 3] = est
            path = viz.plot_trajectory(traj, os.path.join(work, "trajectory.png"),
                                       gt=read_tum(os.path.join(work, "e2e_robust_gt.tum"))[1])
            say(f"eval plots: {os.path.basename(path)} of the Plücker run rendered")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    launches = _by_thread(wrappers)
    total = {k: sum(v.values()) for k, v in launches.items()}
    say(f"eval: phase 12 took {time.perf_counter() - t_phase:.3f} s; launches {total} on {smi}")
    for k in kernels:
        if total[k] <= 0:
            raise AssertionError(f"kernel {k} never launched on the evaluation path")
    return launches, summary


def phase_bench(dev, smi, frames, slam_pairs, streams):
    """Phase 13: each benchmark twin's ``run`` in this process on frames
    already staged (phase 4's for ``bench``, phase 5's for ``bench_slam``,
    phase 10's streams for ``bench_batch_vo``), ``bench_dist_gba`` at N_KF
    128 over one NCCL rank per visible card; every JSON line printed, each
    held to its bar.  Returns the launches by kernel over the phase."""
    from plslam_tpu_torch import bench, bench_batch_vo, bench_dist_gba, bench_slam

    t_phase = time.perf_counter()
    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0

    def progress(name):
        return lambda msg: say(f"bench twins: {name}: {msg}")

    # bench: every frame of every window good, as many as bench.py's best
    # window on the CPU, 2 / 4 / 4 launches per timed frame
    vo = bench.run(frames, device=dev, say=progress("bench"))
    say(json.dumps(vo["line"]))
    goods = [[bool(r.good) for r in w] for w in vo["results"]]
    say(f"bench twins: bench good frames per window {[sum(g) for g in goods]} of "
        f"{bench.N_FRAMES}, best window {vo['good']}/{bench.N_FRAMES} (JAX bench.py on the CPU "
        f"{JAX_CPU_BENCH_GOOD}/{bench.N_FRAMES}); launches per timed frame {vo['launches']} on "
        f"{smi}")
    if not (all(map(all, goods)) and vo["good"] == JAX_CPU_BENCH_GOOD):
        raise AssertionError(f"bench: good frames {goods}, JAX {JAX_CPU_BENCH_GOOD}")
    if vo["launches"] != {k: float(n) for k, n in FRAME_LAUNCHES.items()}:
        raise AssertionError(f"bench: launches per frame {vo['launches']}, want {FRAME_LAUNCHES}")

    # bench_slam: the keyframes within 1 of JAX's, the LM at phase 6's bar
    sl = bench_slam.bench_slam(slam_pairs, device=dev)
    lm = bench_slam.bench_ba_iters(device=dev)
    for line in bench_slam.json_lines(sl["fps"], lm["iters_per_s"]):
        say(json.dumps(line))
    say(f"bench twins: bench_slam keyframes {sl['n_kf']} (JAX bench_slam.py on the CPU "
        f"{JAX_CPU_BENCH_SLAM_KF}), good {sum(sl['good'])}/{len(sl['good'])}, program captures "
        f"inside the timed window {sl['captures'] or 'none'} (allocator cache releases before "
        f"them {sl['releases']}); LM cost {lm['cost0']:.6g} -> "
        f"{lm['cost']:.6g} after {bench_slam.LM_ITERS} trips on {smi}")
    if abs(sl["n_kf"] - JAX_CPU_BENCH_SLAM_KF) > 1 or not all(sl["good"]):
        raise AssertionError(f"bench_slam: {sl['n_kf']} keyframes (JAX {JAX_CPU_BENCH_SLAM_KF}), "
                             f"good {sl['good']}")
    if not (np.isfinite(lm["cost"]) and lm["cost"] < 1e-3 * lm["cost0"]):
        raise AssertionError(f"bench_slam: LM did not converge: {lm['cost0']} -> {lm['cost']}")

    # bench_batch_vo: every stream's every timed frame good at every B
    by_stream = [[tuple(torch.from_numpy(st[i, side]).to(dev) for side in (0, 1))
                  for i in range(st.shape[0])] for st in streams]
    bv = bench_batch_vo.run(by_stream, device=dev, say=progress("bench_batch_vo"))
    del by_stream
    for line in bv["lines"]:
        say(json.dumps(line))
    for B, r in bv["runs"].items():
        if not r["good"].all():
            raise AssertionError(f"bench_batch_vo B={B}: frames lost tracking (frame, stream): "
                                 f"{np.argwhere(~r['good']).tolist()}")
        if r["launches"] != {k: float(n) for k, n in FRAME_LAUNCHES.items()}:
            raise AssertionError(f"bench_batch_vo B={B}: launches per frame {r['launches']}")
    launches = {k: fn.launches for k, fn in wrappers.items()}

    # bench_dist_gba: the JAX script's ring map and chunks; every form under
    # the error before it, the mesh forms within max(1.5x, 0.01 m) of single
    dg = bench_dist_gba.run(device=dev)
    say(json.dumps(dg["line"]))
    w, line = dg["world"], dg["line"]
    meshes = bench_dist_gba.mesh_names(w, dev.type)
    want_chunks = JAX_CPU_DIST_GBA_CHUNKS.get(w)
    say(f"bench twins: bench_dist_gba over {w} rank(s): pre_err {dg['pre_err']!r} m (JAX "
        f"{JAX_CPU_DIST_GBA_PRE!r}), pt_err {dg['pt_err']}, chunks "
        f"{[line[m]['chunks'] for m in meshes]} (JAX {want_chunks}) on {smi}")
    if not abs(dg["pre_err"] - JAX_CPU_DIST_GBA_PRE) <= 1e-6:
        raise AssertionError(f"bench_dist_gba: pre_err {dg['pre_err']}, JAX {JAX_CPU_DIST_GBA_PRE}")
    if want_chunks is not None and any(line[m]["chunks"] != want_chunks for m in meshes):
        raise AssertionError(f"bench_dist_gba: chunks {line}, JAX {want_chunks}")
    single = dg["pt_err"]["single"]
    for form, err in dg["pt_err"].items():
        if not (err < dg["pre_err"] and (form == "single" or err < max(1.5 * single, 0.01))):
            raise AssertionError(f"bench_dist_gba {form}: pt_err {err}, before {dg['pre_err']}, "
                                 f"single {single}")
    say(f"bench twins: phase 13 took {time.perf_counter() - t_phase:.3f} s; launches {launches} "
        f"on {smi}")
    for k in KERNEL_WRAPPERS:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} never launched on the bench path")
    return launches, [vo["line"], *bench_slam.json_lines(sl["fps"], lm["iters_per_s"]),
                      *bv["lines"], line]


def phase_programs(dev, smi, frames, poses):
    """Phase 14: the measurement programs and the demo on the card at full
    width, each graphed and held bit for bit against its ``capture=False``
    form.  Returns the launches by kernel over the phase."""
    from plslam_tpu_torch import (ab_fused_step, demo_synthetic, profile_detect,
                                  profile_mapping, roofline)
    from plslam_tpu_torch.bench import SCENE, WIDTHS, camera
    from plslam_tpu_torch.frontend.frame import FrontendConfig
    from plslam_tpu_torch.frontend.tracker import TrackerConfig
    from plslam_tpu_torch.io import SyntheticScene, ate_rmse
    from plslam_tpu_torch.vo import VisualOdometry

    t_phase = time.perf_counter()
    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    # the earlier phases' cached blocks stay: a capture that needs them
    # has graphs.Program empty the cache first
    if dev.type == "cuda":
        say(f"programs: phase 14 meets {torch.cuda.memory_reserved() / 2**30:.3f} GiB reserved, "
            f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated, "
            f"{torch.cuda.mem_get_info()[0] / 2**30:.3f} GiB free on {smi}")

    # roofline: every program graphed, its output on input 0 the eager one's
    rf = roofline.run(dev)
    for line in roofline.report(rf):
        say(f"roofline: {line}")
    say(json.dumps({"roofline": [{k: v for k, v in r.items() if k != "kernels"}
                                 for r in rf["rows"]], "card": smi}))
    # the profiler's busy time and the peaks' bound exist on the card only
    keys = ("ms", "gflop", "mb_unfused", "mb_program") + (
        ("busy_ms", "bound_ms") if dev.type == "cuda" else ())
    for r in rf["rows"]:
        say(f"roofline: {r['stage']}: kernels {r['kernels']}")
        vals = [r[k] for k in keys]
        if not (r["graphed"] and r["bits_equal"] and all(np.isfinite(vals))
                and min(vals) > 0):
            raise AssertionError(f"roofline {r['stage']}: {r}")

    # profile_detect: every row graphed, bit for bit its eager output
    pdr = profile_detect.run(dev, say=lambda m: say(f"profile_detect: {m}"))
    bad = [r["stage"] for r in pdr["rows"] if not (r["graphed"] and r["bits_equal"]
                                                   and np.isfinite(r["ms"]))]
    if bad:
        raise AssertionError(f"profile_detect rows not graphed or not bit for bit: {bad}")

    # ab_fused_step on phase 4's frames: every timed frame good in both
    # forms, each form's last window bit for bit the same window run
    # eagerly, the scan form's poses within the phase-4 ATE floor
    ab = ab_fused_step.run(AB_ROUNDS, frames=frames, device=dev,
                           say=lambda m: say(f"ab_fused_step: {m}"))
    say(f"ab_fused_step: median {ab['median']}, best {ab['best']} frames/s on {smi}")
    first = ab_fused_step.N_WARMUP
    gt = np.stack([p[:3, 3] for p in poses[first:first + ab_fused_step.N_FRAMES]])
    cam = camera(SyntheticScene(**SCENE))
    for name, early in (("A(early)", True), ("B(scan)", False)):
        res = ab["results"][name]
        vo = VisualOdometry(cam, FrontendConfig(**WIDTHS), TrackerConfig(early_exit=early),
                            device=dev, capture=False)
        _, ref = ab_fused_step.window(vo, frames)
        same = sum(results_equal(a, b) for a, b in zip(res, ref))
        est = np.stack([r.T_f_w.cpu().numpy()[:3, 3] for r in res])
        ate = ate_rmse(est, gt, align=False)
        good = [bool(r.good) for r in res]
        say(f"ab_fused_step {name}: {sum(good)}/{len(good)} timed frames good, {same}/"
            f"{len(res)} results bit for bit the eager window's, ATE {ate:.6f} m (floor "
            f"{ATE_FLOOR:.6f}) on {smi}")
        if not (all(good) and same == len(res) and ate <= ATE_FLOOR):
            raise AssertionError(f"ab_fused_step {name}: good {good}, {same} equal, ATE {ate}")

    # profile_mapping on phase 4's first 15 frames, graphed and eager
    pm = profile_mapping.run(dev, frames=frames[:profile_mapping.N_KF + 1])
    for line in profile_mapping.report(pm):
        say(f"profile_mapping: {line}")
    pm_e = profile_mapping.run(dev, frames=frames[:profile_mapping.N_KF + 1], capture=False)
    if not (bits_equal(torch.from_numpy(pm["trajectory"]), torch.from_numpy(pm_e["trajectory"]))
            and pm["mapper"].map.n_pt == pm_e["mapper"].map.n_pt):
        raise AssertionError("profile_mapping: the graphed map departs from the eager one")
    say(f"profile_mapping: graphed map == eager map ({pm['mapper'].map.n_pt} points, "
        f"keyframe poses bit for bit) on {smi}")

    # the demo: every frame good, keyframe ATE under the floor, the
    # artifacts written, graphed == eager keyframe trajectory
    with tempfile.TemporaryDirectory(prefix="chip_smoke_demo_") as out:
        demo = demo_synthetic.run(DEMO_FRAMES, os.path.join(out, "graphed"), device=dev,
                                  say=lambda m: say(f"demo: {m.strip()}"))
        demo_e = demo_synthetic.run(DEMO_FRAMES, os.path.join(out, "eager"), device=dev,
                                    capture=False)
        sizes = {os.path.basename(f): os.path.getsize(f) for f in demo["files"]}
    n_kf = len(demo["trajectory"])
    say(f"demo ({DEMO_FRAMES} frames): {sum(demo['good'])}/{len(demo['good'])} good, {n_kf} "
        f"keyframes (JAX CPU {JAX_CPU_DEMO_KF}), ATE {demo['ate']:.6f} m (floor "
        f"{DEMO_ATE_FLOOR:.6f}, JAX CPU {JAX_CPU_DEMO_ATE:.6f}), {demo['seconds']:.3f} s; eager "
        f"{demo_e['seconds']:.3f} s; artifacts {sizes} on {smi}")
    if not (all(demo["good"]) and len(demo["good"]) == DEMO_FRAMES - 1
            and demo["ate"] <= DEMO_ATE_FLOOR and all(sizes.values())):
        raise AssertionError(f"demo: good {demo['good']}, ATE {demo['ate']}, files {sizes}")
    if not bits_equal(torch.from_numpy(demo["trajectory"]), torch.from_numpy(demo_e["trajectory"])):
        raise AssertionError("demo: the graphed keyframe trajectory departs from the eager one")

    launches = {k: fn.launches for k, fn in wrappers.items()}
    say(f"programs: phase 14 took {time.perf_counter() - t_phase:.3f} s; launches {launches} "
        f"on {smi}")
    for k in KERNEL_WRAPPERS:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} never launched on the programs' path")
    return launches


def say_graphs(after: str, smi: str, since: dict | None = None) -> dict:
    """The process's CUDA graphs so far: captures, replays, the graphs
    still alive once garbage is collected and their pools' bytes, and the
    allocator cache releases before a capture (all, and since the
    ``graphs.stats()`` of ``since``, the previous call's return); and the
    card's memory: allocated, of it in graphs' private pools, reserved by
    the caching allocator, and free.  Returns this call's stats."""
    from plslam_tpu_torch import graphs

    gc.collect()
    st = graphs.stats()
    private = sum(seg["allocated_size"] for seg in torch.cuda.memory_snapshot()
                  if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0))
    phase = st["releases"] - (since or {}).get("releases", 0)
    say(f"graphs after {after}: {st['captures']} captured, {st['replays']} replays, "
        f"{st['live']} alive holding {st['pool_bytes'] / 2**20:.3f} MiB of pools; cache releases "
        f"{st['releases']} ({phase} in this phase) giving back "
        f"{st['released_bytes'] / 2**30:.3f} GiB; memory allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB ({private / 2**30:.3f} in private "
        f"pools), reserved {torch.cuda.memory_reserved() / 2**30:.3f} GiB, free "
        f"{torch.cuda.mem_get_info()[0] / 2**30:.3f} GiB on {smi}")
    return st


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

    fixture = writer = render = eval_render = None
    try:
        if not args.kernels:
            fixture = tempfile.mkdtemp(prefix="chip_smoke_disk_")
            writer = start_disk_fixture(fixture)
            render = start_batch_render()
            eval_render = start_eval_render()
        return run_phases(args, dev, smi, kind, fixture, writer, render, eval_render)
    finally:
        if writer is not None and writer.poll() is None:
            writer.kill()
            writer.wait()
        if render is not None:
            render[0].shutdown(cancel_futures=True)
        if eval_render is not None:
            eval_render.close()
        if fixture is not None:
            shutil.rmtree(fixture, ignore_errors=True)


def run_phases(args, dev, smi, kind, fixture, writer, render=None, eval_render=None) -> int:
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
    eval_frames = wait_eval_render(eval_render) if eval_render is not None else None

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
    launches, fps, ate, vo_prof = phase_main_path(dev, scene, poses, frames, smi)
    st = say_graphs("main path", smi)
    slam_launches, slam_fps, slam_ate, slam_pairs = phase_slam(dev, scene, smi)
    st = say_graphs("slam", smi, st)
    lm_ips = phase_local_ba(dev, smi)
    ep_launches, ep_fps, ep_ate = phase_endpoint_slam(dev, scene, smi)
    st = say_graphs("endpoint slam", smi, st)
    # a fresh process has room for every capture of phases 4-7
    if st["releases"]:
        raise AssertionError(f"phases 4-7 emptied the allocator's cache {st['releases']} times")
    loop_launches, loop_kf_s = phase_loop_closure(dev, smi)
    disk_launches, disk_fps, disk_ate, remap_us = phase_disk(dev, smi, fixture)
    st = say_graphs("disk", smi, st)
    batch_launches, batch_rows, batch_ates = phase_batch(dev, smi, streams)
    st = say_graphs("batch", smi, st)
    rgbd_launches, rgbd_err = phase_rgbd(dev, smi)
    dist_launches, dist_ms = phase_dist(dev, smi, streams)
    eval_launches, ev = phase_eval(dev, smi, eval_frames)
    st = say_graphs("eval", smi, st)
    bench_launches, bench_lines = phase_bench(dev, smi, frames, slam_pairs, streams)
    st = say_graphs("bench twins", smi, st)
    program_launches = phase_programs(dev, smi, frames, poses)
    say_graphs("programs", smi, st)
    for k in report:
        by_thread = {"slam": slam_launches[k["name"]], "slam_endpoint": ep_launches[k["name"]],
                     "loop": loop_launches[k["name"]], "disk": disk_launches[k["name"]],
                     "eval": eval_launches[k["name"]]}
        by_path = {"vo": launches[k["name"]], **by_thread, "batch": batch_launches[k["name"]],
                   "rgbd": rgbd_launches[k["name"]], "dist": dist_launches[k["name"]],
                   "bench": bench_launches[k["name"]], "programs": program_launches[k["name"]]}
        k["launches"] = (by_path["vo"] + by_path["batch"] + by_path["rgbd"] + by_path["dist"]
                         + by_path["bench"] + by_path["programs"]
                         + sum(sum(v.values()) for v in by_thread.values()))
        k["launches_by_path"] = by_path
    assert_no_jax()
    say(f"main path: graphed {fps['graphed']:.3f}, eager {fps['eager']:.3f} frames/s (median "
        f"window), ATE {ate:.6f} m; device busy graphed {100 * vo_prof['graphed']['busy_share']:.2f}%"
        f", eager {100 * vo_prof['eager']['busy_share']:.2f}% on {smi}")
    say(f"slam path: graphed {slam_fps['graphed']:.3f}, eager {slam_fps['eager']:.3f} frames/s, "
        f"keyframe ATE {slam_ate:.6f} m; local BA graphed {lm_ips['graphed']:.3f}, eager "
        f"{lm_ips['eager']:.3f} LM iterations/s on {smi}")
    say(f"endpoint slam path: graphed {ep_fps['graphed']:.3f}, eager {ep_fps['eager']:.3f} "
        f"frames/s, keyframe ATE {ep_ate:.6f} m; loop replay graphed {loop_kf_s['graphed']:.3f}, "
        f"eager {loop_kf_s['eager']:.3f} keyframes/s on {smi}")
    say(f"disk path: {disk_fps:.3f} CLI frames/s, keyframe ATE {disk_ate:.6f} m; device remap "
        f"{remap_us:.3f} us per pair on {smi}")
    fps_by_b = {B: (round(r["frames_per_s"], 3), round(r["eager_frames_per_s"], 3))
                for B, r in batch_rows.items()}
    say(f"batch path: aggregate frames/s (graphed, eager) by B {fps_by_b}, B={BATCH_ATE_B} ATEs "
        f"{[round(a, 6) for a in batch_ates]} m; RGB-D track error {rgbd_err:.6f} m on {smi}")
    dist_rounded = {k: round(v, 3) for k, v in dist_ms.items()}
    say(f"dist path (world 1): program ms {json.dumps(dist_rounded)} on {smi}")
    say(f"eval path: e2e_robust ({EVAL_FRAMES} frames) keyframe ATE Plücker "
        f"{ev['e2e']['plucker']:.6f} m, endpoint {ev['e2e']['endpoint']:.6f} m (gap "
        f"{ev['e2e_gap']:+.6f}); compare_line_modes |difference| {ev['compare_diff']:.6f} m; "
        f"production line wrong-match rate {ev['lmq_production']:.2f}%; endpoint_gba_ab median "
        f"point errors (a, b, oracle) {[round(x, 6) for x in ev['gba']]} m; loop stress "
        f"closures {ev['closures']} on {smi}")
    walls = {k: v["wall_s"] for k, v in bench_lines[-1].items() if isinstance(v, dict)}
    say("bench twins: " + "; ".join(f"{ln['metric']} {ln['value']}" for ln in bench_lines
                                    if "metric" in ln) + f"; ring GBA wall s {walls} on {smi}")
    say(json.dumps({"batch_vo": list(batch_rows.values())}))
    say(json.dumps({"kernels": report}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
