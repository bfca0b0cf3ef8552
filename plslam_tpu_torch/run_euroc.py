"""Stereo SLAM over a sequence on disk: the reference's main
(``app/plslam_dataset.cpp``), counterpart of ``scripts/run_euroc.py``.

    python -m plslam_tpu_torch.run_euroc DATASET_DIR \\
        [--params euroc_params.yaml] [--config config_euroc.yaml] \\
        [-o OFFSET] [-n NMAX] [-s STEP] [--gt groundtruth.txt] \\
        [--out trajectory.txt] [--no-gba] [--native-loader] \\
        [--overlay-every N --overlay-dir DIR] [--device cuda|cpu]

Flags mirror the reference's -o/-n/-s/-c (app/plslam_dataset.cpp:195-218)
and the JAX script's; ``--device`` (default ``cuda``) picks where the
pipeline runs, and the CPU only when asked.  ``--native-loader`` reads
through ``io/loader.StereoLoader``: frames decode on host threads and are
rectified on the device; without it each pair is read and rectified on the
host (``io/euroc``).  A params file with ``images_subfolder_l/r`` keys
(KITTI and others) names the image folders; otherwise the EuRoC
mav0/cam*/data layout is searched.  Prints per-frame tracking stats every
10 frames, the host time of each stage (``wait`` for the decoded frame,
``upload``, ``rectify`` and ``process``, or ``read`` and ``process``
without the loader; ``STAGES``, from this thread's counters of
``utils/profiling``), and with ``--gt`` the JSON line
``{"ate_rmse_m", "n_keyframes"}`` last.  ``main(argv)`` runs in-process and
returns the pipeline, the stage times and the result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import threading
import time

import numpy as np

REPO_CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "configs")
# the printed stages and the counters of this thread that time them
STAGES = {"wait": "io.wait", "upload": "io.upload", "rectify": "io.rectify", "read": "io.read",
          "process": "pipeline.process"}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dataset_dir")
    ap.add_argument("--params", default=None,
                    help="camera yaml (reference euroc_params.yaml format)")
    ap.add_argument("--config", default=None, help="run config yaml")
    ap.add_argument("-o", "--offset", type=int, default=0)
    ap.add_argument("-n", "--nmax", type=int, default=0)
    ap.add_argument("-s", "--step", type=int, default=1)
    ap.add_argument("--gt", default=None, help="ground truth for ATE")
    ap.add_argument("--out", default="trajectory.txt")
    ap.add_argument("--no-gba", action="store_true")
    ap.add_argument("--native-loader", action="store_true",
                    help="prefetch on host threads and rectify on the device")
    ap.add_argument("--overlay-every", type=int, default=0, metavar="N",
                    help="render a per-frame diagnosis overlay (tracked features, f2f match "
                         "segments, residual ramp) + residual JSONL every N frames "
                         "(plotStereoFrame analog); 0 = off")
    ap.add_argument("--overlay-dir", default="overlays")
    ap.add_argument("--device", default="cuda", help="torch device of the pipeline")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)

    from .config import PLSLAMConfig
    from .core.camera import StereoCamera
    from .io.euroc import (EurocDataset, StereoDirDataset, load_euroc_calib, load_groundtruth,
                           load_params)
    from .io.trajectory import associate_timestamps, ate_rmse
    from .pipeline import PLSLAM
    from .utils.profiling import counters, per_call_ms, timed

    params = args.params or os.path.join(REPO_CONFIGS, "euroc_params.yaml")
    calib = load_euroc_calib(params)
    cam = StereoCamera.create(calib.fx, calib.fy, calib.cx, calib.cy, calib.baseline,
                              width=calib.width, height=calib.height)
    cfg = PLSLAMConfig.from_yaml(args.config) if args.config else PLSLAMConfig()
    if args.overlay_every:
        cfg = dataclasses.replace(cfg, overlay_every=args.overlay_every,
                                  overlay_dir=args.overlay_dir)
    slam = PLSLAM(cam, cfg, device=args.device)

    p = load_params(params)
    decimation = dict(offset=args.offset, nmax=args.nmax, step=args.step,
                      rectify_on_host=not args.native_loader)
    if "images_subfolder_l" in p:
        ds = StereoDirDataset(args.dataset_dir, calib, subfolder_l=p["images_subfolder_l"],
                              subfolder_r=p["images_subfolder_r"], **decimation)
    else:
        ds = EurocDataset(args.dataset_dir, calib, **decimation)

    loader = None
    if args.native_loader:
        from .io.loader import StereoLoader

        # identity maps (the already-rectified scalar form) would remap no pixel
        maps = None if calib.identity_maps else (calib.map_l, calib.map_r)
        loader = StereoLoader(ds.files_l, ds.files_r, calib.width, calib.height,
                              maps=maps, device=slam.device)
    before = counters()
    t_start = time.time()
    try:
        for i in range(len(ds)):
            if loader is not None:
                # one get per index: the loader hands each frame over once
                with timed("io.wait"):
                    pair = loader.take(i)
                with timed("io.upload"):
                    pair = loader.upload(pair)
                with timed("io.rectify"):
                    il, ir = loader.rectify(pair)
            else:
                with timed("io.read"):
                    il, ir, _ = ds[i]
            res = slam.process(il, ir, ds.timestamps[i])
            if res is not None and i % 10 == 0:
                print(f"frame {i}: inliers={int(res.n_inliers)} err={float(res.err):.4f} "
                      f"kf={bool(res.is_kf)} ({(time.time() - t_start) / max(i, 1):.3f}s/frame)",
                      flush=True)
    finally:
        if loader is not None:
            loader.close()
    wall = time.time() - t_start
    decode_ms = 1e3 * loader.decode_s / max(loader.n_decoded, 1) if loader else None
    slam.finish(run_gba=not args.no_gba)
    slam.save_trajectory_tum(args.out)
    print(f"saved {len(slam.mapper.map.keyframes)} keyframes to {args.out}")
    rows = per_call_ms(before, counters()).get(threading.current_thread().name, {})
    stages = {}
    for key, name in STAGES.items():
        if name in rows:
            ms, n = rows[name]
            stages[key] = {"total_s": round(ms * n / 1e3, 4), "mean_ms": round(ms, 3),
                           "count": n}
    print(f"stages: {json.dumps(stages)}; {len(ds) / max(wall, 1e-9):.3f} frames/s "
          f"over {len(ds)} frames", flush=True)

    out = {"slam": slam, "stages": stages, "decode_ms": decode_ms,
           "frames": len(ds), "seconds": wall}
    if args.gt:
        t_gt, pos_gt = load_groundtruth(args.gt)
        est = np.stack([T[:3, 3] for T in slam.keyframe_trajectory()])
        if t_gt is not None:
            ie, ig = associate_timestamps(slam.kf_timestamps, t_gt)
            est, pos_gt = est[ie], pos_gt[ig]
        else:
            n = min(len(est), len(pos_gt))
            est, pos_gt = est[:n], pos_gt[:n]
        err = ate_rmse(est, pos_gt, align=True)
        out.update(ate_rmse_m=err, n_keyframes=len(est))
        print(json.dumps({"ate_rmse_m": round(err, 4), "n_keyframes": len(est)}), flush=True)
    return out


if __name__ == "__main__":
    main()
