"""End-to-end demo on a rendered synthetic stereo sequence (the twin of
``examples/demo_synthetic.py``): the full SLAM pipeline (tracking, the
threaded mapping, local BA, the global BA at the end) on one GPU, each
frame's tracking stats, then the trajectory, the ATE and the
visualization artifacts in ``./demo_out``.

    python -m plslam_tpu_torch.demo_synthetic [n_frames] [--out DIR] [--device cuda|cpu]

Artifacts: ``trajectory.txt`` (TUM, ``io.trajectory``), ``frames.jsonl``
(per-frame metrics), ``scene.html`` (the interactive map, ``viz_scene``),
``residuals.jsonl`` (the last frame's tracked features and residuals,
``viz_frame``); where matplotlib is installed also the trajectory, map
and covisibility figures (``viz.render_run``) and the last frame's
overlay.  ``--device cpu`` runs the plain kernels.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys
import time

import numpy as np
import torch

from . import config as C
from . import viz_frame, viz_scene
from .backend.mapping import MapConfig
from .bench import camera, resolve_device
from .config import PLSLAMConfig
from .io.synthetic import SyntheticScene, circular_trajectory
from .io.trajectory import ate_rmse
from .pipeline import PLSLAM

N_FRAMES = 12
DT = 0.05  # frame period used for both timestamps and gt lookup
CONFIG = dict(orb_nfeatures=512, lsd_nfeatures=128, orb_fast_th=15, min_entropy_ratio=0.99)
MAP_CONFIG = dict(local_ba_kf=8, ba_points=2048, ba_lines=256, ba_pobs=8192, ba_lobs=2048)


def run(n_frames: int = N_FRAMES, out: str = "demo_out", *, device="cuda", capture: bool = True,
        say=None) -> dict:
    """The demo: returns {"slam", "trajectory": (K, 4, 4), "ate", "seconds",
    "good": every tracked frame's flag, "files": the artifacts written}."""
    dev = torch.device(device)
    say = say or (lambda msg: None)
    os.makedirs(out, exist_ok=True)
    scene = SyntheticScene(seed=5)
    cfg = PLSLAMConfig(**CONFIG)
    slam = PLSLAM(camera(scene), cfg, MapConfig(**MAP_CONFIG), device=dev, capture=capture)
    poses_gt = circular_trajectory(n_frames, step_t=0.12, step_r=0.015)
    t0 = time.time()
    for i, T in enumerate(poses_gt):
        il, ir = (torch.from_numpy(x).to(dev) for x in scene.render_stereo(T))
        last = i == n_frames - 1 and i > 0
        prev = slam.vo.current_features if last else None
        res = slam.process(il, ir, timestamp=DT * i)
        if res is not None:
            lg = slam.logs[-1]
            say(f"frame {i:3d}: inliers={lg.n_inliers:3d} err={lg.err:.3f} kf={lg.is_kf}")
        if last:
            diag = viz_frame.compute_frame_diagnostics(prev, slam.vo.current_features, res.DT,
                                                       slam.cam, C.tracker(cfg))
            last_img = il.cpu().numpy()
    traj = np.stack(slam.finish(run_gba=True))
    seconds = time.time() - t0

    kf_pos = traj[:, :3, 3]
    gt_pos = np.stack([poses_gt[int(round(t / DT))][:3, 3] for t in slam.kf_timestamps])
    ate = ate_rmse(kf_pos, gt_pos, align=True)
    say(f"\n{len(traj)} keyframes in {seconds:.1f}s; ATE RMSE (aligned) = {ate:.4f} m")

    gt = np.stack(poses_gt)
    files = [os.path.join(out, "trajectory.txt"), os.path.join(out, "frames.jsonl")]
    slam.save_trajectory_tum(files[0])
    slam.save_logs_jsonl(files[1])
    files.append(viz_scene.export_scene_html(slam.mapper, os.path.join(out, "scene.html"), gt=gt))
    if n_frames > 1:
        files.append(os.path.join(out, "residuals.jsonl"))
        viz_frame.dump_residuals_jsonl(diag, files[-1], n_frames - 1)
    if importlib.util.find_spec("matplotlib") is not None:
        from . import viz

        files += viz.render_run(slam, out, gt=gt)[:3]
        if n_frames > 1:
            files.append(os.path.join(out, "overlay_last.png"))
            viz_frame.render_frame_overlay(last_img, diag, files[-1], frame_id=n_frames - 1)
    say(f"artifacts: {sorted(os.path.basename(f) for f in files)}")
    return {"slam": slam, "trajectory": traj, "ate": ate, "seconds": seconds,
            "good": [lg.good for lg in slam.logs], "files": files}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_frames", nargs="?", type=int, default=N_FRAMES)
    ap.add_argument("--out", default=os.path.join(os.getcwd(), "demo_out"))
    ap.add_argument("--device", default="cuda", help="cuda (default: card 0) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    run(args.n_frames, args.out, device=dev, say=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
