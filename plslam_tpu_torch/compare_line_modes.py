"""The reference's headline evaluation: endpoint-parameterized lines
against Pluecker/orthonormal lines on the same sequence (the port of
``scripts/compare_line_modes.py``).

The reference publishes one qualitative result: two trajectory plots and
the claim "only a small difference between them".  This runs both line
modes of ``PLSLAM`` over one rendered synthetic sequence
(``SyntheticScene(seed=5)`` at 376x240, 30 frames) and prints the aligned
keyframe ATE RMSE of each and their difference.

    python -m plslam_tpu_torch.compare_line_modes [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from .backend.mapping import MapConfig
from .config import PLSLAMConfig
from .core.camera import StereoCamera
from .io.synthetic import SyntheticScene, circular_trajectory
from .io.trajectory import ate_rmse
from .pipeline import PLSLAM

N_FRAMES = 30
DT = 0.05


def run_mode(plucker: bool, scene, cam, poses, device="cuda"):
    """(aligned keyframe ATE, keyframe count) of one line mode."""
    cfg = PLSLAMConfig(orb_nfeatures=512, lsd_nfeatures=128, orb_fast_th=15,
                       min_entropy_ratio=0.97, use_line_plucker=plucker)
    slam = PLSLAM(cam, cfg, MapConfig(local_ba_kf=8, ba_points=4096, ba_lines=256,
                                      ba_pobs=16384, ba_lobs=2048, plucker_lines=plucker),
                  device=device)
    frames = [scene.render_stereo(T) for T in poses]
    for i, (il, ir) in enumerate(frames):
        slam.process(il, ir, timestamp=DT * i)
    traj = slam.finish(run_gba=True)
    gt = np.stack([poses[int(round(t / DT))][:3, 3] for t in slam.kf_timestamps])
    est = np.stack([np.asarray(T)[:3, 3] for T in traj])
    return ate_rmse(est, gt, align=True), len(traj)


def main(argv=None, n_frames: int = N_FRAMES) -> dict:
    """Both modes; returns {"endpoint": ..., "plucker": ...} (ATE, keyframes)
    beside the travel and the |difference|."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    scene = SyntheticScene(seed=5)
    cam = StereoCamera.create(scene.fx, scene.fy, scene.cx, scene.cy, scene.b,
                              width=scene.width, height=scene.height)
    poses = circular_trajectory(n_frames, step_t=0.10, step_r=0.012)
    travel = sum(np.linalg.norm(poses[i + 1][:3, 3] - poses[i][:3, 3])
                 for i in range(len(poses) - 1))
    out = {"travel_m": float(travel)}
    for plucker in (False, True):
        name = "plucker" if plucker else "endpoint"
        ate, nkf = run_mode(plucker, scene, cam, poses, args.device)
        out[name] = {"ate_rmse_m": ate, "keyframes": nkf}
        print(f"{name:9s}: ATE RMSE {ate:.5f} m over {travel:.2f} m travel "
              f"({nkf} KFs)", flush=True)
    diff = abs(out["plucker"]["ate_rmse_m"] - out["endpoint"]["ate_rmse_m"])
    out["difference_m"] = diff
    print(f"|difference| = {diff:.5f} m "
          f"({100 * diff / max(travel, 1e-9):.2f}% of travel) — the "
          f"reference claims 'only a small difference between them'", flush=True)
    return out


if __name__ == "__main__":
    main()
