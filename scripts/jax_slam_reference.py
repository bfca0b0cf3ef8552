#!/usr/bin/env python3
"""The JAX package's PLSLAM on the CPU at chip_smoke.py's SLAM phases: the
reference values the port's smoke run is held against.

    PYTHONPATH=. JAX_PLATFORMS=cpu python scripts/jax_slam_reference.py slam
    PYTHONPATH=. JAX_PLATFORMS=cpu python scripts/jax_slam_reference.py endpoint
    PYTHONPATH=. JAX_PLATFORMS=cpu python scripts/jax_slam_reference.py ring

``slam``: phase 5, bench_slam.py's configuration (Plücker lines), 20
frames; prints the keyframe ATE (Umeyama-aligned, keyframes matched to
ground truth by timestamp).  ``endpoint``: phase 7, the same frames with
endpoint lines, the keyframe refinement and loop closure with the shipped
vocabularies.  ``ring``: phase 8, tests/test_scale_e2e.py's 156-keyframe
ring replay through loop closure; prints the loop reports and the ATEs.
Each takes 1-2 minutes on an 8-core CPU host.
"""

import argparse
import os
import sys

import jax.numpy as jnp
import numpy as np

from plslam_tpu.backend.mapping import MapConfig
from plslam_tpu.config import PLSLAMConfig
from plslam_tpu.core import lie
from plslam_tpu.core.camera import StereoCamera
from plslam_tpu.io.synthetic import SyntheticScene, circular_trajectory
from plslam_tpu.io.trajectory import ate_rmse
from plslam_tpu.pipeline import PLSLAM

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def image_run(endpoint: bool):
    s = SyntheticScene(n_points=600, n_lines=60, seed=0, width=752, height=480,
                       fx=435.2, fy=435.2, cx=367.4, cy=252.2)
    cam = StereoCamera.create(s.fx, s.fy, s.cx, s.cy, s.b, width=s.width, height=s.height)
    extra = {}
    if endpoint:
        extra = dict(use_line_plucker=False, use_loop_closure=True, has_refinement=True,
                     vocabulary_p=os.path.join(ROOT, "configs", "vocab_orb_k10L3.yml.gz"),
                     vocabulary_l=os.path.join(ROOT, "configs", "vocab_lbd_k10L3.yml.gz"))
    slam = PLSLAM(cam, PLSLAMConfig(orb_nfeatures=1200, lsd_nfeatures=256,
                                    min_entropy_ratio=0.99, **extra),
                  MapConfig(local_ba_kf=8, ba_points=2048, ba_lines=256, ba_pobs=8192,
                            ba_lobs=2048, plucker_lines=not endpoint,
                            has_refinement=endpoint))
    poses = circular_trajectory(20, step_t=0.05)
    for i, T in enumerate(poses):
        slam.process(*map(jnp.asarray, s.render_stereo(T, noise=1.0)), timestamp=0.05 * i)
    slam.wait_until_idle()
    traj = slam.finish(run_gba=True)
    gt = np.stack([poses[int(round(t / 0.05))][:3, 3] for t in slam.kf_timestamps])
    est = np.stack([np.asarray(T)[:3, 3] for T in traj])
    print(f"good {sum(lg.good for lg in slam.logs)}/{len(slam.logs)}, {len(traj)} keyframes"
          + (f", {len(slam.loop_closer.bow)} BoW records, loops {slam.loop_reports}"
             if endpoint else ""))
    print(f"keyframe ATE {ate_rmse(est, gt, align=True)} m aligned, "
          f"{ate_rmse(est, gt, align=False)} m without")


def _ate_translation(T_est, T_true) -> float:
    e = np.stack([T[:3, 3] for T in T_est])
    g = np.stack([T[:3, 3] for T in T_true])
    e = e - e[0] + g[0]
    return float(np.sqrt(((e - g) ** 2).sum(-1).mean()))


def ring_run():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from _map_fixtures import RingWorld, make_camera, render_ring_features

    cam = make_camera()
    world = RingWorld(n_pts=3000, n_ls=300, seed=5)
    slam = PLSLAM(cam, PLSLAMConfig(use_line_plucker=False, use_loop_closure=True),
                  MapConfig(use_lines=True, plucker_lines=False, local_ba_kf=8,
                            ba_points=512, ba_lines=64, ba_pobs=2048, ba_lobs=512))
    n = 156
    thetas = np.linspace(0.0, 2 * np.pi * n / 140.0, n, endpoint=False)
    T_true = [world.pose_at(th) for th in thetas]
    rng = np.random.default_rng(11)
    T_est = [T_true[0]]
    for i in range(1, n):
        rel = np.linalg.inv(T_true[i - 1]) @ T_true[i]
        eps = np.concatenate([rng.normal(0, 0.010, 3), rng.normal(0, 0.0025, 3)])
        T_est.append(T_est[-1] @ rel @ np.asarray(lie.exp_se3(jnp.asarray(eps))))
    for i in range(n):
        slam.insert_keyframe_features(T_est[i], render_ring_features(world, T_true[i], cam),
                                      timestamp=0.1 * i)
    slam.wait_until_idle()
    kfs = slam.mapper.map.keyframes
    print(f"loops {slam.loop_reports}")
    k = slam.loop_reports[-1]["kf"]
    print(f"ATE odometry {_ate_translation(T_est, T_true)} m, after the closure "
          f"{_ate_translation([kf.T_w_k for kf in kfs], T_true)} m; closure keyframe error "
          f"{np.linalg.norm(kfs[k].T_w_k[:3, 3] - T_true[k][:3, 3])} m")
    print(f"ATE after the GBA {_ate_translation(slam.finish(run_gba=True), T_true)} m")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("which", choices=("slam", "endpoint", "ring"))
    which = ap.parse_args().which
    if which == "ring":
        ring_run()
    else:
        image_run(endpoint=which == "endpoint")


if __name__ == "__main__":
    main()
