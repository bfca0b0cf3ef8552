#!/usr/bin/env python3
"""The JAX package's BatchedVisualOdometry on the CPU at chip_smoke.py's
batched phase: the reference ATEs the port's smoke run is held against.

    PYTHONPATH=. JAX_PLATFORMS=cpu python scripts/jax_batch_vo_reference.py [--batch 4]

scripts/bench_batch_vo.py's configuration: stream s renders
``SyntheticScene(600, 60, seed=s)`` at 752x480 along
``circular_trajectory(16, step_t=0.05)`` with noise 1.0; 1200 points, 256
line slots.  All streams are tracked in lockstep from frame 0 and each
stream's ATE (m, unaligned, all 16 poses, the first the identity) is
printed, as chip_smoke's phase 4 measures one stream.  Prints one JSON line.
Takes ~2 minutes on an 8-core CPU host at B = 4.
"""

import argparse
import json

import jax.numpy as jnp
import numpy as np

from plslam_tpu.batch_vo import BatchedVisualOdometry
from plslam_tpu.core.camera import StereoCamera
from plslam_tpu.frontend.frame import FrontendConfig
from plslam_tpu.frontend.tracker import TrackerConfig
from plslam_tpu.io.synthetic import SyntheticScene, circular_trajectory
from plslam_tpu.io.trajectory import ate_rmse

N_POSES = 16   # 1 + chip_smoke's 3 warm-up + 12 timed frames


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    B = ap.parse_args().batch
    poses = circular_trajectory(N_POSES, step_t=0.05)
    frames = []
    for s in range(B):
        scene = SyntheticScene(n_points=600, n_lines=60, seed=s, width=752, height=480,
                               fx=435.2, fy=435.2, cx=367.4, cy=252.2)
        frames.append([scene.render_stereo(T, noise=1.0) for T in poses])
    cam = StereoCamera.create(435.2, 435.2, 367.4, 252.2, 0.110074, width=752, height=480)
    bvo = BatchedVisualOdometry(B, cam, FrontendConfig(n_points=1200, n_lines=256),
                                TrackerConfig())

    def pair(i):
        return (np.stack([f[i][0] for f in frames]), np.stack([f[i][1] for f in frames]))

    bvo.initialize(*pair(0))
    results = [bvo.process(*pair(i)) for i in range(1, N_POSES)]
    gt = np.stack([T[:3, 3] for T in poses])
    ates, good = [], []
    for b in range(B):
        est = np.stack([np.zeros(3)] + [np.asarray(r.T_f_w[b])[:3, 3] for r in results])
        ates.append(float(ate_rmse(est, gt, align=False)))
        good.append(int(sum(bool(r.good[b]) for r in results)))
    print(json.dumps({"batch": B, "frames": N_POSES - 1, "ate_m": ates, "good": good,
                      "backend": str(jnp.zeros(1).devices())}))


if __name__ == "__main__":
    main()
