"""Loop-closure stress at reference scale with a distractor corridor and
online-vocabulary refresh (the port of ``tests/test_loop_stress.py``).

Ring A (the genuine revisit region), then corridor B (a distinct world
with the same geometric statistics: candidates there would be false
loops), then ring A again, rendered straight into keyframe features
(``io/ring_world``) along drifted odometry and fed to
``PLSLAM.insert_keyframe_features`` with endpoint lines, loop closure and
online vocabulary refresh.  The run holds candidate precision: every
closure pairs ring-A keyframes at matching angles, never a corridor
keyframe (lookForLoopCandidates gating, mapHandler.cpp:4241-4301), the
revisit pass closes, and the refreshed vocabulary's confusion matrix
stays aligned with the keyframe count.

    python -m plslam_tpu_torch.loop_stress [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .backend.mapping import MapConfig
from .config import PLSLAMConfig
from .convert import stereo_features_from_numpy
from .core import lie
from .core.camera import StereoCamera
from .io.ring_world import RingWorld, render_ring_features
from .pipeline import PLSLAM

N_A1 = 100           # first pass around ring A (a full revolution)
N_B = 60             # distractor corridor (a distinct world)
N_A2 = 30            # revisit pass over ring A


class ShiftedRing(RingWorld):
    """A second ring world displaced far from the first: the same geometry
    class with different random descriptors, a pure place-recognition
    distractor."""

    def __init__(self, offset, **kw):
        super().__init__(**kw)
        self.offset = np.asarray(offset, float)
        self.pts = self.pts + self.offset
        self.ls_A = self.ls_A + self.offset
        self.ls_B = self.ls_B + self.offset

    def pose_at(self, theta):
        T = super().pose_at(theta)
        T[:3, 3] += self.offset
        return T


def run(n_a1=N_A1, n_b=N_B, n_a2=N_A2, vocab_refresh_kfs=40, device="cuda",
        ring_steps=None, odo_seed=21, desc_seed=1234):
    """The replay: ring A's first pass (n_a1 keyframes, 2 pi / ring_steps
    apart; ring_steps defaults to n_a1, a full revolution), the corridor's
    half revolution (n_b; no self-revisit), the revisit of ring A's start
    (n_a2 on A's angular raster).  Returns (slam, layout): the keyframes'
    ring angles and the pass sizes, what ``check`` reads."""
    cam = StereoCamera.create(458.0, 457.0, 376.0, 240.0, 0.11, width=752, height=480)
    cam_k = tuple(float(v) for v in cam[:5])   # the f32-rounded intrinsics
    ring = RingWorld(n_pts=2200, n_ls=220, seed=5)
    corridor = ShiftedRing(offset=(0.0, 60.0, 0.0), n_pts=1600, n_ls=160, seed=77)
    cfg = PLSLAMConfig(use_line_plucker=False, use_loop_closure=True, multithread_slam=True,
                       vocab_refresh_kfs=vocab_refresh_kfs)
    mcfg = MapConfig(use_lines=True, plucker_lines=False, local_ba_kf=8, ba_points=512,
                     ba_lines=64, ba_pobs=2048, ba_lobs=512)
    slam = PLSLAM(cam, cfg, mcfg, device=device)

    worlds = [ring] * n_a1 + [corridor] * n_b + [ring] * n_a2
    steps = ring_steps or n_a1
    thetas = ([2 * np.pi * i / steps for i in range(n_a1)]
              + [np.pi * i / n_b for i in range(n_b)]
              + [2 * np.pi * i / steps for i in range(n_a2)])
    T_true = [w.pose_at(th) for w, th in zip(worlds, thetas)]
    rng = np.random.default_rng(odo_seed)
    T_est = [T_true[0]]
    for i in range(1, len(T_true)):
        rel = np.linalg.inv(T_true[i - 1]) @ T_true[i]
        eps = np.concatenate([rng.normal(0, 0.010, 3), rng.normal(0, 0.0025, 3)])
        T_est.append(T_est[-1] @ rel @ lie.exp_se3(torch.from_numpy(eps)).numpy())
    desc_rng = np.random.default_rng(desc_seed)
    for i, (w, T) in enumerate(zip(worlds, T_est)):
        feats = stereo_features_from_numpy(render_ring_features(w, T_true[i], cam_k, desc_rng),
                                           slam.device)
        slam.insert_keyframe_features(T, feats, timestamp=0.1 * i)
    slam.wait_until_idle()
    return slam, {"thetas": thetas, "n_a1": n_a1, "n_b": n_b, "steps": steps}


def check(slam, layout) -> dict:
    """The three properties of the stress over ``run``'s layout; raises
    AssertionError on a violation, else returns what was checked."""
    thetas, n_a1, n_b = layout["thetas"], layout["n_a1"], layout["n_b"]

    def in_ring_a(k):
        return k < n_a1 or k >= n_a1 + n_b

    reports = slam.loop_reports
    assert len(reports) >= 1, "no closure (online vocab + distractors)"
    sector = 2 * np.pi / layout["steps"]
    for r in reports:
        # every closure stays within ring A (the end of the first
        # revolution closing against its start is genuine too: the ring is
        # a physical loop) and never touches the distractor corridor
        assert in_ring_a(r["kf"]) and in_ring_a(r["candidate"]), \
            f"false loop into the distractor corridor: {r}"
        # ... and pairs matching ring angles (candidate precision)
        dth = abs(thetas[r["candidate"]] - thetas[r["kf"]])
        dth = min(dth, 2 * np.pi - dth)
        assert dth <= 3.0 * sector, (r, dth)
    # the revisit pass after the corridor must close as well
    assert any(r["kf"] >= n_a1 + n_b for r in reports), reports
    # the online vocabulary was refreshed: the conf matrix stays aligned
    lc = slam.loop_closer
    n_kf = len(slam.mapper.map.keyframes)
    assert lc is not None and lc.voc is not None
    assert lc.conf.shape[0] == n_kf, (lc.conf.shape, n_kf)
    return {"closures": [[int(r["kf"]), int(r["candidate"])] for r in reports],
            "keyframes": n_kf, "conf_rows": int(lc.conf.shape[0])}


def main(argv=None, **sizes) -> dict:
    """The stress at ``run``'s sizes (its keyword arguments in ``sizes``)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    slam, layout = run(device=args.device, **sizes)
    try:
        if slam._map_errors:
            raise slam._map_errors[0]
        out = check(slam, layout)
    finally:
        slam.finish(run_gba=False)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
