"""Hardened end-to-end evaluation (the port of ``scripts/e2e_robust.py``):
N frames of the full pipeline (image extraction, VO, threaded mapping and
local BA, the final chunked GBA) under photometric nuisances (rolling
illumination: exposure gain and black-level bias; sensor noise;
stereo-consistent textureless occluders) in both line parameterizations,
at the natural keyframe rate.  Prints one JSON line per mode (tracked
frames, keyframes, Umeyama-aligned keyframe ATE, path length, tracking
frames/s) and writes each mode's keyframe trajectory and the ground truth
as TUM files under ``--out``.

    python -m plslam_tpu_torch.e2e_robust [N_FRAMES] [--out DIR]
        [--default-caps] [--device cuda|cpu]

The frames are rendered in min(8, cores) processes: the scene's random
stream (occluder draws, then the left and the right noise image, frame by
frame) is replayed in this process in the serial order, and the workers
splat the noiseless views, so the frames equal a serial render.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import multiprocessing
import os
import sys
import tempfile
import time

import numpy as np

from .backend.mapping import MapConfig
from .config import PLSLAMConfig
from .core.camera import StereoCamera
from .io.synthetic import SyntheticScene, circular_trajectory
from .io.trajectory import ate_rmse, save_tum
from .pipeline import PLSLAM

DT = 0.05
NOISE = 2.0
SIZE = dict(width=752, height=480, fx=435.2, fy=435.2, cx=367.4, cy=252.2)


def make_scene(size=SIZE) -> SyntheticScene:
    """The scene (752x480 unless ``size`` gives other image dimensions and
    intrinsics), its depths redrawn so a long run keeps features in view."""
    scene = SyntheticScene(n_points=1600, n_lines=160, seed=3, **size)
    rng = np.random.default_rng(9)
    scene.P[:, 2] = rng.uniform(2.0, 30.0, len(scene.P))
    scene.LA[:, 2] = rng.uniform(2.0, 28.0, len(scene.LA))
    scene.LB[:, 2] = scene.LA[:, 2] + rng.uniform(-1.0, 1.0, len(scene.LB))
    return scene


def camera(scene: SyntheticScene) -> StereoCamera:
    return StereoCamera.create(scene.fx, scene.fy, scene.cx, scene.cy, scene.b,
                               width=scene.width, height=scene.height)


def save_gt(out_dir: str, poses) -> None:
    """The ground truth of the frames as ``e2e_robust_gt.tum``."""
    save_tum(os.path.join(out_dir, "e2e_robust_gt.tum"), DT * np.arange(len(poses)), poses)


def nuisance(i: int) -> tuple[float, float, int]:
    """Frame i's exposure gain, black-level bias and occluder count."""
    gain = 1.0 + 0.25 * np.sin(2 * np.pi * i / 150.0)
    bias = 8.0 * np.sin(2 * np.pi * i / 220.0)
    return gain, bias, 2 if i % 3 == 0 else 0


def _draws(scene: SyntheticScene, n: int) -> list:
    """The scene's random stream of a serial render of n frames, in its
    order: each frame's occluders, then the left and right noise images."""
    out = []
    for i in range(n):
        occ = [(float(scene.rng.uniform(-1.5, 1.5)), float(scene.rng.uniform(-1.0, 1.0)),
                float(scene.rng.uniform(1.2, 2.5)), float(scene.rng.uniform(0.15, 0.45)),
                float(scene.rng.uniform(0.15, 0.45))) for _ in range(nuisance(i)[2])]
        noise = [scene.rng.normal(0, NOISE, (scene.height, scene.width)).astype(np.float32)
                 for _ in range(2)]
        out.append((occ, noise))
    return out


def _clean_pair(scene: SyntheticScene, T_w_c: np.ndarray, occ) -> tuple:
    """Both views without gain, bias or noise (no random draw)."""
    T_c_w = np.linalg.inv(T_w_c)
    T_shift = np.eye(4)
    T_shift[0, 3] = -scene.b
    occ_r = [(x - scene.b, y, z, w2, h2) for x, y, z, w2, h2 in occ]
    return (scene._render(T_c_w, 0.0, 1.0, 0.0, occ or None),
            scene._render(T_shift @ T_c_w, 0.0, 1.0, 0.0, occ_r or None))


def _finish(i: int, clean, noise) -> tuple:
    """A clean pair made into frame i: ``_render``'s photometric tail."""
    gain, bias, _ = nuisance(i)
    return tuple(np.clip(img * gain + bias + nz, 0, 255).astype(np.float32)
                 for img, nz in zip(clean, noise))


class FrameRender:
    """Frames of ``render_frames`` started in ``workers`` spawned processes
    (0: in this process); ``result()`` waits for them."""

    def __init__(self, scene: SyntheticScene, poses, workers: int = 0):
        self.draws = _draws(scene, len(poses))
        self.pool = None
        if workers > 0:
            self.pool = concurrent.futures.ProcessPoolExecutor(
                workers, mp_context=multiprocessing.get_context("spawn"))
            self.jobs = [self.pool.submit(_clean_pair, scene, T, occ)
                         for T, (occ, _) in zip(poses, self.draws)]
        else:
            self.jobs = [_clean_pair(scene, T, occ) for T, (occ, _) in zip(poses, self.draws)]

    def result(self, timeout: float = 3600.0) -> list:
        try:
            clean = [j.result(timeout=timeout) if self.pool else j for j in self.jobs]
        finally:
            self.close()
        return [_finish(i, c, nz) for i, (c, (_, nz)) in enumerate(zip(clean, self.draws))]

    def close(self) -> None:
        if self.pool is not None:
            self.pool.shutdown(cancel_futures=True)
            self.pool = None


def render_frames(scene: SyntheticScene, poses, workers: int = 0) -> list:
    """The nuisance sequence along ``poses``: equal, frame for frame, to
    ``scene.render_stereo(T, noise=2.0, gain=, bias=, n_occluders=)`` called
    in pose order."""
    return FrameRender(scene, poses, workers).result()


def run_mode(plucker: bool, frames, poses, cam, out_dir: str, default_caps=False,
             device="cuda") -> dict:
    """One line mode over the frames; prints and returns its JSON line."""
    cfg = PLSLAMConfig(use_line_plucker=plucker, use_loop_closure=False,
                       multithread_slam=True)
    # 200+ keyframes at the natural KF rate: capacities sized so nothing
    # overflows
    mcfg = None if default_caps else MapConfig(
        use_lines=True, plucker_lines=plucker, local_ba_kf=16, ba_points=2048, ba_lines=256,
        ba_pobs=16384, ba_lobs=2048)
    slam = PLSLAM(cam, cfg, mcfg, device=device)
    t0 = time.time()
    for i, (il, ir) in enumerate(frames):
        slam.process(il, ir, timestamp=DT * i)
    slam.wait_until_idle()
    track_wall = time.time() - t0
    slam.finish(run_gba=True)
    kfs = slam.mapper.map.keyframes
    ts = np.asarray(slam.kf_timestamps)
    idx = np.clip((ts / DT).round().astype(int), 0, len(poses) - 1)
    est = np.stack([k.T_w_k[:3, 3] for k in kfs])
    gt = np.stack([poses[i][:3, 3] for i in idx])
    ate = ate_rmse(est, gt)
    mode = "plucker" if plucker else "endpoint"
    save_tum(os.path.join(out_dir, f"e2e_robust_{mode}.tum"), ts, [k.T_w_k for k in kfs])
    good = sum(1 for lg in slam.logs if lg.good)
    out = {
        "mode": mode, "frames": len(frames), "good_frames": good,
        "keyframes": len(kfs), "ate_rmse_m": round(float(ate), 4),
        "path_len_m": round(float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum()), 2),
        "track_fps": round(len(frames) / track_wall, 1),
    }
    print(json.dumps(out), flush=True)
    out["ate_rmse_unrounded"] = float(ate)
    return out


def main(argv=None) -> list[dict]:
    """Both modes, Plücker first; returns their lines (with the unrounded
    ATE)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_frames", nargs="?", type=int, default=500)
    ap.add_argument("--out", default=None, help="directory of the TUM files (default: a "
                    "new temporary directory)")
    ap.add_argument("--default-caps", action="store_true",
                    help="the default MapConfig instead of the run's capacities")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out_dir = args.out or tempfile.mkdtemp(prefix="e2e_robust_")
    os.makedirs(out_dir, exist_ok=True)
    scene = make_scene()
    poses = circular_trajectory(args.n_frames, step_t=0.02, step_r=0.002)
    save_gt(out_dir, poses)
    workers = min(8, os.cpu_count() or 1)
    print(f"# rendering {args.n_frames} frames with rolling illumination, "
          f"noise={NOISE}, occluders ({workers} workers)...", file=sys.stderr, flush=True)
    t0 = time.time()
    frames = render_frames(scene, poses, workers)
    print(f"#   rendered {args.n_frames} frames ({time.time() - t0:.0f}s)",
          file=sys.stderr, flush=True)
    return [run_mode(plucker, frames, poses, camera(scene), out_dir, args.default_caps,
                     args.device) for plucker in (True, False)]


if __name__ == "__main__":
    main()
