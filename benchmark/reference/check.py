"""The plain reference and the comparison that decides ``correct``.

The reference is the scene's ground truth, which the generator hands over
with the frames: the camera pose of every frame.  What the program
answered is judged against it.

The tracking step, over every frame of the window:

- ``frame_t_mm`` / ``frame_r_mrad``: the tracked pose that each ``process``
  call returned, as the motion between consecutive frames, against the true
  motion (the median over the window's frames of the translation and
  rotation of ``inv(dT_true) @ dT_tracked``);
- ``frame_t_p90_mm`` / ``frame_r_p90_mrad``: the 90th percentile of the same
  errors over the frames the program declared tracked (a fault that touches
  a minority of frames moves no median);
- ``frame_fail_pct``: the share of the window's frames the program declared
  not tracked (it keeps the previous pose for them);
- ``kf_mismatch``: keyframes the mapper holds beyond or short of one per
  flagged frame (and the first), plus keyframes whose submitted pose is not
  the pose ``process`` returned for their frame: exact, limit 0.

The mapper, after ``wait_until_idle``:

- ``kf_drift_mm``: the keyframe poses after the last local BA, as the
  motion over spans of ``DRIFT_SPAN`` keyframes of the window, against the
  true poses of the frames that ``process`` flagged as keyframes (the
  median translation error): the local BA holds this drift down;
- ``landmark_single_pct``: the share of the map's valid point landmarks that
  only one keyframe observes (a true point stays in view over many
  keyframes, and association adds those views).

Plain numpy; nothing of the program is imported.
"""

from __future__ import annotations

import numpy as np

NUMBERS = ("frame_t_mm", "frame_r_mrad", "frame_t_p90_mm", "frame_r_p90_mrad",
           "frame_fail_pct", "kf_mismatch", "kf_drift_mm", "landmark_single_pct")
DRIFT_SPAN = 10


def inv_se3(T: np.ndarray) -> np.ndarray:
    R, t = T[..., :3, :3], T[..., :3, 3]
    out = np.zeros_like(T)
    Rt = np.swapaxes(R, -1, -2)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = -np.einsum("...ij,...j->...i", Rt, t)
    out[..., 3, 3] = 1.0
    return out


def motion_errors(true_a, true_b, est_a, est_b) -> tuple:
    """Translation (m) and rotation (rad) of inv(inv(Ta) Tb) @ inv(Ea) Eb
    per pair: how far the estimated motion is from the true one."""
    d_true = inv_se3(true_a) @ true_b
    d_est = inv_se3(est_a) @ est_b
    E = inv_se3(d_true) @ d_est
    t = np.linalg.norm(E[..., :3, 3], axis=-1)
    R = E[..., :3, :3]
    # the angle from its sine and cosine: a rotation rounded to float32 is
    # not quite orthonormal, and an arccos of the trace alone reads the
    # excess as no rotation at all below ~0.4 mrad
    w = np.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                  R[..., 1, 0] - R[..., 0, 1]], -1)
    c = (np.trace(R, axis1=-2, axis2=-1) - 1.0) / 2.0
    return t, np.arctan2(np.linalg.norm(w, axis=-1) / 2.0, c)


def readings(out: dict, truth: dict, window_from: int) -> dict:
    """The compared numbers from the program's answers ``out`` and the
    ground truth ``truth``.

    ``out``: ``frames`` (stream index of each processed frame, the first
    being the map's first keyframe), ``poses`` (F, 4, 4) tracked camera ->
    world, ``is_kf`` (F,) flags, ``kf_poses`` (K, 4, 4) after the last local
    BA, ``kf_submitted`` (K, 4, 4) the pose each keyframe was submitted
    with, ``good`` (F,) whether the program declared each frame tracked,
    ``points_nobs`` (M,) how many keyframes observe each valid point
    landmark.  ``truth``: ``poses`` (L, 4, 4) of the lap by lap frame.
    Frames from position ``window_from`` on are the window's."""
    lap = truth["poses"]
    idx = np.asarray(out["frames"]) % len(lap)
    true_f = lap[idx]
    est = np.asarray(out["poses"], np.float64)
    sl = slice(max(window_from, 1), len(idx))
    t, r = motion_errors(true_f[sl.start - 1:-1], true_f[sl], est[sl.start - 1:-1], est[sl])
    good = np.asarray(out["good"], bool)[sl]

    is_kf = np.asarray(out["is_kf"], bool)
    kf_frames = np.r_[0, np.where(is_kf[1:])[0] + 1]
    kf_poses = np.asarray(out["kf_poses"], np.float64)
    submitted = np.asarray(out["kf_submitted"], np.float64)
    n = min(len(kf_frames), len(kf_poses))
    mismatch = abs(len(kf_poses) - len(kf_frames))
    mismatch += int(np.sum(np.any(submitted[:n] != est[kf_frames[:n]], axis=(1, 2))))
    kf_true = true_f[kf_frames[:n]]
    in_window = np.where(kf_frames[1:n] >= window_from)[0] + 1
    span = in_window[in_window >= DRIFT_SPAN]
    dt, _ = motion_errors(kf_true[span - DRIFT_SPAN], kf_true[span],
                          kf_poses[span - DRIFT_SPAN], kf_poses[span])
    nobs = np.asarray(out["points_nobs"])
    return {"frame_t_mm": _pct(1e3 * t, 50), "frame_r_mrad": _pct(1e3 * r, 50),
            "frame_t_p90_mm": _pct(1e3 * t[good], 90),
            "frame_r_p90_mrad": _pct(1e3 * r[good], 90),
            "frame_fail_pct": 100.0 * float(np.mean(~good)) if len(good) else float("inf"),
            "kf_mismatch": float(mismatch),
            "kf_drift_mm": _pct(1e3 * dt, 50),
            "landmark_single_pct": 100.0 * float(np.mean(nobs <= 1)) if len(nobs)
            else float("inf")}


def _pct(x, q: float) -> float:
    """The ``q``-th percentile of ``x`` (inf where there is nothing: its
    check fails)."""
    x = np.asarray(x, np.float64)
    return float(np.percentile(x, q)) if len(x) else float("inf")


def judge(read: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the numbers the cell holds
    to a limit: every one at or under it; a number that could not be read
    (NaN, or inf for no pairs) fails."""
    checks = {k: {"value": read[k], "limit": float(limits[k])} for k in NUMBERS
              if k in limits}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return bool(ok), checks
