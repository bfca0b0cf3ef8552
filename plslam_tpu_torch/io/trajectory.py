"""Trajectory export (TUM format) and ATE evaluation.

The port's own copy of the part of ``plslam_tpu.io.trajectory`` that it
uses (the port imports nothing of the JAX package);
``tests/test_torch_io.py`` holds the two identical.

Behavioral spec: reference SaveKeyFrameTrajectoryTUM (mapHandler.cpp
:5818-5849, format ``t x y z qx qy qz qw``) and the EuRoC ground-truth
comparison workflow (config/asl/gt-ass/*/groundtruth.txt).
"""

from __future__ import annotations

import numpy as np


def rotation_to_quat(R: np.ndarray) -> np.ndarray:
    """3x3 rotation -> (qx, qy, qz, qw)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        qw = 0.25 * s
        qx = (R[2, 1] - R[1, 2]) / s
        qy = (R[0, 2] - R[2, 0]) / s
        qz = (R[1, 0] - R[0, 1]) / s
    else:
        i = np.argmax(np.diag(R))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
        q = np.zeros(4)
        q[i] = 0.25 * s
        q[3] = (R[k, j] - R[j, k]) / s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        qx, qy, qz, qw = q
    return np.array([qx, qy, qz, qw])


def save_tum(path: str, timestamps, poses) -> None:
    """Write ``t x y z qx qy qz qw`` per pose (camera->world 4x4)."""
    with open(path, "w") as f:
        for t, T in zip(timestamps, poses):
            T = np.asarray(T)
            q = rotation_to_quat(T[:3, :3])
            p = T[:3, 3]
            f.write(f"{t:.6f} {p[0]:.7f} {p[1]:.7f} {p[2]:.7f} "
                    f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n")


def umeyama_alignment(x: np.ndarray, y: np.ndarray, with_scale: bool = False):
    """Least-squares similarity/rigid alignment y ~ s R x + t (Umeyama).

    x, y: (N, 3).  Returns (s, R, t).
    """
    mx = x.mean(0)
    my = y.mean(0)
    xc = x - mx
    yc = y - my
    cov = yc.T @ xc / len(x)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_x = (xc ** 2).sum() / len(x)
        s = np.trace(np.diag(D) @ S) / var_x
    else:
        s = 1.0
    t = my - s * R @ mx
    return s, R, t


def ate_rmse(est_positions: np.ndarray, gt_positions: np.ndarray,
             align: bool = True, with_scale: bool = False) -> float:
    """Absolute trajectory error RMSE after rigid (SE(3)) alignment — the
    standard EuRoC evaluation protocol."""
    est = np.asarray(est_positions, float)
    gt = np.asarray(gt_positions, float)
    assert est.shape == gt.shape
    if align:
        s, R, t = umeyama_alignment(est, gt, with_scale)
        est = (s * (R @ est.T)).T + t
    err = est - gt
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))


def associate_timestamps(t_est, t_gt, max_dt: float = 0.02):
    """Greedy nearest-timestamp association (the associations.txt protocol).

    Returns (idx_est, idx_gt) index arrays.
    """
    t_est = np.asarray(t_est, float)
    t_gt = np.asarray(t_gt, float)
    ie, ig = [], []
    j = 0
    for i, t in enumerate(t_est):
        j = int(np.searchsorted(t_gt, t))
        best = None
        for cand in (j - 1, j):
            if 0 <= cand < len(t_gt) and abs(t_gt[cand] - t) <= max_dt:
                if best is None or abs(t_gt[cand] - t) < abs(t_gt[best] - t):
                    best = cand
        if best is not None:
            ie.append(i)
            ig.append(best)
    return np.asarray(ie, int), np.asarray(ig, int)
