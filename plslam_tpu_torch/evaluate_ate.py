"""Trajectory evaluation: ATE RMSE between two TUM-format files
(``t x y z qx qy qz qw`` per line) with timestamp association and optional
rigid alignment (Umeyama, rotation + translation, no scale); the port of
the JAX package's native tool (``plslam_tpu/native/evaluate_ate.cpp``),
in host numpy on ``io/trajectory``.

    python -m plslam_tpu_torch.evaluate_ate EST GT [--max-dt 0.02] [--no-align]

Prints one JSON line ``{"ate_rmse": ..., "n_pairs": ...}``.  Rows of 12
numbers (the reference's gt-ass 3x4 pose rows, no timestamp) take their
row index as the time; a time above 1e14 is read as nanoseconds.  Each
estimate takes the nearest ground-truth time within ``--max-dt``; where two
are equally near, this takes the earlier and the C++ tool the later.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .io.trajectory import associate_timestamps, ate_rmse


def read_tum(path: str) -> tuple[np.ndarray, np.ndarray]:
    """(times (N,), positions (N, 3)) of a TUM file or gt-ass pose rows;
    '#' lines and empty lines are skipped, commas separate like spaces,
    and a row's numbers end at its first token that is not one."""
    ts, ps = [], []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line or line[0] == "#":
                continue
            v = []
            for tok in line.replace(",", " ").split():
                try:
                    v.append(float(tok))
                except ValueError:
                    break
            if len(v) == 12:
                ts.append(float(len(ts)))
                ps.append((v[3], v[7], v[11]))
            elif len(v) >= 4:
                ts.append(v[0] * 1e-9 if v[0] > 1e14 else v[0])
                ps.append(v[1:4])
    return np.asarray(ts, float), np.asarray(ps, float).reshape(-1, 3)


def evaluate(est_path: str, gt_path: str, max_dt: float = 0.02,
             align: bool = True) -> dict:
    """{"ate_rmse", "n_pairs"}; raises ValueError on an empty trajectory or
    fewer than two associated pairs."""
    t_est, p_est = read_tum(est_path)
    t_gt, p_gt = read_tum(gt_path)
    if not len(t_est) or not len(t_gt):
        raise ValueError("empty trajectory")
    ie, ig = associate_timestamps(t_est, t_gt, max_dt)
    if len(ie) < 2:
        raise ValueError(f"no associated pairs (max_dt={max_dt:g})")
    return {"ate_rmse": ate_rmse(p_est[ie], p_gt[ig], align=align), "n_pairs": int(len(ie))}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("est")
    ap.add_argument("gt")
    ap.add_argument("--max-dt", type=float, default=0.02)
    ap.add_argument("--no-align", action="store_true")
    args = ap.parse_args(argv)
    try:
        res = evaluate(args.est, args.gt, args.max_dt, not args.no_align)
    except ValueError as e:
        print(e, file=sys.stderr)
        raise SystemExit(1)
    print(f'{{"ate_rmse": {res["ate_rmse"]:.6f}, "n_pairs": {res["n_pairs"]}}}', flush=True)
    return res


if __name__ == "__main__":
    main()
