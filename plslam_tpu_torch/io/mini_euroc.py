"""A miniature EuRoC-layout stereo sequence on disk, rendered from the
synthetic scene (the port's counterpart of ``scripts/make_mini_euroc.py``:
the same layout, files and defaults).

    out/mav0/cam0/data/<ns>.png      left frames, nanosecond filenames
    out/mav0/cam1/data/<ns>.png      right frames
    out/mav0/cam0/data.csv           "#timestamp [ns],filename" rows
    out/params.yaml                  dataset_params (scalar rectified form)
    out/groundtruth.csv              EuRoC-style "ns, px py pz, qw qx qy qz"
    out/gt-ass/groundtruth.txt       the reference's 3x4-row pose format
    out/gt-ass/associations.txt      nanosecond timestamps per GT row
    out/groundtruth_tum.txt          TUM t x y z qx qy qz qw (for evaluate_ate)

It is the fixture of the disk path (reader, loader, rectification,
pipeline, TUM dump, ATE); a real EuRoC sequence takes the same path.  The
frames are 8-bit grey PNGs written by ``cv2.imwrite``, as the JAX script
writes them.
The default scene is 376x240 with 400 points and 48 lines (seed 0) at
20 Hz; ``scene`` takes any ``SyntheticScene``, e.g. ``EUROC_SCENE`` at
EuRoC's 752x480 (the scene of chip_smoke.py's image phases).

    python -m plslam_tpu_torch.io.mini_euroc OUT_DIR [--frames N] [--euroc-size]
"""

from __future__ import annotations

import argparse
import os
import time

import cv2
import numpy as np

from .synthetic import SyntheticScene, circular_trajectory

W, H = 376, 240
FX = FY = 217.6
CX, CY = 183.7, 126.1
BL = 0.110074
T0_NS = 1403636580913555456          # an EuRoC-era epoch
DT_NS = 50_000_000                   # 20 Hz
# EuRoC's image size and a camera close to its rectified one
EUROC_SCENE = dict(n_points=600, n_lines=60, seed=0, width=752, height=480,
                   fx=435.2, fy=435.2, cx=367.4, cy=252.2)


def rot_to_quat(R):
    """(w, x, y, z) from a rotation matrix."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                         (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
    q = np.zeros(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def default_scene(seed: int = 0) -> SyntheticScene:
    return SyntheticScene(n_points=400, n_lines=48, seed=seed, width=W, height=H,
                          fx=FX, fy=FY, cx=CX, cy=CY, baseline=BL)


def make(out_dir: str, frames: int = 8, seed: int = 0,
         scene: SyntheticScene | None = None) -> dict:
    """Write the sequence; returns the paths, the frame count and the
    ground-truth poses.  ``scene`` (default: ``default_scene(seed)``) sets
    the camera written to params.yaml."""
    scene = scene if scene is not None else default_scene(seed)
    poses = circular_trajectory(frames, step_t=0.05)

    d0 = os.path.join(out_dir, "mav0", "cam0", "data")
    d1 = os.path.join(out_dir, "mav0", "cam1", "data")
    ga = os.path.join(out_dir, "gt-ass")
    for d in (d0, d1, ga):
        os.makedirs(d, exist_ok=True)

    csv_rows = ["#timestamp [ns],filename"]
    gt_csv = ["#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m], "
              "q_RS_w [], q_RS_x [], q_RS_y [], q_RS_z []"]
    gt_ass_rows, assoc_rows, tum_rows = [], [], []
    for i, T in enumerate(poses):
        ns = T0_NS + i * DT_NS
        il, ir = scene.render_stereo(T, noise=1.0)
        cv2.imwrite(os.path.join(d0, f"{ns}.png"), np.asarray(il, np.uint8))
        cv2.imwrite(os.path.join(d1, f"{ns}.png"), np.asarray(ir, np.uint8))
        csv_rows.append(f"{ns},{ns}.png")
        q = rot_to_quat(T[:3, :3])
        p = T[:3, 3]
        gt_csv.append(f"{ns},{p[0]},{p[1]},{p[2]},{q[0]},{q[1]},{q[2]},{q[3]}")
        gt_ass_rows.append(" ".join(f"{v:.9f}" for v in T[:3].reshape(-1)))
        assoc_rows.append(str(ns))
        tum_rows.append(f"{ns * 1e-9:.9f} {p[0]} {p[1]} {p[2]} "
                        f"{q[1]} {q[2]} {q[3]} {q[0]}")

    files = {os.path.join(out_dir, "mav0", "cam0", "data.csv"): csv_rows,
             os.path.join(out_dir, "groundtruth.csv"): gt_csv,
             os.path.join(ga, "groundtruth.txt"): gt_ass_rows,
             os.path.join(ga, "associations.txt"): assoc_rows,
             os.path.join(out_dir, "groundtruth_tum.txt"): tum_rows}
    for path, rows in files.items():
        with open(path, "w") as f:
            f.write("\n".join(rows) + "\n")
    params = os.path.join(out_dir, "params.yaml")
    with open(params, "w") as f:
        f.write(f"""cam0:
  cam_model: Pinhole
  cam_fx: {scene.fx}
  cam_fy: {scene.fy}
  cam_cx: {scene.cx}
  cam_cy: {scene.cy}
  cam_bl: {scene.b}
  cam_width: {scene.width}
  cam_height: {scene.height}
  cam_d0: 0.0
  cam_d1: 0.0
  cam_d2: 0.0
  cam_d3: 0.0
""")
    return {"dir": out_dir, "params": params, "frames": frames,
            "gt_csv": os.path.join(out_dir, "groundtruth.csv"),
            "gt_ass": os.path.join(ga, "groundtruth.txt"),
            "gt_tum": os.path.join(out_dir, "groundtruth_tum.txt"),
            "poses": poses}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--euroc-size", action="store_true",
                    help="render EUROC_SCENE (752x480) instead of the 376x240 default")
    args = ap.parse_args()
    t0 = time.perf_counter()
    info = make(args.out_dir, args.frames,
                scene=SyntheticScene(**EUROC_SCENE) if args.euroc_size else None)
    print(f"wrote {info['frames']}-frame mini EuRoC dataset to {info['dir']} in "
          f"{time.perf_counter() - t0:.3f} s")
