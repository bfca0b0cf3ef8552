"""EuRoC MAV and directory stereo sequence readers with rectification
(``plslam_tpu.io.euroc``; reference ``src2/dataset.cpp``: numeric filename
sort :51, offset/count/step decimation :88, nanosecond timestamps :144-176,
rectify-on-read :183; ``src2/pinholeStereoCamera.cpp`` :30-129 for the
Kl/Kr/R/t calibration form).

Frames decode with cv2 and the rectification transforms come from cv2 once
per sequence, as in the JAX package; the per-frame remap is the port's
plain bilinear remap (``ops/image.remap``) on the host or, through
``io/loader.StereoLoader``, on the card.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass

import cv2
import numpy as np
import torch
import yaml

from ..ops.image import remap


@dataclass
class RectifiedCalib:
    fx: float
    fy: float
    cx: float
    cy: float
    baseline: float
    width: int
    height: int
    map_l: tuple  # (map_x, map_y) float32 arrays
    map_r: tuple
    identity_maps: bool = False  # already-rectified input: skip remap


def load_params(params_file: str) -> dict:
    """A reference dataset-params YAML file as a dict.  yaml-cpp (the
    reference's loader) tolerates literal TABs, which euroc_params.yaml
    has inside its R matrix; strict YAML does not, so they become spaces."""
    with open(params_file) as f:
        return yaml.safe_load(f.read().replace("\t", " "))


def load_euroc_calib(params_file: str) -> RectifiedCalib:
    """Parse a reference dataset_params.yaml and build rectification maps.

    Both calibration forms of pinholeStereoCamera.cpp:30-129: the EuRoC
    Kl/Kr/Dl/Dr/R/t form (cv2.stereoRectify with CALIB_ZERO_DISPARITY and
    alpha=0, then cv2.initUndistortRectifyMap) and the already-rectified
    fx/fy/cx/cy/bl scalar form of the KITTI, asusxtion and perceptin files
    (identity maps)."""
    c = load_params(params_file)["cam0"]
    w, h = int(c["cam_width"]), int(c["cam_height"])

    if "Kl" not in c:
        gx, gy = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
        ident = (gx, gy)
        return RectifiedCalib(
            fx=float(c["cam_fx"]), fy=float(c["cam_fy"]),
            cx=float(c["cam_cx"]), cy=float(c["cam_cy"]),
            baseline=float(c["cam_bl"]), width=w, height=h,
            map_l=ident, map_r=ident, identity_maps=True)

    def K_of(v):
        fx, fy, cx, cy = v
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)

    Kl, Kr = K_of(c["Kl"]), K_of(c["Kr"])
    Dl, Dr = np.asarray(c["Dl"], np.float64), np.asarray(c["Dr"], np.float64)
    R = np.asarray(c["R"], np.float64).reshape(3, 3)
    t = np.asarray(c["t"], np.float64).reshape(3, 1)
    Rl, Rr, Pl, Pr, _, _, _ = cv2.stereoRectify(
        Kl, Dl, Kr, Dr, (w, h), R, t, flags=cv2.CALIB_ZERO_DISPARITY, alpha=0)
    m1l, m2l = cv2.initUndistortRectifyMap(Kl, Dl, Rl, Pl, (w, h), cv2.CV_32FC1)
    m1r, m2r = cv2.initUndistortRectifyMap(Kr, Dr, Rr, Pr, (w, h), cv2.CV_32FC1)
    return RectifiedCalib(fx=Pl[0, 0], fy=Pl[1, 1], cx=Pl[0, 2], cy=Pl[1, 2],
                          baseline=abs(Pr[0, 3] / Pr[0, 0]), width=w, height=h,
                          map_l=(m1l, m2l), map_r=(m1r, m2r))


_NUM_RE = re.compile(r"(\d+)")


def sorted_images(folder: str):
    """Numeric filename sort (dataset.cpp getSortedImages :51)."""
    names = [n for n in os.listdir(folder)
             if n.lower().endswith((".png", ".jpg", ".pgm", ".tiff"))]

    def key(n):
        m = _NUM_RE.search(n)
        return int(m.group(1)) if m else 0

    return [os.path.join(folder, n) for n in sorted(names, key=key)]


def read_image(path: str) -> np.ndarray:
    """(H, W) uint8 grey frame, read as the JAX package reads it
    (``cv2.imread``, IMREAD_GRAYSCALE; the call releases the interpreter
    lock, so loader threads decode in parallel).  A missing file or one
    that does not decode raises."""
    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        if not os.path.isfile(path):
            raise FileNotFoundError(path)
        raise ValueError(f"cannot decode {path}")
    return img


def remap_pair_host(il: np.ndarray, ir: np.ndarray, calib: RectifiedCalib):
    """Rectify one pair on the host with the plain remap: float32 results
    and clamped borders.  cv2.remap (the JAX package's host path)
    interpolates with 5-bit fixed-point weights, rounds to uint8 and blends
    with a black border: the two differ by at most a grey level where the
    map stays inside the image, and by up to ~3.3 levels on the top row of
    configs/euroc_params.yaml's maps, which reach 0.05 px above the image."""
    imgs = torch.from_numpy(np.stack([il, ir]).astype(np.float32))
    mx = torch.from_numpy(np.stack([calib.map_l[0], calib.map_r[0]]).astype(np.float32))
    my = torch.from_numpy(np.stack([calib.map_l[1], calib.map_r[1]]).astype(np.float32))
    out = remap(imgs, mx, my).numpy()
    return out[0], out[1]


class StereoDirDataset:
    """Directory-based stereo sequence reader (Dataset, dataset.cpp:88-196):
    two image subfolders, numeric filename sort, offset/count/step
    decimation, rectify-on-read.  Subfolder names follow the reference's
    ``images_subfolder_l/r`` dataset-params keys (cam0/data for EuRoC,
    image_2 / image_3 for KITTI, image_l / image_r for RGB-D rigs).

    ``rectify_on_host`` remaps each pair with ``remap_pair_host`` (float32,
    within a grey level of the JAX package's cv2.remap inside the image);
    without it the frames come back unrectified, for a loader that rectifies
    on the card."""

    def __init__(self, dataset_dir: str, calib: RectifiedCalib,
                 subfolder_l: str = "cam0/data", subfolder_r: str = "cam1/data",
                 offset: int = 0, nmax: int = 0, step: int = 1,
                 rectify_on_host: bool = True):
        self.files_l = sorted_images(os.path.join(dataset_dir, subfolder_l))
        self.files_r = sorted_images(os.path.join(dataset_dir, subfolder_r))
        n = min(len(self.files_l), len(self.files_r))
        end = offset + nmax * step if nmax > 0 else n
        self.files_l = self.files_l[offset:end:step]
        self.files_r = self.files_r[offset:end:step]
        self.calib = calib
        self.rectify_on_host = rectify_on_host
        # timestamps: ns when filenames carry EuRoC epoch values, else
        # frame index at 10 Hz (KITTI-style 000000.png counters)
        self.timestamps = []
        for i, p in enumerate(self.files_l):
            m = _NUM_RE.search(os.path.basename(p))
            v = int(m.group(1)) if m else i
            self.timestamps.append(v * 1e-9 if v > 10 ** 14 else 0.1 * i)

    def __len__(self):
        return len(self.files_l)

    def __getitem__(self, i: int):
        il, ir = read_image(self.files_l[i]), read_image(self.files_r[i])
        if self.rectify_on_host and not self.calib.identity_maps:
            il, ir = remap_pair_host(il, ir, self.calib)
        return il.astype(np.float32), ir.astype(np.float32), self.timestamps[i]


class EurocDataset(StereoDirDataset):
    """EuRoC MAV layout: mav0/cam0/data + mav0/cam1/data (also accepts
    cam0/data at the top level)."""

    def __init__(self, dataset_dir: str, calib: RectifiedCalib,
                 offset: int = 0, nmax: int = 0, step: int = 1,
                 rectify_on_host: bool = True):
        for sub in ("mav0", "."):
            if os.path.isdir(os.path.join(dataset_dir, sub, "cam0", "data")):
                base = os.path.join(dataset_dir, sub)
                break
        else:
            raise FileNotFoundError(f"no cam0/data under {dataset_dir}")
        super().__init__(base, calib, "cam0/data", "cam1/data",
                         offset=offset, nmax=nmax, step=step,
                         rectify_on_host=rectify_on_host)


def load_groundtruth(gt_file: str):
    """Parse the reference's shipped ground truth
    (config/asl/gt-ass/*/groundtruth.txt: rows of 3x4 pose matrices) or the
    EuRoC csv (timestamp, p, q) — returns (timestamps?, positions (N,3))."""
    rows = []
    with open(gt_file) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rows.append([float(v) for v in re.split(r"[,\s]+", line) if v])
    arr = np.asarray(rows)
    if arr.shape[1] == 12:          # 3x4 row-major pose per line
        return None, arr[:, [3, 7, 11]]
    if arr.shape[1] >= 8:           # EuRoC state csv: t, px, py, pz, q...
        return arr[:, 0] * (1e-9 if arr[0, 0] > 1e14 else 1.0), arr[:, 1:4]
    raise ValueError(f"unrecognized ground-truth format: {arr.shape}")
