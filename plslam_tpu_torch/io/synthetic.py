"""Synthetic stereo sequence renderer for end-to-end tests and benchmarks.

The port's own copy of ``plslam_tpu.io.synthetic`` (the port imports
nothing of the JAX package); ``tests/test_torch_io.py`` holds the two
identical.  Renders a random 3D scene of blob landmarks and 3D line
segments into both cameras of a moving stereo rig.  Host-side numpy.
"""

from __future__ import annotations

import numpy as np


class SyntheticScene:
    def __init__(self, n_points=300, n_lines=40, seed=0,
                 width=376, height=240, fx=217.6, fy=217.6,
                 cx=183.7, cy=126.1, baseline=0.110074):
        rng = np.random.default_rng(seed)
        self.width, self.height = width, height
        self.fx, self.fy, self.cx, self.cy, self.b = fx, fy, cx, cy, baseline
        # scatter landmarks in a box in front of the initial camera
        self.P = np.stack([
            rng.uniform(-6, 6, n_points),
            rng.uniform(-4, 4, n_points),
            rng.uniform(2.0, 14.0, n_points),
        ], axis=-1)
        self.P_bright = rng.uniform(120, 250, n_points)
        A = np.stack([
            rng.uniform(-6, 6, n_lines),
            rng.uniform(-4, 4, n_lines),
            rng.uniform(2.0, 14.0, n_lines),
        ], axis=-1)
        B = A + np.stack([
            rng.uniform(-2.5, 2.5, n_lines),
            rng.uniform(-2.5, 2.5, n_lines),
            rng.uniform(-1.0, 1.0, n_lines),
        ], axis=-1)
        self.LA, self.LB = A, B
        self.L_bright = rng.uniform(140, 250, n_lines)
        self.rng = rng

    def project(self, T_c_w: np.ndarray, X: np.ndarray):
        Xc = (T_c_w[:3, :3] @ X.T).T + T_c_w[:3, 3]
        z = Xc[:, 2]
        u = self.cx + self.fx * Xc[:, 0] / np.maximum(z, 1e-6)
        v = self.cy + self.fy * Xc[:, 1] / np.maximum(z, 1e-6)
        return u, v, z

    def _splat(self, img, u, v, brightness, sigma=1.1, rad=3):
        """Anti-aliased Gaussian splat at a fractional position — integer
        rasterization would bake +-0.5 px quantization into the 'true'
        feature positions and dominate stereo depth error."""
        x0, y0 = int(np.floor(u)), int(np.floor(v))
        if not (rad <= x0 < self.width - rad - 1 and rad <= y0 < self.height - rad - 1):
            return
        ys, xs = np.mgrid[y0 - rad:y0 + rad + 1, x0 - rad:x0 + rad + 1]
        g = np.exp(-((xs - u) ** 2 + (ys - v) ** 2) / (2 * sigma * sigma))
        patch = img[y0 - rad:y0 + rad + 1, x0 - rad:x0 + rad + 1]
        np.maximum(patch, brightness * g, out=patch)

    def _render(self, T_c_w: np.ndarray, noise: float,
                gain: float = 1.0, bias: float = 0.0,
                occluders=None) -> np.ndarray:
        img = np.full((self.height, self.width), 30.0, np.float32)
        u, v, z = self.project(T_c_w, self.P)
        ok = (z > 0.5)
        for ui, vi, bi in zip(u[ok], v[ok], self.P_bright[ok]):
            self._splat(img, ui, vi, bi)
        ua, va, za = self.project(T_c_w, self.LA)
        ub, vb, zb = self.project(T_c_w, self.LB)
        for i in range(len(ua)):
            if za[i] <= 0.5 or zb[i] <= 0.5:
                continue
            n = int(max(abs(ub[i] - ua[i]), abs(vb[i] - va[i])) * 2.0) + 2
            for t in np.linspace(0, 1, n):
                x = ua[i] + t * (ub[i] - ua[i])
                y = va[i] + t * (vb[i] - va[i])
                self._splat(img, x, y, self.L_bright[i], sigma=0.9, rad=2)
        # near-field occluders: textureless panels at camera-frame depth —
        # drawn over the scene with stereo-consistent disparity, they
        # ERASE whatever features fall behind them (dropout robustness)
        if occluders is not None:
            for (xc, yc, zo, w2, h2) in occluders:
                uo = self.cx + self.fx * xc / zo
                vo = self.cy + self.fy * yc / zo
                du = self.fx * w2 / zo
                dv = self.fy * h2 / zo
                x0 = int(np.clip(uo - du, 0, self.width))
                x1 = int(np.clip(uo + du, 0, self.width))
                y0 = int(np.clip(vo - dv, 0, self.height))
                y1 = int(np.clip(vo + dv, 0, self.height))
                img[y0:y1, x0:x1] = 55.0
        # photometric model: exposure gain + black-level bias (rolling
        # illumination across a sequence) and sensor noise
        img = img * gain + bias
        if noise > 0:
            img = img + self.rng.normal(0, noise, img.shape).astype(np.float32)
        return np.clip(img, 0, 255).astype(np.float32)

    def render_stereo(self, T_w_c: np.ndarray, noise: float = 1.0,
                      gain: float = 1.0, bias: float = 0.0,
                      n_occluders: int = 0):
        """(left, right) images for a camera->world pose.

        ``gain``/``bias`` model per-frame exposure / illumination change
        (roll them across a sequence for the EuRoC-like evaluation,
        VERDICT r3 next-round #6); ``n_occluders`` drops that many
        textureless near-field panels into BOTH views with consistent
        disparity, erasing the features behind them."""
        T_c_w = np.linalg.inv(T_w_c)
        occ = None
        if n_occluders > 0:
            # camera-frame panels (x_center, y_center, depth, half_w, half_h)
            occ = [(float(self.rng.uniform(-1.5, 1.5)),
                    float(self.rng.uniform(-1.0, 1.0)),
                    float(self.rng.uniform(1.2, 2.5)),
                    float(self.rng.uniform(0.15, 0.45)),
                    float(self.rng.uniform(0.15, 0.45)))
                   for _ in range(n_occluders)]
        img_l = self._render(T_c_w, noise, gain, bias, occ)
        # right camera: shifted by baseline along +x of the camera frame
        T_shift = np.eye(4)
        T_shift[0, 3] = -self.b
        occ_r = ([(x - self.b, y, z, w2, h2) for x, y, z, w2, h2 in occ]
                 if occ else None)
        img_r = self._render(T_shift @ T_c_w, noise, gain, bias, occ_r)
        return img_l, img_r


def circular_trajectory(n_frames: int, step_t=0.06, step_r=0.008):
    """Gentle forward + yaw motion: list of (4x4) camera->world poses."""
    poses = [np.eye(4)]
    for i in range(1, n_frames):
        xi_t = np.array([0.01 * np.sin(i * 0.4), 0.005 * np.cos(i * 0.3), step_t])
        c, s = np.cos(step_r), np.sin(step_r)
        Rz = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        T = np.eye(4)
        T[:3, :3] = Rz
        T[:3, 3] = xi_t
        poses.append(poses[-1] @ T)
    return poses
