"""Rectified pinhole stereo camera (``plslam_tpu.core.camera``).

The intrinsics are Python floats rounded to float32, so that scalar
arithmetic with float32 tensors uses exactly the JAX package's f32
constants and no per-frame host-to-device copy is needed.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def _f32(v) -> float:
    return float(np.float32(v))


class StereoCamera(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    b: float  # baseline in meters
    width: int = 752
    height: int = 480

    @classmethod
    def create(cls, fx, fy, cx, cy, b, width=752, height=480) -> "StereoCamera":
        return cls(_f32(fx), _f32(fy), _f32(cx), _f32(cy), _f32(b),
                   int(width), int(height))

    @property
    def plucker_K(self) -> tuple:
        """K_L = [[fy, 0, 0], [0, fx, 0], [-fy*cx, -fx*cy, fx*fy]]
        (pinholeStereoCamera.cpp:123-125), entries rounded to f32."""
        fx, fy, cx, cy = self.fx, self.fy, self.cx, self.cy
        return ((fy, 0.0, 0.0), (0.0, fx, 0.0),
                (_f32(-fy * cx), _f32(-fx * cy), _f32(fx * fy)))

    def project(self, P: torch.Tensor) -> torch.Tensor:
        return torch.stack([self.cx + self.fx * P[..., 0] / P[..., 2],
                            self.cy + self.fy * P[..., 1] / P[..., 2]], dim=-1)

    def back_project(self, uv: torch.Tensor, disp: torch.Tensor) -> torch.Tensor:
        """Pixel + disparity -> 3D point, depth = b*fx/disp."""
        # full_like: `scalar / tensor` is reciprocal-then-multiply in torch
        depth = torch.full_like(disp, _f32(self.b * self.fx)) / disp
        return torch.stack([depth * (uv[..., 0] - self.cx) / self.fx,
                            depth * (uv[..., 1] - self.cy) / self.fy,
                            depth], dim=-1)

    def apply_plucker_K(self, v: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """K_L @ v along ``dim`` (size 3), from the scalar entries: a K_L
        tensor would be a host-to-device copy on every call."""
        (k00, _, _), (_, k11, _), (k20, k21, k22) = self.plucker_K
        v0, v1, v2 = v.unbind(dim)
        return torch.stack([k00 * v0, k11 * v1, k20 * v0 + k21 * v1 + k22 * v2],
                           dim=dim)

    def project_line(self, L_cam: torch.Tensor) -> torch.Tensor:
        """Camera-frame Pluecker line -> image line l = K_L n (homogeneous)."""
        return self.apply_plucker_K(L_cam[..., :3])

    def back_project_unit(self, uv: torch.Tensor) -> torch.Tensor:
        return torch.stack([(uv[..., 0] - self.cx) / self.fx,
                            (uv[..., 1] - self.cy) / self.fy,
                            torch.ones_like(uv[..., 0])], dim=-1)


def euroc_default_camera() -> StereoCamera:
    """Rectified EuRoC MAV intrinsics (values after cv2.stereoRectify of the
    shipped euroc_params.yaml calibration; used for synthetic tests), as
    ``plslam_tpu.core.camera.euroc_default_camera``.  The camera is Python
    floats rounded to float32, so it takes neither a dtype nor a device."""
    return StereoCamera.create(fx=435.2, fy=435.2, cx=367.4, cy=252.2, b=0.110074,
                               width=752, height=480)
