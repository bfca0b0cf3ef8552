"""Fixed-capacity feature containers (``plslam_tpu.frontend.features``).

Padded struct-of-arrays with validity masks; descriptors are (N, 8)
int32 words.  ``sigma2`` is the inverse-variance pyramid weight
scale_factor^(-2*level) (stereoFeatures.cpp:41-56).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PointSet(NamedTuple):
    uv: torch.Tensor      # (N, 2) left-image pixel
    disp: torch.Tensor    # (N,) stereo disparity
    P: torch.Tensor       # (N, 3) back-projected 3D point
    desc: torch.Tensor    # (N, 8) int32 descriptor words
    sigma2: torch.Tensor  # (N,)
    valid: torch.Tensor   # (N,) bool

    @property
    def capacity(self) -> int:
        return self.uv.shape[0]


class LineSet(NamedTuple):
    sp: torch.Tensor      # (N, 2) start point (left image)
    ep: torch.Tensor      # (N, 2) end point
    sdisp: torch.Tensor   # (N,)
    edisp: torch.Tensor   # (N,)
    sP: torch.Tensor      # (N, 3) 3D start point
    eP: torch.Tensor      # (N, 3) 3D end point
    le: torch.Tensor      # (N, 3) image line, ||(a, b)|| = 1
    angle: torch.Tensor   # (N,)
    NDc: torch.Tensor     # (N, 6) Pluecker line in this camera frame
    desc: torch.Tensor    # (N, 8) int32 descriptor words
    sigma2: torch.Tensor  # (N,)
    valid: torch.Tensor   # (N,) bool

    @property
    def capacity(self) -> int:
        return self.sp.shape[0]


class StereoFeatures(NamedTuple):
    points: PointSet
    lines: LineSet


class TrackedPoints(NamedTuple):
    """Prev-frame 3D points paired with curr-frame pixels
    (stereoFrameHandler.cpp:144-152)."""

    P: torch.Tensor       # (N, 3)
    obs: torch.Tensor     # (N, 2)
    sigma2: torch.Tensor  # (N,)
    valid: torch.Tensor   # (N,) candidate mask
    inlier: torch.Tensor  # (N,) updated by outlier rejection


class TrackedLines(NamedTuple):
    """Frame-to-frame line correspondences (stereoFrameHandler.cpp:166-180)."""

    sP: torch.Tensor
    eP: torch.Tensor
    sp: torch.Tensor      # prev-frame 2D endpoints (overlap weight)
    ep: torch.Tensor
    NDc: torch.Tensor     # (N, 6) Pluecker line in the prev camera frame
    sobs: torch.Tensor    # (N, 2) observed endpoints in the curr frame
    eobs: torch.Tensor
    le_obs: torch.Tensor  # (N, 3) observed image line in the curr frame
    sigma2: torch.Tensor
    valid: torch.Tensor
    inlier: torch.Tensor
