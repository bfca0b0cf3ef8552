"""RGB-D feature extraction (``plslam_tpu.frontend.rgbd``; reference
``src2/stereoFrame.cpp`` extractRGBDFeatures :704-850).

Features are detected on the intensity image alone, through the same
batched detectors as the stereo path (``img[None]``: the FAST and patch
kernels on a CUDA tensor).  Each feature reads its depth from the
registered depth map (bilinear); disparity is synthesized as fx * b /
depth (TUM convention, :752) and gated by the depth range; a line takes
the depths of its two endpoints, the same disparity-ratio filter as the
stereo lines, and the Pluecker line through its two back-projected
endpoints.  The result is the stereo path's ``StereoFeatures``, so
tracking and mapping run on it unchanged.
"""

from __future__ import annotations

import torch

from ..core.camera import StereoCamera, _f32
from ..ops.image import bilinear_sample
from .features import LineSet, PointSet, StereoFeatures
from .frame import FrontendConfig, _detect_describe_lines_batch, _detect_describe_points_batch


def _first(tree):
    return type(tree)(*(x[0] for x in tree))


def _disparity(d: torch.Tensor, cam: StereoCamera) -> torch.Tensor:
    """fx * b / depth, divided as the JAX package divides."""
    return torch.full_like(d, _f32(cam.fx * cam.b)) / torch.clamp(d, min=1e-6)


def rgbd_points(kp, desc, depth: torch.Tensor, cam: StereoCamera, min_depth: float,
                max_depth: float) -> PointSet:
    """One image's keypoints (K,) and descriptors with their depth."""
    d = bilinear_sample(depth[None], kp.xy[None])[0]
    ok = kp.valid & (d > min_depth) & (d < max_depth)
    disp = torch.where(ok, _disparity(d, cam), 1.0)
    return PointSet(uv=kp.xy, disp=disp, P=cam.back_project(kp.xy, disp), desc=desc,
                    sigma2=torch.ones_like(disp), valid=ok)


def rgbd_lines(seg, ldesc, depth: torch.Tensor, cam: StereoCamera, cfg: FrontendConfig,
               min_depth: float, max_depth: float) -> LineSet:
    """One image's segments (N,) with the depths of their endpoints, the
    disparity-ratio filter and the Pluecker line through the two
    back-projected endpoints."""
    ds, de = bilinear_sample(depth[None], torch.stack([seg.sp, seg.ep])[None])[0]
    d_ok = (ds > min_depth) & (ds < max_depth) & (de > min_depth) & (de < max_depth)
    disp_s, disp_e = _disparity(ds, cam), _disparity(de, cam)
    ratio = (torch.minimum(disp_s, disp_e)
             / torch.clamp(torch.maximum(disp_s, disp_e), min=1e-9))
    ok = seg.valid & d_ok & (ratio >= cfg.ls_min_disp_ratio)
    disp_s = torch.where(ok, disp_s, 1.0)
    disp_e = torch.where(ok, disp_e, 1.0)
    sP = cam.back_project(seg.sp, disp_s)
    eP = cam.back_project(seg.ep, disp_e)
    ones = torch.ones_like(disp_s)[:, None]
    le = torch.linalg.cross(torch.cat([seg.sp, ones], -1), torch.cat([seg.ep, ones], -1),
                            dim=-1)
    le = le / torch.clamp(torch.linalg.norm(le[:, :2], dim=-1, keepdim=True), min=1e-9)
    Lc = torch.cat([torch.linalg.cross(sP, eP, dim=-1), eP - sP], dim=-1)
    return LineSet(sp=seg.sp, ep=seg.ep, sdisp=disp_s, edisp=disp_e, sP=sP, eP=eP, le=le,
                   angle=seg.angle, NDc=Lc, desc=ldesc, sigma2=ones[:, 0], valid=ok)


def extract_rgbd_features(img: torch.Tensor, depth: torch.Tensor, cam: StereoCamera,
                          cfg: FrontendConfig = FrontendConfig(), min_depth: float = 0.3,
                          max_depth: float = 10.0, fast_th=None) -> StereoFeatures:
    """(H, W) intensity and depth (m) images -> padded feature sets."""
    kp, desc = _detect_describe_points_batch(img[None], cfg, fast_th)
    seg, ldesc = _detect_describe_lines_batch(img[None], cfg)
    return StereoFeatures(
        points=rgbd_points(_first(kp), desc[0], depth, cam, min_depth, max_depth),
        lines=rgbd_lines(_first(seg), ldesc[0], depth, cam, cfg, min_depth, max_depth))
