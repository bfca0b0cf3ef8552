"""Per-frame stereo feature extraction (``plslam_tpu.frontend.frame``).

Points and lines are detected and described on the stacked (2, H, W)
stereo pair at once, then matched left to right.  The tensor's device
alone selects the CUDA kernels or their plain versions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.camera import StereoCamera
from ..core.plucker import plane_from_points, plucker_from_planes
from ..ops import fast, lbd, lines, orb
from ..ops import matching as M
from ..ops.image import build_pyramid
from .features import LineSet, PointSet


class FrontendConfig(NamedTuple):
    """Feature-extraction tunables (defaults = reference config.cpp:36-113)."""

    n_points: int = 1200
    n_lines: int = 256
    n_levels: int = 4
    scale_factor: float = 1.2
    fast_th: float = 20.0
    edge_th: int = 19
    max_dist_epip: float = 1.0
    min_disp: float = 1.0
    nnr: float = 0.9
    stereo_window: float = 120.0
    stereo_row_tol: float = 10.0
    line_sim_th: float = 0.75
    line_horiz_th: float = 0.1
    ls_min_disp_ratio: float = 0.7
    stereo_overlap_th: float = 0.75
    min_line_length_frac: float = 0.025
    line_window: float = 120.0
    line_orient_bins: int = 16


def _sigma2(level: torch.Tensor, scale_factor: float) -> torch.Tensor:
    """Inverse-variance pyramid weight (stereoFeatures.cpp:41-56)."""
    s = torch.pow(scale_factor, level.to(torch.float32))
    return 1.0 / (s * s)


def _detect_describe_points_batch(imgs: torch.Tensor, cfg: FrontendConfig,
                                  fast_th=None):
    """(B, H, W) stack -> batched Keypoints + (B, K, 8) descriptors."""
    th = cfg.fast_th if fast_th is None else fast_th
    levels = build_pyramid(imgs, cfg.n_levels, cfg.scale_factor)
    kp = fast.detect_pyramid_batch(levels, th, cfg.n_points, cfg.edge_th,
                                   cfg.scale_factor)
    desc, _ = orb.describe_batch(imgs, kp.xy, kp.valid)
    return kp, desc


def _detect_describe_lines_batch(imgs: torch.Tensor, cfg: FrontendConfig):
    """(B, H, W) stack -> batched Segments + (B, K, 8) LBD descriptors."""
    min_len = cfg.min_line_length_frac * max(imgs.shape[1:])
    det_cfg = lines.LineDetectorConfig(max_out=cfg.n_lines,
                                       n_orient=cfg.line_orient_bins)
    seg = lines.detect_segments(imgs, det_cfg)
    seg = seg._replace(valid=seg.valid & (seg.length >= min_len))
    return seg, lbd.describe_batch(imgs, seg.sp, seg.ep, seg.valid)


def _detect_describe_lines(img: torch.Tensor, cfg: FrontendConfig):
    """(H, W) image -> Segments + (K, 8) LBD descriptors: the batched
    detector on ``img[None]``, the batch axis taken off."""
    seg, desc = _detect_describe_lines_batch(img[None], cfg)
    return type(seg)(*(x[0] for x in seg)), desc[0]


def _match_stereo_points(kp_l, desc_l, kp_r, desc_r, cam: StereoCamera,
                         cfg: FrontendConfig) -> PointSet:
    """Left-right point matching + epipolar/disparity gates
    (stereoFrame.cpp:121-171) on one image pair's keypoints."""
    pair_mask = M.stereo_point_pair_mask(
        kp_l.xy, kp_r.xy, kp_l.valid, kp_r.valid,
        max_disp=cfg.stereo_window, row_tol=cfg.stereo_row_tol)
    match = M.match_descriptors(desc_l, desc_r, pair_mask, cfg.nnr)

    idx_r = torch.clamp(match.idx, 0, cfg.n_points - 1).long()
    xy_r = kp_r.xy[idx_r]
    matched = match.idx >= 0
    dy = torch.abs(kp_l.xy[:, 1] - xy_r[:, 1])
    disp = kp_l.xy[:, 0] - xy_r[:, 0]
    ok = matched & (dy <= cfg.max_dist_epip) & (disp >= cfg.min_disp)

    disp_safe = torch.where(ok, disp, 1.0)
    return PointSet(uv=kp_l.xy, disp=disp_safe, P=cam.back_project(kp_l.xy, disp_safe),
                    desc=desc_l, sigma2=_sigma2(kp_l.level, cfg.scale_factor),
                    valid=ok)


def _match_stereo_lines(seg_l, desc_l, seg_r, desc_r, cam: StereoCamera,
                        cfg: FrontendConfig) -> LineSet:
    """Left-right line matching, disparity-ratio and overlap filters, and
    the Pluecker line of the two back-projected planes
    (stereoFrame.cpp:183-500, 870-883)."""
    n = cfg.n_lines
    pair_mask = M.line_pair_mask(
        seg_l.sp, seg_l.ep, seg_r.sp, seg_r.ep, seg_l.valid, seg_r.valid,
        radius=cfg.line_window, min_dir_cos=cfg.line_sim_th)
    match = M.match_descriptors(desc_l, desc_r, pair_mask, cfg.nnr)

    j = torch.clamp(match.idx, 0, n - 1).long()
    matched = match.idx >= 0
    sp_l, ep_l = seg_l.sp, seg_l.ep
    sp_r, ep_r = seg_r.sp[j], seg_r.ep[j]

    def x_at_y(sp, ep, y):
        dy = ep[:, 1] - sp[:, 1]
        t = (y - sp[:, 1]) / torch.where(torch.abs(dy) > 1e-6, dy,
                                         torch.full_like(dy, 1e-6))
        return sp[:, 0] + t * (ep[:, 0] - sp[:, 0])

    xr_s = x_at_y(sp_r, ep_r, sp_l[:, 1])
    xr_e = x_at_y(sp_r, ep_r, ep_l[:, 1])
    disp_s = sp_l[:, 0] - xr_s
    disp_e = ep_l[:, 0] - xr_e
    ratio = torch.minimum(disp_s, disp_e) / torch.clamp(
        torch.maximum(disp_s, disp_e), min=1e-9)
    ratio_ok = ratio >= cfg.ls_min_disp_ratio

    sln = torch.minimum(sp_l[:, 1], ep_l[:, 1])
    eln = torch.maximum(sp_l[:, 1], ep_l[:, 1])
    spn = torch.minimum(sp_r[:, 1], ep_r[:, 1])
    epn = torch.maximum(sp_r[:, 1], ep_r[:, 1])
    inter = torch.minimum(eln, epn) - torch.maximum(sln, spn)
    overlap = torch.clamp(inter / torch.clamp(eln - spn, min=1e-2), 0.0, 1.0)

    ok = (matched & ratio_ok
          & (disp_s >= cfg.min_disp) & (disp_e >= cfg.min_disp)
          & (torch.abs(sp_l[:, 1] - ep_l[:, 1]) > cfg.line_horiz_th)
          & (torch.abs(sp_r[:, 1] - ep_r[:, 1]) > cfg.line_horiz_th)
          & (overlap > cfg.stereo_overlap_th))

    disp_s = torch.where(ok, disp_s, 1.0)
    disp_e = torch.where(ok, disp_e, 1.0)
    sP = cam.back_project(sp_l, disp_s)
    eP = cam.back_project(ep_l, disp_e)

    ones = torch.ones((n, 1), dtype=sp_l.dtype, device=sp_l.device)
    le = torch.linalg.cross(torch.cat([sp_l, ones], -1), torch.cat([ep_l, ones], -1),
                            dim=-1)
    le = le / torch.clamp(torch.linalg.norm(le[:, :2], dim=-1, keepdim=True), min=1e-9)

    o1 = torch.zeros(3, dtype=sp_l.dtype, device=sp_l.device)
    o2 = cam.b * torch.eye(3, dtype=sp_l.dtype, device=sp_l.device)[0]
    r1s = cam.back_project_unit(sp_l)
    r1e = cam.back_project_unit(ep_l)
    r2s = cam.back_project_unit(torch.stack([xr_s, sp_l[:, 1]], -1)) + o2
    r2e = cam.back_project_unit(torch.stack([xr_e, ep_l[:, 1]], -1)) + o2
    NDc = plucker_from_planes(plane_from_points(r1s, r1e, o1),
                              plane_from_points(r2s, r2e, o2))
    return LineSet(sp=sp_l, ep=ep_l, sdisp=disp_s, edisp=disp_e, sP=sP, eP=eP,
                   le=le, angle=seg_l.angle, NDc=NDc, desc=desc_l,
                   sigma2=torch.ones(n, dtype=sp_l.dtype, device=sp_l.device),
                   valid=ok)
