"""Frame-to-frame association (``plslam_tpu.frontend.f2f``;
matchF2FPoints :131 and matchF2FLines :155 of stereoFrameHandler.cpp)."""

from __future__ import annotations

import torch

from ..ops import matching as M
from .features import StereoFeatures, TrackedLines, TrackedPoints


def track_frame_to_frame(prev: StereoFeatures, curr: StereoFeatures,
                         nnr: float = 0.9, window: float = 120.0,
                         line_twoway_px: float = 25.0):
    """(TrackedPoints, TrackedLines, point idx, line idx): prev-frame 3D
    geometry paired with curr-frame observations by windowed mutual NNR,
    lines also through the two-way reprojection gate."""
    p_prev, p_curr = prev.points, curr.points
    pm = M.window_pair_mask(p_prev.uv, p_curr.uv, p_prev.valid, p_curr.valid,
                            radius_x=window, radius_y=window)
    pmatch = M.match_descriptors(p_prev.desc, p_curr.desc, pm, nnr)
    pj = torch.clamp(pmatch.idx, 0, p_curr.capacity - 1).long()
    p_ok = (pmatch.idx >= 0) & p_prev.valid
    pts = TrackedPoints(P=p_prev.P, obs=p_curr.uv[pj], sigma2=p_prev.sigma2,
                        valid=p_ok, inlier=torch.ones_like(p_ok))

    l_prev, l_curr = prev.lines, curr.lines
    lm = l_prev.valid[:, None] & l_curr.valid[None, :]
    lmask = lm & M.line_pair_mask(
        l_prev.sp, l_prev.ep, l_curr.sp, l_curr.ep,
        l_prev.valid, l_curr.valid, radius=window, min_dir_cos=0.75)
    lidx = M.match_descriptors(l_prev.desc, l_curr.desc, lmask, nnr).idx
    if line_twoway_px > 0:
        lidx = M.line_twoway_gate(l_prev.sp, l_prev.ep, l_curr.sp, l_curr.ep,
                                  lidx, line_twoway_px)
    lj = torch.clamp(lidx, 0, l_curr.capacity - 1).long()
    l_ok = (lidx >= 0) & l_prev.valid
    ls = TrackedLines(sP=l_prev.sP, eP=l_prev.eP, sp=l_prev.sp, ep=l_prev.ep,
                      NDc=l_prev.NDc, sobs=l_curr.sp[lj], eobs=l_curr.ep[lj],
                      le_obs=l_curr.le[lj], sigma2=l_prev.sigma2,
                      valid=l_ok, inlier=torch.ones_like(l_ok))
    return pts, ls, pmatch.idx, lidx
