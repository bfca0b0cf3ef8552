"""Mutual nearest-neighbour-ratio matching on masked distance matrices
(``plslam_tpu.ops.matching``).

Grid-window lookups of the reference (``src2/matching.cpp``) become
geometric candidate masks over the full distance matrix; invalid pairs get
a +BIG distance and never match.  The distance matrix comes from the
Hamming kernel (``cuda_hamming``) on CUDA tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .cuda_hamming import hamming_distance_matrix_cuda

BIG = 1 << 20


class MatchResult(NamedTuple):
    idx: torch.Tensor   # (N1,) int32, index into set 2 or -1
    dist: torch.Tensor  # (N1,) int32 distance of the accepted match


def _top2_min(dist: torch.Tensor):
    """Per-row (best, second-best, argbest); argmin takes the first index."""
    best, arg = torch.min(dist, dim=1)
    cols = torch.arange(dist.shape[1], device=dist.device)
    second = torch.where(cols[None, :] == arg[:, None], BIG, dist).amin(dim=1)
    return best, second, arg


def match_mutual_nnr(dist: torch.Tensor, pair_mask: torch.Tensor, nnr: float,
                     mutual: bool = True) -> MatchResult:
    """best < nnr * second (strict) and, when ``mutual``, row i is also the
    best row of its matched column (matching.cpp:41-89)."""
    d = torch.where(pair_mask, dist, BIG)
    best1, second1, arg1 = _top2_min(d)
    ok = (best1 < BIG) & (best1.to(torch.float32) < nnr * second1.to(torch.float32))
    if mutual:
        arg2 = torch.argmin(d, dim=0)
        rows = torch.arange(d.shape[0], device=d.device)
        ok = ok & (arg2[arg1] == rows)
    idx = torch.where(ok, arg1, -1).to(torch.int32)
    return MatchResult(idx=idx, dist=torch.where(ok, best1, BIG).to(torch.int32))


def stereo_point_pair_mask(xy_l, xy_r, valid_l, valid_r, max_disp: float,
                           row_tol: float) -> torch.Tensor:
    """Right feature left of the left one by at most max_disp px, same row
    within row_tol px (stereoFrame.cpp:121-160)."""
    dx = xy_l[:, None, 0] - xy_r[None, :, 0]
    dy = torch.abs(xy_l[:, None, 1] - xy_r[None, :, 1])
    m = (dx >= 0.0) & (dx <= max_disp) & (dy <= row_tol)
    return m & valid_l[:, None] & valid_r[None, :]


def window_pair_mask(xy_1, xy_2, valid_1, valid_2, radius_x: float,
                     radius_y: float) -> torch.Tensor:
    dx = torch.abs(xy_1[:, None, 0] - xy_2[None, :, 0])
    dy = torch.abs(xy_1[:, None, 1] - xy_2[None, :, 1])
    m = (dx <= radius_x) & (dy <= radius_y)
    return m & valid_1[:, None] & valid_2[None, :]


def _point_segment_dist2(p, a, b) -> torch.Tensor:
    """Squared distance of points p (N, 2) to segments (a, b) (M, 2)."""
    ab = b - a
    ap = p[:, None, :] - a[None, :, :]
    denom = torch.sum(ab * ab, dim=-1)
    t = torch.sum(ap * ab[None, :, :], dim=-1) / torch.clamp(denom, min=1e-12)
    t = torch.clamp(t, 0.0, 1.0)
    d = p[:, None, :] - (a[None, :, :] + t[..., None] * ab[None, :, :])
    return torch.sum(d * d, dim=-1)


def segment_window_mask(sp1, ep1, sp2, ep2, radius: float) -> torch.Tensor:
    """Some endpoint of either segment within radius px of the other."""
    r2 = radius * radius
    return ((_point_segment_dist2(sp1, sp2, ep2) <= r2)
            | (_point_segment_dist2(ep1, sp2, ep2) <= r2)
            | (_point_segment_dist2(sp2, sp1, ep1).T <= r2)
            | (_point_segment_dist2(ep2, sp1, ep1).T <= r2))


def line_pair_mask(sp1, ep1, sp2, ep2, valid_1, valid_2, radius: float,
                   min_dir_cos: float) -> torch.Tensor:
    """Direction filter |cos| >= min_dir_cos (matching.cpp:221) and the
    symmetric full-segment proximity window."""
    v1 = ep1 - sp1
    v2 = ep2 - sp2
    n1 = torch.clamp(torch.linalg.norm(v1, dim=-1, keepdim=True), min=1e-12)
    n2 = torch.clamp(torch.linalg.norm(v2, dim=-1, keepdim=True), min=1e-12)
    cos = torch.abs((v1 / n1) @ (v2 / n2).T)
    near = segment_window_mask(sp1, ep1, sp2, ep2, radius)
    return (cos >= min_dir_cos) & near & valid_1[:, None] & valid_2[None, :]


def match_descriptors(desc1, desc2, pair_mask, nnr: float,
                      mutual: bool = True) -> MatchResult:
    """Hamming distance matrix (kernel on CUDA) + mutual NNR."""
    dist = hamming_distance_matrix_cuda(desc1.contiguous(), desc2.contiguous())
    return match_mutual_nnr(dist, pair_mask, nnr, mutual)


def _perp_dist(q, sp, ep) -> torch.Tensor:
    """Distance of points q to the infinite lines through (sp, ep)."""
    d = ep - sp
    n = torch.clamp(torch.linalg.norm(d, dim=-1), min=1e-9)
    rel = q - sp
    return torch.abs(rel[..., 0] * d[..., 1] - rel[..., 1] * d[..., 0]) / n


def line_twoway_gate(sp1, ep1, sp2, ep2, idx: torch.Tensor,
                     max_perp: float) -> torch.Tensor:
    """Reject matches whose endpoints lie more than max_perp px from the
    other segment's infinite line, either way round; idx -> -1."""
    j = torch.clamp(idx, min=0).long()
    s2, e2 = sp2[j], ep2[j]
    d1 = torch.maximum(_perp_dist(sp1, s2, e2), _perp_dist(ep1, s2, e2))
    d2 = torch.maximum(_perp_dist(s2, sp1, ep1), _perp_dist(e2, sp1, ep1))
    ok = (d1 <= max_perp) & (d2 <= max_perp)
    return torch.where(ok, idx, -1)
