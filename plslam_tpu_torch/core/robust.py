"""Robust statistics on masked residual vectors (``plslam_tpu.core.robust``).

Medians are the reference's upper median, sorted(valid)[n_valid // 2]
(auxiliar.cpp vector_stdv_mad :438), taken by sorting with +inf padding
and gathering at a device index, so nothing syncs with the host.
"""

from __future__ import annotations

import math

import torch

MAD_SCALE = 1.4826


def masked_median_upper(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """sorted(x[mask])[n_valid // 2] along the last axis; 0 if none valid."""
    n_valid = mask.sum(dim=-1, dtype=torch.int64)
    xs = torch.sort(torch.where(mask, x, math.inf), dim=-1).values
    idx = torch.clamp(n_valid // 2, 0, x.shape[-1] - 1)
    med = torch.gather(xs, -1, idx[..., None])[..., 0]
    return torch.where(n_valid > 0, med, torch.zeros_like(med))


def mad_stdv(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    med = masked_median_upper(x, mask)
    return MAD_SCALE * masked_median_upper(torch.abs(x - med[..., None]), mask)


def mean_stdv_mad(x: torch.Tensor, mask: torch.Tensor):
    """(mean, stdv): MAD stdv; mean over samples < 2*stdv when those are
    >= 20% of the population, else the plain mean (auxiliar.cpp :387)."""
    stdv = mad_stdv(x, mask)
    n = mask.to(x.dtype).sum(-1)
    good = mask & (x < 2.0 * stdv[..., None])
    k = good.to(x.dtype).sum(-1)
    trimmed = torch.where(good, x, 0.0).sum(-1) / torch.clamp(k, min=1.0)
    full = torch.where(mask, x, 0.0).sum(-1) / torch.clamp(n, min=1.0)
    mean = torch.where(k >= 0.2 * n, trimmed, full)
    return torch.where(n > 0, mean, torch.zeros_like(mean)), stdv


def cauchy_weight(norm_res: torch.Tensor) -> torch.Tensor:
    return 1.0 / (1.0 + norm_res * norm_res)


def clipped_mad_scale(res, mask, th_min: float = 1e-4,
                      th_max: float = 7.815 ** 0.5) -> torch.Tensor:
    """MAD scale clipped to [th_min, th_max] (stereoFrameHandler.cpp:612-650)."""
    return torch.clamp(mad_stdv(res, mask), th_min, th_max)


def clipped_mad_scale_pair(res_a, mask_a, res_b, mask_b, th_min: float = 1e-4,
                           th_max: float = 7.815 ** 0.5):
    """Both modalities' clipped MAD scales from one (2, N) sort; per-row
    results equal clipped_mad_scale (padding enters masked out)."""
    n = max(res_a.shape[-1], res_b.shape[-1])

    def pad(v, fill):
        return torch.cat([v, v.new_full((n - v.shape[-1],), fill)])

    x = torch.stack([pad(res_a, 0.0), pad(res_b.to(res_a.dtype), 0.0)])
    m = torch.stack([pad(mask_a, False), pad(mask_b, False)])
    s = clipped_mad_scale(x, m, th_min, th_max)
    return s[0], s[1]
