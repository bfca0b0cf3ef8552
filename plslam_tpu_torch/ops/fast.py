"""FAST-9 corner detection on (B, H, W) stacks (``plslam_tpu.ops.fast``).

The score + NMS stage runs through ``cuda_fast.fast_score_nms_batch``
(the CUDA kernel on a CUDA tensor); this module holds its plain form
(``fast_score_map``, ``nms3x3``), the per-12x12-cell corner selection and
the multi-level detector.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .topk import top_k

# Bresenham circle radius 3 (dx, dy), clockwise
RING = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)
ARC = 9
CELL = 12  # spatial-bucket side (px) for per-cell corner selection


class Keypoints(NamedTuple):
    xy: torch.Tensor      # (B, K, 2) float (x, y) at full resolution
    score: torch.Tensor   # (B, K)
    level: torch.Tensor   # (B, K) int32 pyramid level
    valid: torch.Tensor   # (B, K) bool


def threshold_vector(threshold, B: int, device) -> torch.Tensor:
    """A scalar, 0-d or (B,) threshold as a contiguous (B,) f32 tensor."""
    if isinstance(threshold, torch.Tensor):
        return threshold.to(device=device, dtype=torch.float32).expand(B).contiguous()
    return torch.full((B,), float(threshold), dtype=torch.float32, device=device)


def fast_score_map(imgs: torch.Tensor, threshold: torch.Tensor) -> torch.Tensor:
    """Dense FAST-9 margin of a (B, H, W) stack, 0 where <= threshold (B,).

    Ring pixels wrap around the image (``torch.roll``) as in the JAX form;
    the 3-px frame they touch is masked by every caller's border."""
    diff = [torch.roll(imgs, (-dy, -dx), dims=(-2, -1)) - imgs for (dx, dy) in RING]
    d2 = diff + diff[:ARC - 1]                # wrapped ring, 24 entries

    def win9(vals, op):
        w2 = [op(vals[k], vals[k + 1]) for k in range(16 + 7)]
        w4 = [op(w2[k], w2[k + 2]) for k in range(16 + 5)]
        w8 = [op(w4[k], w4[k + 4]) for k in range(16 + 1)]
        return [op(w8[k], vals[k + 8]) for k in range(16)]

    mins = win9(d2, torch.minimum)
    maxs = win9(d2, torch.maximum)
    bright = torch.stack(mins).amax(dim=0)
    darkneg = torch.stack(maxs).amin(dim=0)
    margin = torch.maximum(bright, -darkneg)
    return torch.where(margin > threshold[:, None, None], margin, 0.0)


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-max suppression, -inf outside the image (SAME)."""
    mx = F.max_pool2d(score[:, None], 3, stride=1, padding=1)[:, 0]
    return torch.where((score >= mx) & (score > 0), score, 0.0)


def _subpix(c0, cm, cp):
    denom = cm - 2.0 * c0 + cp
    off = 0.5 * (cm - cp) / torch.where(torch.abs(denom) > 1e-9, denom,
                                        torch.full_like(denom, 1e-9))
    return torch.clamp(off, -0.5, 0.5)


def select_corners(raw: torch.Tensor, s: torch.Tensor, max_kp: int,
                   border: int, cell: int = CELL) -> Keypoints:
    """Per-cell argmax, top-K cells, parabolic sub-pixel refinement
    (``plslam_tpu/ops/fast.py:101``).  Each cell x cell tile contributes its
    best corner (the highest flat index among equal maxima); the top-K runs
    over the tile maxima."""
    B, H, W = raw.shape
    dev = raw.device
    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    inside = (xx >= border) & (xx < W - border) & (yy >= border) & (yy < H - border)
    s = torch.where(inside, s, 0.0)
    Hc, Wc = -(-H // cell), -(-W // cell)
    sp = F.pad(s, (0, Wc * cell - W, 0, Hc * cell - H))
    flat_ix = (torch.arange(Hc * cell, device=dev)[:, None] * W
               + torch.arange(Wc * cell, device=dev)[None, :])
    sc = sp.reshape(B, Hc, cell, Wc, cell)
    fc = flat_ix.reshape(Hc, cell, Wc, cell)
    cmax = sc.amax(dim=(2, 4))                                   # (B, Hc, Wc)
    hit = (sc == cmax[:, :, None, :, None]) & (sc > 0)
    cidx = torch.where(hit, fc, -1).amax(dim=(2, 4))             # (B, Hc, Wc)
    k = min(max_kp, Hc * Wc)
    vals, ci = top_k(cmax.reshape(B, -1), k)
    idx = torch.gather(cidx.reshape(B, -1), 1, ci)
    if k < max_kp:  # pad back up to the static capacity
        vals = F.pad(vals, (0, max_kp - k))
        idx = F.pad(idx, (0, max_kp - k), value=-1)
    idx = torch.clamp(idx, min=0)
    x = idx % W
    y = idx // W

    flat = raw.reshape(B, -1)

    def at(yv, xv):
        return torch.gather(flat, 1, yv * W + xv)

    s_c = at(y, x)
    off_x = _subpix(s_c, at(y, torch.clamp(x - 1, min=0)),
                    at(y, torch.clamp(x + 1, max=W - 1)))
    off_y = _subpix(s_c, at(torch.clamp(y - 1, min=0), x),
                    at(torch.clamp(y + 1, max=H - 1), x))
    xy = torch.stack([x.to(raw.dtype) + off_x, y.to(raw.dtype) + off_y], dim=-1)
    return Keypoints(xy=xy, score=vals,
                     level=torch.zeros((B, max_kp), dtype=torch.int32, device=dev),
                     valid=vals > 0)


def detect_pyramid_batch(levels, threshold, max_total: int, border: int,
                         scale_factor: float, per_level: int | None = None
                         ) -> Keypoints:
    """Multi-scale detection on a list of (B, h_l, w_l) stacks: score+NMS
    per level (the CUDA kernel on CUDA tensors), per-cell selection,
    coordinates scaled to level 0, global top ``max_total`` by score."""
    from .cuda_fast import fast_score_nms_batch  # cuda_fast imports this module

    n = len(levels)
    per = per_level or max_total // n + 1
    B = levels[0].shape[0]
    dev = levels[0].device
    thr = threshold_vector(threshold, B, dev)
    all_xy, all_s, all_l, all_v = [], [], [], []
    for i, imgs in enumerate(levels):
        raw, s = fast_score_nms_batch(imgs.contiguous(), thr)
        kp = select_corners(raw, s, per, border)
        all_xy.append(kp.xy * (scale_factor ** i))
        all_s.append(kp.score)
        all_l.append(torch.full((B, per), i, dtype=torch.int32, device=dev))
        all_v.append(kp.valid)
    xy = torch.cat(all_xy, dim=1)
    sc = torch.cat(all_s, dim=1)
    lv = torch.cat(all_l, dim=1)
    va = torch.cat(all_v, dim=1)
    vals, idx = top_k(torch.where(va, sc, -1.0), max_total)
    return Keypoints(xy=torch.gather(xy, 1, idx[..., None].expand(-1, -1, 2)),
                     score=vals, level=torch.gather(lv, 1, idx), valid=vals > 0)
