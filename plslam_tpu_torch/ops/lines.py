"""Tile-parallel line-segment detection on (B, H, W) stacks
(``plslam_tpu.ops.lines``).

Edge pixels (gradient magnitude + NMS across the gradient) are assigned
to two of O signed-orientation bins; per (16x16 cell, bin) weighted
moments give a line fit, extreme member projections give its endpoints;
the top cell-segments by mass are merged across cells by min-label
propagation over a collinear-and-adjacent graph.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .image import blur, sobel
from .topk import top_k


class Segments(NamedTuple):
    sp: torch.Tensor      # (B, K, 2) start point (x, y)
    ep: torch.Tensor      # (B, K, 2) end point
    angle: torch.Tensor   # (B, K)
    length: torch.Tensor  # (B, K)
    score: torch.Tensor   # (B, K) supporting-pixel mass
    valid: torch.Tensor   # (B, K) bool


class LineDetectorConfig(NamedTuple):
    tile: int = 16
    n_orient: int = 16
    mag_th: float = 30.0
    min_pix: float = 9.0
    straight_th: float = 1.5
    angle_merge_deg: float = 10.0
    dist_merge: float = 2.5
    gap_merge: float = 6.0
    max_cells: int = 1024
    max_out: int = 256


def _edge_nms(mag: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """Keep pixels that are maxima across the 4-way quantised gradient
    direction (neighbours wrap around the image, as in the JAX form)."""
    ang = torch.atan2(gy, gx)
    a = torch.remainder(torch.round(ang / (math.pi / 4.0)).to(torch.int32), 4)

    def shifted(dy, dx):
        return torch.roll(mag, (-dy, -dx), dims=(-2, -1))

    na = torch.where(a == 0, shifted(0, 1), torch.where(
        a == 1, shifted(1, 1), torch.where(a == 2, shifted(1, 0), shifted(1, -1))))
    nb = torch.where(a == 0, shifted(0, -1), torch.where(
        a == 1, shifted(-1, -1), torch.where(a == 2, shifted(-1, 0), shifted(-1, 1))))
    return (mag >= na) & (mag >= nb)


def detect_segments(imgs: torch.Tensor,
                    cfg: LineDetectorConfig = LineDetectorConfig()) -> Segments:
    B, H, W = imgs.shape
    t = cfg.tile
    TH, TW = H // t, W // t
    O = cfg.n_orient
    dt, dev = imgs.dtype, imgs.device

    gx, gy = sobel(blur(imgs, 1.0))
    mag = torch.sqrt(gx * gx + gy * gy)
    edge = _edge_nms(mag, gx, gy) & (mag > cfg.mag_th)

    phi = torch.remainder(torch.atan2(gy, gx), 2.0 * math.pi)
    bin_w = 2.0 * math.pi / O
    b0 = torch.clamp((phi / bin_w).to(torch.int32), 0, O - 1)
    frac = phi / bin_w - b0.to(dt)
    b1 = torch.remainder(torch.where(frac >= 0.5, b0 + 1, b0 - 1), O)
    bins = torch.arange(O, device=dev, dtype=torch.int32)
    onehot = ((b0[..., None] == bins).to(dt) + (b1[..., None] == bins).to(dt))  # (B,H,W,O)
    w = torch.where(edge, mag, 0.0)[..., None] * onehot

    yy = torch.arange(H, device=dev, dtype=dt)[:, None].expand(H, W)
    xx = torch.arange(W, device=dev, dtype=dt)[None, :].expand(H, W)

    def cellsum(v):  # (B, H, W, O) -> (B, TH, TW, O)
        v = v[:, : TH * t, : TW * t]
        return v.reshape(B, TH, t, TW, t, O).sum(dim=(2, 4))

    S = cellsum(w)
    Sx = cellsum(w * xx[..., None])
    Sy = cellsum(w * yy[..., None])
    Sxx = cellsum(w * (xx * xx)[..., None])
    Sxy = cellsum(w * (xx * yy)[..., None])
    Syy = cellsum(w * (yy * yy)[..., None])

    Ssafe = torch.clamp(S, min=1e-9)
    cx = Sx / Ssafe
    cy = Sy / Ssafe
    vxx = Sxx / Ssafe - cx * cx
    vxy = Sxy / Ssafe - cx * cy
    vyy = Syy / Ssafe - cy * cy
    fit_theta = 0.5 * torch.atan2(2.0 * vxy, vxx - vyy)
    dx_, dy_ = torch.cos(fit_theta), torch.sin(fit_theta)
    var_n = torch.clamp(vxx * dy_ * dy_ - 2.0 * vxy * dx_ * dy_ + vyy * dx_ * dx_,
                        min=0.0)

    px = xx[: TH * t, : TW * t].reshape(TH, t, TW, t)
    py = yy[: TH * t, : TW * t].reshape(TH, t, TW, t)
    wm = w[:, : TH * t, : TW * t].reshape(B, TH, t, TW, t, O)

    def cell(v):  # (B, TH, TW, O) -> broadcast over the in-cell pixels
        return v[:, :, None, :, None, :]

    tproj = ((px[..., None] - cell(cx)) * cell(dx_)
             + (py[..., None] - cell(cy)) * cell(dy_))
    member = wm > 0
    big = 1e9
    tmin = torch.where(member, tproj, big).amin(dim=(2, 4))
    tmax = torch.where(member, tproj, -big).amax(dim=(2, 4))

    npix = cellsum((edge[..., None] * onehot).to(dt))
    ok = (npix >= cfg.min_pix) & (torch.sqrt(var_n) <= cfg.straight_th) & (tmax > tmin)

    C = TH * TW * O
    massf = torch.where(ok, S, 0.0).reshape(B, C)
    mass, sel = top_k(massf, min(cfg.max_cells, C))

    def pick(v):
        return torch.gather(v.reshape(B, C), 1, sel)

    cxf, cyf, dxf, dyf, t0, t1 = (pick(v) for v in (cx, cy, dx_, dy_, tmin, tmax))
    sp = torch.stack([cxf + t0 * dxf, cyf + t0 * dyf], dim=-1)
    ep = torch.stack([cxf + t1 * dxf, cyf + t1 * dyf], dim=-1)
    return _merge_components(sp, ep, torch.stack([dxf, dyf], dim=-1), mass,
                             mass > 0, cfg)


def _take(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """v[b, idx[b, n]] for (B, N) or (B, N, D) v."""
    if v.dim() == 2:
        return torch.gather(v, 1, idx)
    return torch.gather(v, 1, idx[..., None].expand(-1, -1, v.shape[-1]))


def _merge_components(sp, ep, d, mass, valid, cfg: LineDetectorConfig) -> Segments:
    """Union collinear, adjacent cell-segments (min-label propagation with
    pointer jumping), then take per-component extreme endpoints."""
    B, N = sp.shape[:2]
    dt, dev = sp.dtype, sp.device
    mid = 0.5 * (sp + ep)
    cosang = torch.abs(torch.einsum("bid,bjd->bij", d, d))
    ang_ok = cosang >= math.cos(math.radians(cfg.angle_merge_deg))
    rel = mid[:, None, :, :] - mid[:, :, None, :]
    normal_off = torch.abs(rel[..., 0] * (-d[:, :, None, 1]) + rel[..., 1] * d[:, :, None, 0])
    near_line = normal_off <= cfg.dist_merge
    ti_s = torch.einsum("bijd,bid->bij", sp[:, None, :, :] - mid[:, :, None, :], d)
    ti_e = torch.einsum("bijd,bid->bij", ep[:, None, :, :] - mid[:, :, None, :], d)
    j_lo = torch.minimum(ti_s, ti_e)
    j_hi = torch.maximum(ti_s, ti_e)
    half_i = 0.5 * torch.linalg.norm(ep - sp, dim=-1)
    gap = torch.maximum(j_lo - half_i[:, :, None], -j_hi - half_i[:, :, None])
    near_along = gap <= cfg.gap_merge
    A = ang_ok & near_line & near_along & valid[:, :, None] & valid[:, None, :]
    A = A | A.transpose(1, 2)
    A = A | torch.eye(N, dtype=torch.bool, device=dev)

    idx = torch.arange(N, dtype=torch.int64, device=dev).expand(B, N)
    root = idx
    for _ in range(max(1, math.ceil(math.log2(max(N, 2)))) + 2):
        nbr = torch.where(A, root[:, None, :], N).amin(dim=2)
        root = torch.minimum(root, nbr)
        root = torch.minimum(root, torch.gather(root, 1, root))
    is_root = (root == idx) & valid

    droot = _take(d, root)
    sign = torch.sign(torch.einsum("bnd,bnd->bn", d, droot) + 1e-12)
    dal = d * sign[..., None] * mass[..., None]
    dsum = torch.zeros((B, N, 2), dtype=dt, device=dev).scatter_add_(
        1, root[..., None].expand(-1, -1, 2), torch.where(valid[..., None], dal, 0.0))
    dnorm = torch.linalg.norm(dsum, dim=-1, keepdim=True)
    dmean = dsum / torch.clamp(dnorm, min=1e-9)

    anchor = _take(mid, root)
    dm_root = _take(dmean, root)
    t_s = torch.einsum("bnd,bnd->bn", sp - anchor, dm_root)
    t_e = torch.einsum("bnd,bnd->bn", ep - anchor, dm_root)
    big = 1e9
    lo = torch.minimum(t_s, t_e)
    hi = torch.maximum(t_s, t_e)
    tmin = torch.full((B, N), big, dtype=dt, device=dev).scatter_reduce_(
        1, root, torch.where(valid, lo, big), reduce="amin", include_self=True)
    tmax = torch.full((B, N), -big, dtype=dt, device=dev).scatter_reduce_(
        1, root, torch.where(valid, hi, -big), reduce="amax", include_self=True)
    msum = torch.zeros((B, N), dtype=dt, device=dev).scatter_add_(
        1, root, torch.where(valid, mass, 0.0))

    sp_m = anchor + tmin[..., None] * dmean
    ep_m = anchor + tmax[..., None] * dmean
    length = torch.linalg.norm(ep_m - sp_m, dim=-1)
    score = torch.where(is_root, msum, 0.0)

    vals, sel = top_k(score, min(cfg.max_out, N))
    sp_o = _take(sp_m, sel)
    ep_o = _take(ep_m, sel)
    length_o = torch.gather(length, 1, sel)
    dvec = ep_o - sp_o
    flip = (dvec[..., 0] < 0) | ((torch.abs(dvec[..., 0]) < 1e-9) & (dvec[..., 1] < 0))
    sp_o, ep_o = (torch.where(flip[..., None], ep_o, sp_o),
                  torch.where(flip[..., None], sp_o, ep_o))
    ang = torch.atan2(ep_o[..., 1] - sp_o[..., 1], ep_o[..., 0] - sp_o[..., 0])
    return Segments(sp=sp_o, ep=ep_o, angle=ang, length=length_o, score=vals,
                    valid=vals > 0)
