"""Line Band Descriptor on (B, K) segments (``plslam_tpu.ops.lbd``).

Six 48x48 patches of the Sobel gradients are gathered along each segment
(one kernel launch serves gx and gy of both images); inside each patch a
line-aligned (9 bands x 5) x 6 grid is sampled nearest, gradients are
rotated into the line frame, and per band the mean and population std of
the four half-wave components are pooled, normalised and binarised by a
fixed pair pattern into 256 bits.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .cuda_patches import gather_patches_batch
from .descriptors import pack_bits
from .image import blur, sobel
from .patches import corners, sample_in_patches

BANDS = 9
BAND_W = 5
Q_PATCHES = 6
S_ALONG = 6
PATCH = 48
CENTER = 23.0
FEAT_DIM = BANDS * 8


def _pair_pattern(seed: int = 4321, max_band_gap: int = 2) -> np.ndarray:
    """(256, 2) feature index pairs between nearby bands, the same numpy
    draw as ``plslam_tpu.ops.lbd._pair_pattern``."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < 256:
        i = int(rng.integers(0, FEAT_DIM))
        j = int(rng.integers(0, FEAT_DIM))
        if i == j or abs(i // 8 - j // 8) > max_band_gap:
            continue
        out.append((i, j))
    return np.asarray(out, np.int64)


@functools.lru_cache(maxsize=None)
def _pairs(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_pair_pattern()).to(device)


def _patch_centers(sp: torch.Tensor, ep: torch.Tensor) -> torch.Tensor:
    """(..., K, Q, 2) evenly spaced patch centres along each segment."""
    tq = (torch.arange(Q_PATCHES, dtype=sp.dtype, device=sp.device) + 0.5) / Q_PATCHES
    return sp[..., :, None, :] + tq[:, None] * (ep - sp)[..., :, None, :]


def describe_batch(imgs: torch.Tensor, sp: torch.Tensor, ep: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """(B, K, 8) int32 LBD descriptors of segments (B, K, 2) on (B, H, W)."""
    B, K = sp.shape[:2]
    gx, gy = sobel(blur(imgs, 1.4))
    c2 = _patch_centers(sp, ep).reshape(B, K * Q_PATCHES, 2)
    y0, x0 = corners(c2, CENTER)
    pat = gather_patches_batch(torch.cat([gx, gy]).contiguous(),
                               torch.cat([y0, y0]), torch.cat([x0, x0]), PATCH)
    return _describe_from_patches(pat[:B], pat[B:], sp, ep, valid)


def _describe_from_patches(px: torch.Tensor, py: torch.Tensor, sp: torch.Tensor,
                           ep: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Descriptor tail; px/py: (..., K*Q, P, P) gradient patches, sp/ep
    (..., K, 2)."""
    lead = sp.shape[:-2]
    K = sp.shape[-2]
    dev, dt = sp.device, sp.dtype
    d = ep - sp
    length = torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-6)
    dl = d / length
    dn = torch.stack([-dl[..., 1], dl[..., 0]], dim=-1)

    half = (BANDS * BAND_W) / 2.0
    a_off = (torch.arange(BANDS * BAND_W, dtype=dt, device=dev) + 0.5) - half
    seg_span = torch.clamp(length[..., 0] / Q_PATCHES, max=2 * (CENTER - half / 2))
    s_off = (torch.arange(S_ALONG, dtype=dt, device=dev) + 0.5) / S_ALONG - 0.5
    s_px = s_off * seg_span[..., None, None]                      # (..., K, 1, S)
    dl_, dn_ = dl[..., None, None, :], dn[..., None, None, :]
    a_ = a_off[:, None]                                           # (A, 1)
    u = CENTER + s_px * dl_[..., 0] + a_ * dn_[..., 0]            # (..., K, A, S)
    v = CENTER + s_px * dl_[..., 1] + a_ * dn_[..., 1]
    A = BANDS * BAND_W
    uv = torch.stack([u, v], dim=-1).reshape(lead + (K, 1, A * S_ALONG, 2))
    uv_q = uv.expand(lead + (K, Q_PATCHES, A * S_ALONG, 2)).reshape(
        lead + (K * Q_PATCHES, A * S_ALONG, 2))
    shape = lead + (K, Q_PATCHES, A, S_ALONG)
    sx = sample_in_patches(px, uv_q).reshape(shape)
    sy = sample_in_patches(py, uv_q).reshape(shape)

    e = (...,) + (None,) * 3
    g_par = sx * dl[e + (0,)] + sy * dl[e + (1,)]
    g_nrm = sx * dn[e + (0,)] + sy * dn[e + (1,)]

    feats = torch.stack([torch.clamp(g_par, min=0.0), torch.clamp(-g_par, min=0.0),
                         torch.clamp(g_nrm, min=0.0), torch.clamp(-g_nrm, min=0.0)],
                        dim=-1)                                   # (..., K, Q, A, S, 4)
    n = len(lead)
    feats = feats.permute(*range(n), n, n + 2, n + 1, n + 3, n + 4).reshape(
        lead + (K, BANDS, BAND_W * Q_PATCHES * S_ALONG, 4))
    mean = feats.mean(dim=-2)
    std = feats.std(dim=-2, correction=0)
    f = torch.cat([mean, std], dim=-1).reshape(lead + (K, FEAT_DIM))
    f = f / torch.clamp(torch.linalg.norm(f, dim=-1, keepdim=True), min=1e-9)

    pairs = _pairs(dev)
    desc = pack_bits(f[..., pairs[:, 0]] > f[..., pairs[:, 1]])
    return torch.where(valid[..., None], desc, 0)
