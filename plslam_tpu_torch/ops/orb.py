"""Oriented BRIEF descriptors on (B, K) keypoints (``plslam_tpu.ops.orb``).

48x48 patches of the blurred image come from the patch-gather kernel;
orientation is the intensity centroid over a radius-15 disc; a fixed
256-pair pattern, rotated by the keypoint angle, is sampled nearest inside
the patch and packed into 8 int32 words.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .cuda_patches import gather_patches_batch
from .descriptors import pack_bits
from .image import blur
from .patches import corners, sample_in_patches

PATCH_R = 15
N_PAIRS = 256
PATCH = 48
CENTER = 23.0


def _brief_pattern(seed: int = 1234) -> np.ndarray:
    """(256, 2, 2) pairs ~ N(0, (patch/5)^2) clipped to the patch, the
    same numpy draw as ``plslam_tpu.ops.orb._brief_pattern``."""
    rng = np.random.default_rng(seed)
    sigma = PATCH_R * 2 / 5.0
    pat = rng.normal(0.0, sigma, size=(N_PAIRS, 2, 2))
    return np.clip(pat, -PATCH_R, PATCH_R)


def _centroid_kernels() -> tuple[np.ndarray, np.ndarray]:
    rr, cc = np.mgrid[0:PATCH, 0:PATCH]
    dx = cc - CENTER
    dy = rr - CENTER
    disc = (dx**2 + dy**2 <= PATCH_R**2).astype(np.float32)
    return (dx * disc).astype(np.float32), (dy * disc).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    """(pattern (256, 2, 2), kx, ky) as f32 tensors on ``device``."""
    kx, ky = _centroid_kernels()
    pat = _brief_pattern().astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (pat, kx, ky))


def describe_batch(imgs: torch.Tensor, xy: torch.Tensor, valid: torch.Tensor,
                   blur_sigma: float = 2.0):
    """(B, K, 8) int32 descriptors and (B, K) angles of keypoints xy
    (B, K, 2) on a (B, H, W) stack."""
    smoothed = blur(imgs, blur_sigma).contiguous()
    y0, x0 = corners(xy, CENTER)
    patches = gather_patches_batch(smoothed, y0, x0, PATCH)
    return _describe_from_patches(patches, xy, valid)


def _describe_from_patches(patches: torch.Tensor, xy: torch.Tensor,
                           valid: torch.Tensor):
    """Descriptor tail on (..., K, P, P) patches."""
    pat, kx, ky = _tables(patches.device)
    m10 = torch.einsum("...rc,rc->...", patches, kx)
    m01 = torch.einsum("...rc,rc->...", patches, ky)
    theta = torch.atan2(m01, m10)
    norm = torch.sqrt(m10 * m10 + m01 * m01)
    safe = norm > 1e-6
    den = torch.where(safe, norm, torch.ones_like(norm))
    c = torch.where(safe, m10 / den, torch.ones_like(norm))
    s = torch.where(safe, m01 / den, torch.zeros_like(norm))

    px, py = pat[..., 0], pat[..., 1]                  # (256, 2)
    c_, s_ = c[..., None, None], s[..., None, None]
    rx = c_ * px - s_ * py
    ry = s_ * px + c_ * py
    frac = xy - torch.floor(xy + 0.5)                  # in (-0.5, 0.5]
    u = CENTER + frac[..., 0:1, None] + rx             # (..., 256, 2)
    v = CENTER + frac[..., 1:2, None] + ry
    uv = torch.stack([u, v], dim=-1).reshape(xy.shape[:-1] + (2 * N_PAIRS, 2))
    vals = sample_in_patches(patches, uv).reshape(xy.shape[:-1] + (N_PAIRS, 2))
    desc = pack_bits(vals[..., 0] < vals[..., 1])
    return torch.where(valid[..., None], desc, 0), theta
