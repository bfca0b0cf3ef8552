"""Patch extraction and in-patch sampling (``plslam_tpu.ops.patches``).

The JAX package writes both as one-hot matmuls because scattered gathers
are slow on a TPU.  Their semantics are an integer-offset window gather
with zero fill (``cuda_patches.gather_patches_batch``) and a nearest,
zero-filled sample inside the patch, both written here as gathers.
"""

from __future__ import annotations

import torch

from .cuda_patches import gather_patches_batch


def _round_half_up(x: torch.Tensor) -> torch.Tensor:
    """floor(x + 0.5): unlike round-half-to-even, a half-pixel coordinate
    anchors the same way whatever the parity of its integer part."""
    return torch.floor(x + 0.5)


def corners(xy: torch.Tensor, center: float) -> tuple[torch.Tensor, torch.Tensor]:
    """int32 (y0, x0) top-left corners of the patches centred at xy."""
    c = int(round(center))
    y0 = _round_half_up(xy[..., 1]).to(torch.int32) - c
    x0 = _round_half_up(xy[..., 0]).to(torch.int32) - c
    return y0.contiguous(), x0.contiguous()


def extract_patches(img: torch.Tensor, xy: torch.Tensor, patch: int,
                    center_offset: float | None = None) -> torch.Tensor:
    """(K, P, P) patches of one (H, W) image around xy (K, 2):
    patch[k, r, c] = img[round(y_k) + r - off, round(x_k) + c - off]."""
    off = (patch - 1) / 2.0 if center_offset is None else center_offset
    y0, x0 = corners(xy, off)
    return gather_patches_batch(img[None].contiguous(), y0[None], x0[None], patch)[0]


def sample_in_patches(patches: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Nearest samples of (..., P, P) patches at (..., S, 2) in-patch
    (u=col, v=row) coordinates -> (..., S); 0 outside the patch."""
    P = patches.shape[-1]
    vi = _round_half_up(uv[..., 1]).long()
    ui = _round_half_up(uv[..., 0]).long()
    inside = (vi >= 0) & (vi < P) & (ui >= 0) & (ui < P)
    flat = (torch.clamp(vi, 0, P - 1) * P + torch.clamp(ui, 0, P - 1))
    vals = torch.gather(patches.flatten(-2), -1, flat)
    return torch.where(inside, vals, 0.0)
