"""Batched patch gather: CUDA kernel ``csrc/patches.cu`` and its plain twin.

Counterpart of ``plslam_tpu/ops/pallas_patches.py``
(``gather_patches_batch``).  CUDA tensors go to the kernel; CPU tensors
to the plain version; anything else raises.
"""

from __future__ import annotations

import torch

from . import cuda_lib


def gather_patches_plain(imgs: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
                         patch: int) -> torch.Tensor:
    """(B, N, P, P) with out[b, n, r, c] = imgs[b, y0+r, x0+c], 0 outside.

    Corners are clamped to [-P, H] x [-P, W] inside a P-px zero border,
    which leaves every window's content unchanged."""
    B, H, W = imgs.shape
    P = patch
    padded = torch.nn.functional.pad(imgs, (P, P, P, P))
    ar = torch.arange(P, device=imgs.device)
    ys = torch.clamp(y0.long(), -P, H)[..., None] + P + ar       # (B, N, P)
    xs = torch.clamp(x0.long(), -P, W)[..., None] + P + ar
    bi = torch.arange(B, device=imgs.device)[:, None, None, None]
    return padded[bi, ys[..., :, None], xs[..., None, :]]


@cuda_lib.counted
def gather_patches_batch(imgs: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
                         patch: int) -> torch.Tensor:
    """(B, N, P, P) patches of a (B, H, W) f32 stack at (B, N) int32 corners."""
    if imgs.dim() != 3 or y0.shape != x0.shape or y0.dim() != 2 \
            or y0.shape[0] != imgs.shape[0]:
        raise ValueError(f"gather_patches_batch: bad shapes {tuple(imgs.shape)}, "
                         f"{tuple(y0.shape)}, {tuple(x0.shape)}")
    if imgs.device.type == "cpu" and y0.device.type == "cpu" \
            and x0.device.type == "cpu":
        return gather_patches_plain(imgs, y0, x0, patch)
    cuda_lib.require_cuda("gather_patches_batch", imgs, y0, x0)
    if imgs.dtype != torch.float32 or y0.dtype != torch.int32 \
            or x0.dtype != torch.int32:
        raise TypeError("gather_patches_batch: want f32 images, int32 corners")
    B, H, W = imgs.shape
    N = y0.shape[1]
    out = torch.empty((B, N, patch, patch), dtype=torch.float32, device=imgs.device)
    lib = cuda_lib.load().lib
    with torch.cuda.device(imgs.device):
        err = lib.plslam_gather_patches(
            imgs.data_ptr(), y0.data_ptr(), x0.data_ptr(), out.data_ptr(),
            B, H, W, N, patch, cuda_lib.stream_ptr(imgs.device))
    cuda_lib.check(err, "gather_patches_batch")
    gather_patches_batch.count()
    return out

