"""Fused FAST-9 score + 3x3 NMS: CUDA kernel ``csrc/fast.cu`` and its
plain twin.

Counterpart of ``plslam_tpu/ops/pallas_fast.py`` (``fast_score_nms_batch``).
CUDA tensors go to the kernel; CPU tensors to the plain version
(``fast.fast_score_map`` + ``fast.nms3x3``); anything else raises.  The
kernel zero-pads outside the image where the plain form wraps, so the two
agree except in the 3-px frame (raw) and 4-px frame (nms), which the
detector's border mask (edge_th=19) discards.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .fast import fast_score_map, nms3x3


def fast_score_nms_plain(imgs: torch.Tensor, thr: torch.Tensor):
    raw = fast_score_map(imgs, thr)
    return raw, nms3x3(raw)


@cuda_lib.counted
def fast_score_nms_batch(imgs: torch.Tensor, thr: torch.Tensor):
    """(raw, nms) FAST-9 maps of a (B, H, W) f32 stack; thr is a (B,) f32
    per-image threshold that stays on the device."""
    if imgs.dim() != 3 or thr.shape != (imgs.shape[0],):
        raise ValueError(f"fast_score_nms_batch: bad shapes {tuple(imgs.shape)}, "
                         f"{tuple(thr.shape)}")
    if imgs.device.type == "cpu" and thr.device.type == "cpu":
        return fast_score_nms_plain(imgs, thr)
    cuda_lib.require_cuda("fast_score_nms_batch", imgs, thr)
    if imgs.dtype != torch.float32 or thr.dtype != torch.float32:
        raise TypeError("fast_score_nms_batch: want f32 images and thresholds")
    B, H, W = imgs.shape
    raw = torch.empty_like(imgs)
    nms = torch.empty_like(imgs)
    lib = cuda_lib.load().lib
    with torch.cuda.device(imgs.device):
        err = lib.plslam_fast_score_nms(
            imgs.data_ptr(), thr.data_ptr(), raw.data_ptr(), nms.data_ptr(),
            B, H, W, cuda_lib.stream_ptr(imgs.device))
    cuda_lib.check(err, "fast_score_nms_batch")
    fast_score_nms_batch.count()
    return raw, nms

