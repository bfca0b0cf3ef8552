"""Device and precision policy of the port, set in one place.

The JAX package pins full-f32 matmuls per entry point (``_hi_precision``
in ``plslam_tpu/vo.py``, ``_f32_matmuls`` in ``backend/ba.py``) because the
TPU's default bf16 passes cost the tracker sub-pixel accuracy and stalled
the BA.  The H100 analogue is TF32: cuDNN convolutions (the blur and Sobel
filters) default to it.  Importing this module turns TF32 off for both
matmuls and convolutions, for the whole process.

It also pins linear algebra on the card to cuSOLVER.  With the default
choice a batched ``cholesky_solve`` (the vmapped GN step of ``batch_vo``)
goes to MAGMA, whose ``magma_spotrs_batched`` allocates device memory on
every call, which a CUDA graph cannot capture; single-matrix calls and
batched Cholesky factorizations already went to cuSOLVER.
"""

from __future__ import annotations

import torch


def on_device(t: torch.Tensor, device: torch.device) -> bool:
    """Whether ``t`` lies on ``device``.  A bare ``cuda`` (no index, every
    entry point's default) names the current card, which is where
    ``.to("cuda")`` puts a tensor: that tensor reports ``cuda:0``, and
    ``torch.device("cuda") != torch.device("cuda:0")``."""
    if device.type == "cuda" and device.index is None:
        return t.device.type == "cuda" and t.device.index == torch.cuda.current_device()
    return t.device == device


def set_precision_policy() -> None:
    """Full-f32 matmuls and convolutions (no TF32); cuSOLVER for linear
    algebra on a CUDA build."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.is_built():
        torch.backends.cuda.preferred_linalg_library("cusolver")


set_precision_policy()
