"""Device and precision policy of the port, set in one place.

The JAX package pins full-f32 matmuls per entry point (``_hi_precision``
in ``plslam_tpu/vo.py``, ``_f32_matmuls`` in ``backend/ba.py``) because the
TPU's default bf16 passes cost the tracker sub-pixel accuracy and stalled
the BA.  The H100 analogue is TF32: cuDNN convolutions (the blur and Sobel
filters) default to it.  Importing this module turns TF32 off for both
matmuls and convolutions, for the whole process.
"""

from __future__ import annotations

import torch


def set_precision_policy() -> None:
    """Full-f32 matmuls and convolutions (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


set_precision_policy()
