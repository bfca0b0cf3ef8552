"""256-bit Hamming distance matrix: CUDA kernel ``csrc/hamming.cu`` (the
inner product on the tensor cores) and its plain twin.

Counterpart of ``plslam_tpu/ops/pallas_hamming.py``
(``hamming_distance_matrix_pallas``).  CUDA tensors go to the kernel; CPU
tensors to the plain version (``descriptors.hamming_distance_matrix``);
anything else raises.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .descriptors import DESC_WORDS, hamming_distance_matrix

hamming_plain = hamming_distance_matrix


@cuda_lib.counted
def hamming_distance_matrix_cuda(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """(N1, 8) x (N2, 8) int32 -> (N1, N2) int32 Hamming distances."""
    if d1.dim() != 2 or d2.dim() != 2 or d1.shape[1] != DESC_WORDS \
            or d2.shape[1] != DESC_WORDS:
        raise ValueError(f"hamming: want (N, {DESC_WORDS}) words, got "
                         f"{tuple(d1.shape)}, {tuple(d2.shape)}")
    if d1.device.type == "cpu" and d2.device.type == "cpu":
        return hamming_plain(d1, d2)
    cuda_lib.require_cuda("hamming", d1, d2)
    if d1.dtype != torch.int32 or d2.dtype != torch.int32:
        raise TypeError("hamming: want int32 descriptor words")
    n1, n2 = d1.shape[0], d2.shape[0]
    out = torch.empty((n1, n2), dtype=torch.int32, device=d1.device)
    lib = cuda_lib.load().lib
    with torch.cuda.device(d1.device):
        err = lib.plslam_hamming(d1.data_ptr(), d2.data_ptr(), out.data_ptr(),
                                 n1, n2, cuda_lib.stream_ptr(d1.device))
    cuda_lib.check(err, "hamming")
    hamming_distance_matrix_cuda.count()
    return out
