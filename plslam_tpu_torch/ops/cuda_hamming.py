"""256-bit Hamming distance matrix: CUDA kernel ``csrc/hamming.cu`` (the
inner product on the tensor cores) and its plain twin.

Counterpart of ``plslam_tpu/ops/pallas_hamming.py``
(``hamming_distance_matrix_pallas``).  CUDA tensors go to the kernel; CPU
tensors to the plain version (``descriptors.hamming_distance_matrix``);
anything else raises.  One launch computes one matrix or a batch of B
matrices (``blockIdx.z`` the stream).

Matching code calls the operator ``hamming_distance_matrix``
(``plslam::hamming_distance_matrix``), not the wrapper: its vmap rule turns
a 2-D call under ``torch.func.vmap`` into one batched launch, so the
per-stream matching of ``batch_vo`` stays written per stream.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .descriptors import DESC_WORDS, hamming_distance_matrix as hamming_plain


def _stream_stride(d: torch.Tensor) -> int:
    """Words between one stream's descriptors and the next's; each
    stream's (N, 8) block must be dense (the batch stride may be 0)."""
    n = d.shape[-2]
    if (n > 1 and d.stride(-2) != DESC_WORDS) or d.stride(-1) != 1:
        raise ValueError("hamming: each stream's (N, 8) words must be contiguous")
    return d.stride(0) if d.dim() == 3 else n * DESC_WORDS


@cuda_lib.counted
def hamming_distance_matrix_cuda(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """(N1, 8) x (N2, 8) int32 -> (N1, N2) int32 Hamming distances, or
    (B, N1, 8) x (B, N2, 8) -> (B, N1, N2) in one launch."""
    if d1.dim() != d2.dim() or d1.dim() not in (2, 3) or d1.shape[-1] != DESC_WORDS \
            or d2.shape[-1] != DESC_WORDS or (d1.dim() == 3 and d1.shape[0] != d2.shape[0]):
        raise ValueError(f"hamming: want ([B,] N, {DESC_WORDS}) words, got "
                         f"{tuple(d1.shape)}, {tuple(d2.shape)}")
    if d1.device.type == "cpu" and d2.device.type == "cpu":
        return hamming_plain(d1, d2)
    if d1.device.type != "cuda" or d1.device != d2.device:
        raise ValueError(f"hamming: tensors must share one CUDA device, got "
                         f"{d1.device}, {d2.device}")
    if d1.dtype != torch.int32 or d2.dtype != torch.int32:
        raise TypeError("hamming: want int32 descriptor words")
    s1, s2 = _stream_stride(d1), _stream_stride(d2)
    B = d1.shape[0] if d1.dim() == 3 else 1
    n1, n2 = d1.shape[-2], d2.shape[-2]
    out = torch.empty(d1.shape[:-2] + (n1, n2), dtype=torch.int32, device=d1.device)
    lib = cuda_lib.load().lib
    with torch.cuda.device(d1.device):
        err = lib.plslam_hamming(d1.data_ptr(), d2.data_ptr(), out.data_ptr(), B, n1, n2,
                                 s1, s2, cuda_lib.stream_ptr(d1.device))
    cuda_lib.check(err, "hamming")
    hamming_distance_matrix_cuda.count()
    return out


@torch.library.custom_op("plslam::hamming_distance_matrix", mutates_args=())
def hamming_distance_matrix(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """The operator form of ``hamming_distance_matrix_cuda``."""
    return hamming_distance_matrix_cuda(d1, d2)


@hamming_distance_matrix.register_vmap
def _(info, in_dims, d1, d2):
    """A vmapped 2-D call is one batched launch; an unbatched operand is
    shared by every stream at batch stride 0."""
    B = info.batch_size

    def lead(d, bdim):
        return d.movedim(bdim, 0) if bdim is not None else d.expand((B,) + d.shape)

    return hamming_distance_matrix(lead(d1, in_dims[0]), lead(d2, in_dims[1])), 0
