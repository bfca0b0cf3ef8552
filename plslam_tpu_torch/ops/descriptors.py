"""Binary descriptors: packing, unpacking, plain Hamming distance.

Descriptors are (..., 8) int32 words holding the bit patterns of the JAX
package's uint32 words (``plslam_tpu.ops.descriptors``, LSB-first: bit i
of word w is descriptor bit w*32 + i).  int32 because torch has no shifts
on uint32 and no popcount op.
"""

from __future__ import annotations

import torch

DESC_WORDS = 8
DESC_BITS = DESC_WORDS * 32


def _shifts(device) -> torch.Tensor:
    return torch.arange(32, dtype=torch.int64, device=device)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 256) {0,1} -> (..., 8) int32, LSB-first per word."""
    b = bits.reshape(bits.shape[:-1] + (DESC_WORDS, 32)).to(torch.int64)
    w = torch.sum(b << _shifts(bits.device), dim=-1)       # in [0, 2^32)
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def unpack_bits(desc: torch.Tensor) -> torch.Tensor:
    """(..., 8) int32 -> (..., 256) int8 in {0, 1}."""
    bits = (desc[..., None].to(torch.int64) >> _shifts(desc.device)) & 1
    return bits.reshape(desc.shape[:-1] + (DESC_BITS,)).to(torch.int8)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of each int32 word (SWAR on the unsigned value, in int64)."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming_distance_matrix(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """(..., N1, 8) x (..., N2, 8) int32 -> (..., N1, N2) int32,
    popcount(a XOR b); leading axes broadcast."""
    x = popcount32(d1[..., :, None, :] ^ d2[..., None, :, :])
    return x.sum(dim=-1).to(torch.int32)
