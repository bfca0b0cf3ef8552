"""The arithmetic of the CUDA kernels' inner loops, on the CPU: the
Hamming kernel's inner product (csrc/hamming.cu) and the int8 one of its
probe (csrc/probe/hamming_variants.cu), and the FAST kernel's window fold
(csrc/fast.cu), written out in torch with the kernels' own constants and
index order, against the plain versions."""

import numpy as np
import pytest
import torch

from plslam_tpu_torch.ops.descriptors import hamming_distance_matrix, popcount32, unpack_bits


def _words(n, seed):
    g = torch.Generator().manual_seed(seed)
    d = torch.randint(-2**31, 2**31, (n, 8), generator=g).to(torch.int32)
    d[:3] = -1
    d[3:5] = 0
    return d


def pm1x4(n: torch.Tensor) -> torch.Tensor:
    """The probe's pm1x4 on int64-held uint32 values: bits 0-3 of n as four
    int8 lanes, +1 for a set bit and -1 for a clear one; (..., 4) int8."""
    b = ((n & 0xF) * 0x00204081) & 0x01010101
    v = ~(b * 0xFE) & 0xFFFFFFFF
    lanes = torch.stack([(v >> (8 * i)) & 0xFF for i in range(4)], -1)
    return torch.where(lanes >= 128, lanes - 256, lanes).to(torch.int8)


def s8_operand(d: torch.Tensor) -> torch.Tensor:
    """(N, 8) words -> (N, 256) +/-1 int8 in the kernel's K order: step w
    holds word w; its 32 lanes are a thread group's registers a0/b0 (bits
    4t..4t+3, t = 0..3) then a2/b1 (bits 16+4t..16+4t+3)."""
    u = d.to(torch.int64) & 0xFFFFFFFF
    cols = []
    for w in range(8):
        cols += [pm1x4(u[:, w] >> (4 * t)) for t in range(4)]
        cols += [pm1x4(u[:, w] >> (16 + 4 * t)) for t in range(4)]
    return torch.cat(cols, -1)


@pytest.mark.parametrize("n1,n2", [(40, 70), (1, 9), (33, 1)])
def test_hamming_route_s8_identity(n1, n2):
    d1, d2 = _words(n1, 1), _words(n2, 2)
    a, b = s8_operand(d1), s8_operand(d2)
    # the lanes hold exactly the descriptor's bits as +/-1, in some K order
    assert torch.equal(a.sort(-1).values,
                       (2 * unpack_bits(d1).to(torch.int8) - 1).sort(-1).values)
    dot = a.to(torch.int32) @ b.to(torch.int32).T
    assert torch.equal((256 - dot) >> 1, hamming_distance_matrix(d1, d2))


@pytest.mark.parametrize("n1,n2", [(40, 70), (1, 9), (33, 1)])
def test_hamming_route_b1_identity(n1, n2):
    """Two AND + popcount products, a with NOT b and NOT a with b, sum to
    the Hamming distance (the accumulator is the output)."""
    d1, d2 = _words(n1, 3), _words(n2, 4)
    a, b = d1[:, None, :], d2[None, :, :]
    got = popcount32(a & ~b).sum(-1) + popcount32(~a & b).sum(-1)
    assert torch.equal(got.to(torch.int32), hamming_distance_matrix(d1, d2))


def fold_windows(d, window_min: bool):
    """csrc/fast.cu's fold_windows on (16, ...) arrays, index for index."""
    w = np.minimum if window_min else np.maximum
    fold = np.maximum if window_min else np.minimum
    S = [None] * 16
    S[8] = d[8]
    for k in range(7, -1, -1):
        S[k] = w(d[k], S[k + 1])
    S[15] = w(d[15], w(d[0], d[1]))
    for k in range(14, 8, -1):
        S[k] = w(d[k], S[k + 1])
    P1 = [d[9]]
    for i in range(1, 7):
        P1.append(w(P1[-1], d[9 + i]))
    P1.append(w(P1[6], d[0]))
    P2 = [d[2]]
    for i in range(1, 6):
        P2.append(w(P2[-1], d[2 + i]))
    acc = fold(S[0], S[9])
    for k in range(1, 9):
        acc = fold(acc, w(S[k], P1[k - 1]))
    for k in range(10, 16):
        acc = fold(acc, w(S[k], P2[k - 10]))
    return acc


@pytest.mark.parametrize("seed", [0, 1])
def test_fast_window_fold(seed):
    """The Gil-Werman fold gives, bit for bit, the max over the 16 arcs of
    the min over 9 contiguous ring values (and the min of the max)."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(16, 20000)).astype(np.float32)
    d[:, :100] = np.round(d[:, :100])       # ties
    d[:, 100:200] = 0.0
    arcs = d[(np.arange(16)[:, None] + np.arange(9)[None]) % 16]     # (16, 9, n)
    np.testing.assert_array_equal(fold_windows(d, True), arcs.min(1).max(0))
    np.testing.assert_array_equal(fold_windows(d, False), arcs.max(1).min(0))


def test_fast_compass_reject_is_exact():
    """Every 9-arc of the 16-point ring holds point 0 or 8 and point 4 or 12,
    so where the compass points give no such pair beyond the threshold in
    either direction, the score is exactly 0, as the kernel skips it."""
    for start in range(16):
        arc = {(start + a) % 16 for a in range(9)}
        assert arc & {0, 8} and arc & {4, 12}
    rng = np.random.default_rng(2)
    d = rng.normal(0, 20, size=(16, 50000)).astype(np.float32)
    th = np.float32(15.0)
    m = np.maximum(fold_windows(d, True), -fold_windows(d, False))
    bright = ((d[0] > th) | (d[8] > th)) & ((d[4] > th) | (d[12] > th))
    dark = ((d[0] < -th) | (d[8] < -th)) & ((d[4] < -th) | (d[12] < -th))
    rejected = ~(bright | dark)
    assert rejected.mean() > 0.3 and (m > th).any()
    assert not (m[rejected] > th).any()


@pytest.mark.parametrize("n1,n2", [(40, 70), (1, 9)])
def test_hamming_probe_and_pop_identity(n1, n2):
    """The probe's one-product form: popc(a) + popc(b) - 2 popc(a AND b)."""
    d1, d2 = _words(n1, 5), _words(n2, 6)
    pa, pb = popcount32(d1).sum(-1), popcount32(d2).sum(-1)
    dot = popcount32(d1[:, None, :] & d2[None, :, :]).sum(-1)
    got = pa[:, None] + pb[None, :] - 2 * dot
    assert torch.equal(got.to(torch.int32), hamming_distance_matrix(d1, d2))
