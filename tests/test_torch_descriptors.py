"""Descriptor words and tables: plslam_tpu_torch against plslam_tpu.

Bit outputs are held exactly: pack/unpack, the plain Hamming matrix
against the JAX popcount oracle and the Pallas kernel (interpret mode),
and the constant tables the port re-derives with the same numpy code."""

import jax.numpy as jnp
import numpy as np
import pytest

from plslam_tpu.ops import descriptors as jd
from plslam_tpu.ops import image as jimage
from plslam_tpu.ops import lbd as jlbd
from plslam_tpu.ops import orb as jorb
from plslam_tpu.ops import pallas_hamming as jph
from plslam_tpu_torch import convert
from plslam_tpu_torch.ops import cuda_hamming, descriptors, image, lbd, orb

from test_torch_helpers import t, to_np, words


def _desc(rng, n):
    return rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)


def test_pack_unpack_bit_exact():
    rng = np.random.default_rng(0)
    bits = (rng.uniform(size=(33, 256)) > 0.5).astype(np.uint8)
    bits[0] = 1          # all-ones words: the sign bit of int32
    bits[1] = 0
    want = np.asarray(jd.pack_bits(jnp.asarray(bits)))
    got = to_np(descriptors.pack_bits(t(bits)))
    np.testing.assert_array_equal(got, words(want))
    np.testing.assert_array_equal(to_np(descriptors.unpack_bits(t(want))),
                                  np.asarray(jd.unpack_bits(jnp.asarray(want))))


@pytest.mark.parametrize("n1,n2", [(100, 60), (128, 256), (1, 1)])
def test_plain_hamming_matches_popcount_oracle(n1, n2):
    rng = np.random.default_rng(n1)
    d1, d2 = _desc(rng, n1), _desc(rng, n2)
    want = np.asarray(jd.hamming_distance_matrix_popcount(jnp.asarray(d1), jnp.asarray(d2)))
    got = to_np(cuda_hamming.hamming_distance_matrix_cuda(t(d1), t(d2)))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(jd.hamming_distance_matrix(jnp.asarray(d1), jnp.asarray(d2))))


def test_plain_hamming_matches_pallas_interpret():
    from jax.experimental.pallas import tpu as pltpu

    rng = np.random.default_rng(7)
    d1, d2 = _desc(rng, 256), _desc(rng, 128)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jph.hamming_distance_matrix_pallas(jnp.asarray(d1),
                                                             jnp.asarray(d2)))
    np.testing.assert_array_equal(to_np(cuda_hamming.hamming_plain(t(d1), t(d2))), want)


def test_convert_keeps_descriptor_bits():
    rng = np.random.default_rng(3)
    d = _desc(rng, 16)
    x = convert.tensor_from_numpy(d, "cpu")
    np.testing.assert_array_equal(x.numpy().view(np.uint32), d)
    np.testing.assert_array_equal(to_np(descriptors.unpack_bits(x)),
                                  np.asarray(jd.unpack_bits(jnp.asarray(d))))


def test_tables_equal_jax_constants():
    np.testing.assert_array_equal(orb._brief_pattern(), jorb._PATTERN)
    np.testing.assert_array_equal(np.stack(orb._centroid_kernels()),
                                  np.stack([jorb._KX, jorb._KY]))
    np.testing.assert_array_equal(lbd._pair_pattern(), jlbd._PAIRS)
    for sigma in (1.0, 1.4, 2.0):
        np.testing.assert_array_equal(image._gaussian_taps(sigma),
                                      jimage._gaussian_taps(sigma))
    for n_out, n_in in ((400, 480), (522, 752), (100, 120)):
        np.testing.assert_array_equal(image._resize_matrix(n_out, n_in),
                                      jimage._resize_matrix(n_out, n_in))


@pytest.mark.parametrize("B,n1,n2", [(1, 5, 7), (3, 37, 300), (4, 0, 9), (2, 64, 1)])
def test_batched_hamming_operator_on_the_cpu(B, n1, n2):
    """The batched call, and a 2-D call under torch.func.vmap (one batched
    call through the operator's vmap rule), equal the plain matrix of
    each stream; an unbatched operand is shared by every stream."""
    import torch

    rng = np.random.default_rng(B * 100 + n1)
    d1 = t(np.stack([_desc(rng, n1) for _ in range(B)]))
    d2 = t(np.stack([_desc(rng, n2) for _ in range(B)]))
    want = torch.stack([descriptors.hamming_distance_matrix(a, b) for a, b in zip(d1, d2)])
    assert torch.equal(cuda_hamming.hamming_distance_matrix_cuda(d1, d2), want)
    op = cuda_hamming.hamming_distance_matrix
    assert torch.equal(torch.func.vmap(op)(d1, d2), want)
    shared = torch.func.vmap(op, in_dims=(0, None))(d1, d2[0])
    assert torch.equal(shared, torch.stack([descriptors.hamming_distance_matrix(a, d2[0])
                                            for a in d1]))


def test_batched_hamming_rejects_mismatched_streams():
    import torch

    d = torch.zeros((2, 4, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        cuda_hamming.hamming_distance_matrix_cuda(d, torch.zeros((3, 4, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        cuda_hamming.hamming_distance_matrix_cuda(d, d[0])
