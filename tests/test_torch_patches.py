"""Patch gather and in-patch sampling: the port's plain versions against
the Pallas gather (interpret mode) and the one-hot extraction, bit-exact."""

import jax.numpy as jnp
import numpy as np

from plslam_tpu.ops import patches as jpatches
from plslam_tpu.ops.pallas_patches import gather_patches_batch as pallas_gather
from plslam_tpu_torch.ops import cuda_patches, patches

from test_torch_helpers import t, to_np


def test_plain_gather_matches_pallas_interpret():
    rng = np.random.default_rng(0)
    B, H, W, N, P = 2, 120, 188, 37, 48
    img = rng.uniform(0, 255, (B, H, W)).astype(np.float32)
    # corners from fully outside (negative) to fully outside (past the edge)
    y0 = rng.integers(-P - 5, H + 5, size=(B, N)).astype(np.int32)
    x0 = rng.integers(-P - 5, W + 5, size=(B, N)).astype(np.int32)
    y0[:, :4] = [-P, -P + 1, H - 1, H]
    want = np.asarray(pallas_gather(jnp.asarray(img), jnp.asarray(np.clip(y0, -P, H)),
                                    jnp.asarray(np.clip(x0, -P, W)), patch=P,
                                    interpret=True))
    got = to_np(cuda_patches.gather_patches_batch(t(img), t(y0), t(x0), P))
    np.testing.assert_array_equal(got, want)


def test_extract_patches_matches_onehot():
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, (90, 130)).astype(np.float32)
    xy = rng.uniform(-10, 140, (50, 2)).astype(np.float32)
    xy[:6] = [[10.5, 20.5], [11.5, 21.5], [0.0, 0.0], [129.4, 89.6], [-0.5, 3.5], [64, 45]]
    for P, off in ((48, 23.0), (16, None), (31, None)):
        want = np.asarray(jpatches.extract_patches(jnp.asarray(img), jnp.asarray(xy), P,
                                                   center_offset=off))
        got = to_np(patches.extract_patches(t(img), t(xy), P, center_offset=off))
        np.testing.assert_array_equal(got, want)


def test_sample_in_patches_exact():
    rng = np.random.default_rng(2)
    pt = rng.uniform(-50, 50, (12, 48, 48)).astype(np.float32)
    uv = rng.uniform(-3, 51, (12, 300, 2)).astype(np.float32)
    uv[0, :4] = [[-0.5, 0.0], [47.49, 47.5], [23.5, 22.5], [-0.51, 10]]
    want = np.asarray(jpatches.sample_in_patches(jnp.asarray(pt), jnp.asarray(uv)))
    got = to_np(patches.sample_in_patches(t(pt), t(uv)))
    np.testing.assert_array_equal(got, want)
