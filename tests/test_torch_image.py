"""Blur, Sobel, resize and pyramid: the port's conv2d filters against the
JAX banded matmuls on a 0..255 image, to 1e-3 absolute (f32 sums in a
different order; the JAX side runs at HIGHEST precision)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam_tpu.ops import image as jimage
from plslam_tpu.io.synthetic import SyntheticScene
from plslam_tpu_torch.ops import image

from test_torch_helpers import SMALL_SCENE, t, to_np

ATOL = 1e-3


def _images():
    rng = np.random.default_rng(0)
    noise = rng.uniform(0, 255, (120, 188)).astype(np.float32)
    scene, _ = SyntheticScene(**SMALL_SCENE).render_stereo(np.eye(4))
    return np.stack([noise, scene])


@pytest.mark.parametrize("sigma", [1.0, 1.4, 2.0])
def test_blur(sigma):
    imgs = _images()
    want = np.stack([np.asarray(jimage.blur(jnp.asarray(im), sigma)) for im in imgs])
    np.testing.assert_allclose(to_np(image.blur(t(imgs), sigma)), want, rtol=0, atol=ATOL)


def test_sobel():
    imgs = _images()
    gx, gy = image.sobel(t(imgs))
    for b, im in enumerate(imgs):
        jx, jy = jimage.sobel(jnp.asarray(im))
        np.testing.assert_allclose(to_np(gx[b]), np.asarray(jx), rtol=0, atol=ATOL)
        np.testing.assert_allclose(to_np(gy[b]), np.asarray(jy), rtol=0, atol=ATOL)


def test_pyramid():
    imgs = _images()
    got = image.build_pyramid(t(imgs), 4, 1.2)
    want = jax.vmap(lambda im: tuple(jimage.build_pyramid(im, 4, 1.2)))(jnp.asarray(imgs))
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(to_np(g), np.asarray(w), rtol=0, atol=ATOL)
