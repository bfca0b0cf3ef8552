"""FAST-9 score + NMS and the multi-level detector: the port's plain
versions against plslam_tpu.ops.fast (bit-exact everywhere: both wrap with
roll) and against the Pallas kernel in interpret mode (bit-exact off the
3-px frame for raw and the 4-px frame for nms, where the kernel zero-pads)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from plslam_tpu.io.synthetic import SyntheticScene
from plslam_tpu.ops import fast as jfast
from plslam_tpu.ops import image as jimage
from plslam_tpu.ops.pallas_fast import fast_score_nms_batch as pallas_fast
from plslam_tpu_torch.ops import cuda_fast, fast

from test_torch_helpers import t, to_np


def _stack(H, W, seed):
    rng = np.random.default_rng(seed)
    noise = rng.uniform(0, 255, (H, W)).astype(np.float32)
    scene = SyntheticScene(n_points=150, n_lines=20, seed=seed, width=W, height=H,
                           fx=0.58 * W, fy=0.58 * W, cx=W / 2, cy=H / 2)
    return np.stack([noise, scene.render_stereo(np.eye(4))[0]])


@pytest.mark.parametrize("H,W,th", [(120, 188, 20.0), (83, 131, 7.5)])
def test_score_nms_match_jax(H, W, th):
    imgs = _stack(H, W, seed=H)
    raw, nms = cuda_fast.fast_score_nms_batch(t(imgs), t(np.full(2, th, np.float32)))
    raw, nms = to_np(raw), to_np(nms)
    raw_j = jax.vmap(lambda im: jfast.fast_score_map(im, th))(jnp.asarray(imgs))
    nms_j = jax.vmap(jfast.nms3x3)(raw_j)
    np.testing.assert_array_equal(raw, np.asarray(raw_j))
    np.testing.assert_array_equal(nms, np.asarray(nms_j))

    raw_p, nms_p = pallas_fast(jnp.asarray(imgs), jnp.asarray([th, th], jnp.float32),
                               interpret=True)
    np.testing.assert_array_equal(raw[:, 3:-3, 3:-3], np.asarray(raw_p)[:, 3:-3, 3:-3])
    np.testing.assert_array_equal(nms[:, 4:-4, 4:-4], np.asarray(nms_p)[:, 4:-4, 4:-4])


def test_per_image_threshold():
    imgs = _stack(64, 96, seed=5)
    thr = np.asarray([5.0, 40.0], np.float32)
    raw, _ = cuda_fast.fast_score_nms_batch(t(imgs), t(thr))
    for b in range(2):
        np.testing.assert_array_equal(
            to_np(raw[b]), np.asarray(jfast.fast_score_map(jnp.asarray(imgs[b]), thr[b])))


def test_detect_pyramid_batch_same_keypoints():
    """Fed the JAX pyramid levels, the port keeps the same corners."""
    imgs = _stack(240, 376, seed=11)
    levels = jax.vmap(lambda im: tuple(jimage.build_pyramid(im, 4, 1.2)))(jnp.asarray(imgs))
    th = np.float32(12.0)
    want = jfast.detect_pyramid_batch(list(levels), jnp.asarray(th), 512, 19, 1.2)
    got = fast.detect_pyramid_batch([t(lv) for lv in levels], t(th), 512, 19, 1.2)
    assert int(np.asarray(want.valid).sum()) > 100
    np.testing.assert_array_equal(to_np(got.valid), np.asarray(want.valid))
    np.testing.assert_array_equal(to_np(got.level), np.asarray(want.level))
    np.testing.assert_array_equal(to_np(got.score), np.asarray(want.score))
    np.testing.assert_array_equal(to_np(got.xy), np.asarray(want.xy))
