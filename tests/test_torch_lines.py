"""Line-segment detection from the same image: plslam_tpu_torch against
plslam_tpu.ops.lines.  The port's blur and Sobel differ from the JAX
banded matmuls by ~1e-5, and its scatter sums run in another order, so
the test holds the valid count to +-1 and each JAX segment's endpoints to
0.05 px of a port segment (0.035 px at most on
seeds 0-3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from plslam_tpu.io.synthetic import SyntheticScene
from plslam_tpu.ops import lines as jlines
from plslam_tpu_torch.ops import lines

from test_torch_helpers import t, to_np


def _images(seed):
    scene = SyntheticScene(n_points=200, n_lines=40, seed=seed)
    return np.stack(scene.render_stereo(np.eye(4)))


@pytest.mark.parametrize("seed", [0, 1])
def test_detect_segments_matches_jax(seed):
    imgs = _images(seed)
    cfg = dict(max_out=128)
    want = jax.jit(jax.vmap(lambda im: jlines.detect_segments(
        im, jlines.LineDetectorConfig(**cfg))))(jnp.asarray(imgs))
    got = lines.detect_segments(t(imgs), lines.LineDetectorConfig(**cfg))
    for b in range(2):
        wv = np.asarray(want.valid[b])
        gv = to_np(got.valid[b])
        assert wv.sum() > 10
        assert abs(int(wv.sum()) - int(gv.sum())) <= 1, (wv.sum(), gv.sum())
        wseg = np.concatenate([np.asarray(want.sp[b]), np.asarray(want.ep[b])], -1)[wv]
        gseg = np.concatenate([to_np(got.sp[b]), to_np(got.ep[b])], -1)[gv]
        d = np.abs(wseg[:, None, :] - gseg[None, :, :]).max(-1)   # (n_jax, n_port)
        nearest = d.min(1)
        assert (nearest <= 0.05).all(), np.sort(nearest)[-3:]


def test_merge_components_path_graph():
    """Collinear chain of touching cell segments merges into one line."""
    n = 12
    x = np.arange(n, dtype=np.float32) * 10.0
    sp = np.stack([x, np.full(n, 50.0, np.float32)], -1)
    ep = sp + np.asarray([10.0, 0.0], np.float32)
    d = np.tile(np.asarray([[1.0, 0.0]], np.float32), (n, 1))
    mass = np.linspace(5, 1, n).astype(np.float32)
    valid = np.ones(n, bool)
    cfg = jlines.LineDetectorConfig(max_out=4)
    want = jlines._merge_components(jnp.asarray(sp), jnp.asarray(ep), jnp.asarray(d),
                                    jnp.asarray(mass), jnp.asarray(valid), cfg)
    got = lines._merge_components(t(sp)[None], t(ep)[None], t(d)[None], t(mass)[None],
                                  t(valid)[None], lines.LineDetectorConfig(max_out=4))
    np.testing.assert_array_equal(to_np(got.valid[0]), np.asarray(want.valid))
    np.testing.assert_allclose(to_np(got.sp[0]), np.asarray(want.sp), atol=1e-4)
    np.testing.assert_allclose(to_np(got.ep[0]), np.asarray(want.ep), atol=1e-4)
    np.testing.assert_allclose(to_np(got.score[0]), np.asarray(want.score), rtol=1e-6)
