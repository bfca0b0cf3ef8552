"""ORB and LBD descriptor tails from identical patches: >= 99% of the
descriptors bit-identical to plslam_tpu (the centroid moments and band
statistics sum in another order, which can flip a near-tie bit) and ORB
angles to 1e-5 rad."""

import jax
import jax.numpy as jnp
import numpy as np

from plslam_tpu.io.synthetic import SyntheticScene
from plslam_tpu.ops import fast as jfast
from plslam_tpu.ops import image as jimage
from plslam_tpu.ops import lbd as jlbd
from plslam_tpu.ops import orb as jorb
from plslam_tpu.ops.pallas_patches import gather_patches_batch as pallas_gather
from plslam_tpu_torch.ops import lbd, orb

from test_torch_helpers import t, to_np, words

W, H = 376, 240


def _scene_image():
    scene = SyntheticScene(n_points=300, n_lines=40, seed=4)
    return scene.render_stereo(np.eye(4))[0]


def _patches(img, xy):
    """48x48 patches at round(xy) - 23 through the JAX gather (interpret)."""
    c = np.floor(xy + 0.5).astype(np.int32) - 23
    return np.asarray(pallas_gather(jnp.asarray(img[None]), jnp.asarray(c[None, :, 1]),
                                    jnp.asarray(c[None, :, 0]), patch=48,
                                    interpret=True))[0]


def test_orb_from_identical_patches():
    """At the FAST corners of the scene, as on the VO path (in flat regions
    the centroid moments cancel and the angle is ill-conditioned)."""
    raw = _scene_image()
    levels = jimage.build_pyramid(jnp.asarray(raw), 4, 1.2)
    kp = jfast.detect_pyramid(levels, 12.0, 300, 19, 1.2)
    xy = np.asarray(kp.xy, np.float32)
    valid = np.asarray(kp.valid)
    assert valid.sum() > 100
    img = np.asarray(jimage.blur(jnp.asarray(raw), 2.0))
    pt = _patches(img, xy)
    want_d, want_th = jax.jit(jorb._describe_from_patches)(pt, xy, valid)
    got_d, got_th = orb._describe_from_patches(t(pt), t(xy), t(valid))
    same = (words(np.asarray(want_d)) == to_np(got_d)).all(-1)
    assert same.mean() >= 0.99, same.mean()
    dth = np.angle(np.exp(1j * (to_np(got_th) - np.asarray(want_th))))
    np.testing.assert_allclose(dth[valid], 0.0, atol=1e-5)


def test_lbd_from_identical_patches():
    rng = np.random.default_rng(1)
    g = jimage.blur(jnp.asarray(_scene_image()), 1.4)
    gx, gy = (np.asarray(a) for a in jimage.sobel(g))
    K = 64
    sp = np.stack([rng.uniform(10, W - 10, K), rng.uniform(10, H - 10, K)], -1)
    ep = sp + rng.uniform(-60, 60, (K, 2))
    sp, ep = sp.astype(np.float32), ep.astype(np.float32)
    valid = rng.uniform(size=K) > 0.1
    c2 = np.asarray(jlbd._patch_centers(jnp.asarray(sp), jnp.asarray(ep))).reshape(-1, 2)
    px, py = _patches(gx, c2), _patches(gy, c2)
    want = jax.jit(jlbd._describe_from_patches)(px, py, sp, ep, valid)
    got = lbd._describe_from_patches(t(px), t(py), t(sp), t(ep), t(valid))
    same = (words(np.asarray(want)) == to_np(got)).all(-1)
    assert same.mean() >= 0.99, same.mean()


def test_describe_batch_through_gather():
    """describe_batch = blur + gather + tail, on a (2, H, W) stack."""
    rng = np.random.default_rng(2)
    imgs = np.stack([_scene_image(), _scene_image()[:, ::-1].copy()])
    xy = np.stack([rng.uniform(19, W - 19, (2, 100)),
                   rng.uniform(19, H - 19, (2, 100))], -1).astype(np.float32)
    valid = np.ones((2, 100), bool)
    want_d, _ = jax.jit(jax.vmap(jorb.describe))(imgs, xy, valid)
    got_d, _ = orb.describe_batch(t(imgs), t(xy), t(valid))
    same = (words(np.asarray(want_d)) == to_np(got_d)).all(-1)
    assert same.mean() >= 0.97, same.mean()  # blur differs by ~1e-5 besides the tail
