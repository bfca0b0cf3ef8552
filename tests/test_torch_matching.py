"""Matching: masks and MatchResult exactly equal to plslam_tpu.ops.matching;
stereo PointSet/LineSet, fed the JAX detector outputs, with valid masks
exact and floats to 1e-4 relative (of each array's largest magnitude)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from plslam_tpu.frontend import frame as jframe
from plslam_tpu.io.synthetic import SyntheticScene
from plslam_tpu.ops import matching as jM
from plslam_tpu_torch.frontend import frame
from plslam_tpu_torch.ops import fast, lines
from plslam_tpu_torch.ops import matching as M

from test_torch_helpers import cams, t, to_np, words


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * max(float(np.abs(want).max()), 1e-30))


def _segments(rng, n):
    sp = rng.uniform(0, 300, (n, 2)).astype(np.float32)
    ep = (sp + rng.uniform(-80, 80, (n, 2))).astype(np.float32)
    return sp, ep


def test_pair_masks_exact():
    rng = np.random.default_rng(0)
    xy1 = np.round(rng.uniform(0, 300, (150, 2)), 1).astype(np.float32)
    xy2 = np.round(rng.uniform(0, 300, (170, 2)), 1).astype(np.float32)
    v1, v2 = rng.uniform(size=150) > 0.2, rng.uniform(size=170) > 0.2
    np.testing.assert_array_equal(
        to_np(M.stereo_point_pair_mask(t(xy1), t(xy2), t(v1), t(v2), 120.0, 10.0)),
        np.asarray(jM.stereo_point_pair_mask(xy1, xy2, v1, v2, 120.0, 10.0)))
    np.testing.assert_array_equal(
        to_np(M.window_pair_mask(t(xy1), t(xy2), t(v1), t(v2), 40.0, 25.0)),
        np.asarray(jM.window_pair_mask(xy1, xy2, v1, v2, 40.0, 25.0)))
    sp1, ep1 = _segments(rng, 150)
    sp2, ep2 = _segments(rng, 170)
    np.testing.assert_array_equal(
        to_np(M.line_pair_mask(t(sp1), t(ep1), t(sp2), t(ep2), t(v1), t(v2), 60.0, 0.75)),
        np.asarray(jM.line_pair_mask(sp1, ep1, sp2, ep2, v1, v2, 60.0, 0.75)))


@pytest.mark.parametrize("mutual", [True, False])
def test_match_descriptors_exact(mutual):
    rng = np.random.default_rng(1)
    # few distinct words: many distance ties, so argmin order matters
    base = rng.integers(0, 2**32, (6, 8), dtype=np.uint64).astype(np.uint32)
    d1 = base[rng.integers(0, 6, 200)] ^ (1 << rng.integers(0, 32, (200, 8))).astype(np.uint32)
    d2 = base[rng.integers(0, 6, 180)] ^ (1 << rng.integers(0, 32, (180, 8))).astype(np.uint32)
    mask = rng.uniform(size=(200, 180)) > 0.3
    want = jM.match_descriptors(jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(mask),
                                0.9, mutual=mutual)
    got = M.match_descriptors(t(d1), t(d2), t(mask), 0.9, mutual=mutual)
    assert (np.asarray(want.idx) >= 0).sum() > 5
    np.testing.assert_array_equal(to_np(got.idx), np.asarray(want.idx))
    np.testing.assert_array_equal(to_np(got.dist), np.asarray(want.dist))


def test_line_twoway_gate_exact():
    rng = np.random.default_rng(2)
    sp1, ep1 = _segments(rng, 64)
    sp2 = (sp1 + rng.normal(0, 20, (64, 2))).astype(np.float32)
    ep2 = (ep1 + rng.normal(0, 20, (64, 2))).astype(np.float32)
    idx = rng.integers(-1, 64, 64).astype(np.int32)
    np.testing.assert_array_equal(
        to_np(M.line_twoway_gate(t(sp1), t(ep1), t(sp2), t(ep2), t(idx), 25.0)),
        np.asarray(jM.line_twoway_gate(sp1, ep1, sp2, ep2, idx, 25.0)))


@pytest.fixture(scope="module")
def detections():
    """JAX detector outputs on one 376x240 stereo pair of the synthetic scene."""
    scene = SyntheticScene(n_points=300, n_lines=40, seed=2)
    imgs = jnp.asarray(np.stack(scene.render_stereo(np.eye(4))))
    fcfg = jframe.FrontendConfig(n_points=256, n_lines=64, fast_th=15.0)
    det_pts, det_ls = jframe.make_batched_detectors(fcfg)
    kp, pdesc = det_pts(imgs, jnp.asarray(15.0, jnp.float32))
    seg, ldesc = det_ls(imgs)
    jcam, tcam = cams(scene.fx, scene.fy, scene.cx, scene.cy, scene.b,
                      scene.width, scene.height)
    return fcfg, jcam, tcam, (kp, pdesc), (seg, ldesc)


def _side(tree, i):
    return jax.tree.map(lambda x: np.asarray(x[i]), tree)


def test_stereo_points_from_jax_detections(detections):
    fcfg, jcam, tcam, (kp, pdesc), _ = detections
    want = jax.jit(lambda a, b, c, d: jframe._match_stereo_points(a, b, c, d, jcam, fcfg))(
        _side(kp, 0), pdesc[0], _side(kp, 1), pdesc[1])
    tkp = [fast.Keypoints(*(t(x) for x in _side(kp, i))) for i in (0, 1)]
    tfcfg = frame.FrontendConfig(n_points=256, n_lines=64, fast_th=15.0)
    got = frame._match_stereo_points(tkp[0], t(pdesc[0]), tkp[1], t(pdesc[1]), tcam, tfcfg)
    assert np.asarray(want.valid).sum() > 40
    np.testing.assert_array_equal(to_np(got.valid), np.asarray(want.valid))
    np.testing.assert_array_equal(to_np(got.desc), words(np.asarray(want.desc)))
    for name in ("uv", "disp", "P", "sigma2"):
        _close(to_np(getattr(got, name)), getattr(want, name))


def test_stereo_lines_from_jax_detections(detections):
    fcfg, jcam, tcam, _, (seg, ldesc) = detections
    want = jax.jit(lambda a, b, c, d: jframe._match_stereo_lines(a, b, c, d, jcam, fcfg))(
        _side(seg, 0), ldesc[0], _side(seg, 1), ldesc[1])
    tseg = [lines.Segments(*(t(x) for x in _side(seg, i))) for i in (0, 1)]
    tfcfg = frame.FrontendConfig(n_points=256, n_lines=64, fast_th=15.0)
    got = frame._match_stereo_lines(tseg[0], t(ldesc[0]), tseg[1], t(ldesc[1]), tcam, tfcfg)
    assert np.asarray(want.valid).sum() > 5
    np.testing.assert_array_equal(to_np(got.valid), np.asarray(want.valid))
    np.testing.assert_array_equal(to_np(got.desc), words(np.asarray(want.desc)))
    for name in ("sp", "ep", "sdisp", "edisp", "sP", "eP", "le", "angle", "NDc", "sigma2"):
        _close(to_np(getattr(got, name)), getattr(want, name))
