"""Detection parity at full width: bench.py's scene (752x480, noise 1.0,
1200 points, 256 line slots), frames 0 and 1 of its trajectory, both images
of each pair through the JAX package's and the port's batched detectors on
the CPU.

Tolerances, from the measurements of this configuration (ROADMAP.md queue
3: FAST keypoints agree to 3e-5 px; 13 of 19,200 ORB descriptors over 8
frames differ by one bit; line endpoints a median 0.006 px apart, with
discrete flips up to 0.443 px and 64 against 66 valid segments on frame 1):
- FAST keypoints: the same valid count, every valid keypoint within 1e-4 px
  of one on the other side;
- ORB descriptors of paired keypoints: >= 99.9% equal, the rest within 1
  bit (the two pyramids and blurs differ in the last bit);
- line segments after the front end's length filter: valid counts within 3;
  segments paired as mutual nearest neighbours (endpoint distance, max
  norm), a median 0.02 px apart per image, and at most 2% of the pairs of
  frames 0-1 beyond 0.5 px (measured on an x86-64 CPU: 1 of 134 on frame
  0, 3 of 139 on frame 1, medians 0.007-0.010 px); a segment valid on one
  side only has no pair.
Neither side's f32 moment fit is changed: the flips are the fit's rounding
at absolute pixel coordinates, the same in both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from plslam_tpu.frontend import frame as jframe
from plslam_tpu.io.synthetic import SyntheticScene, circular_trajectory
from plslam_tpu_torch.frontend import frame as tframe

from test_torch_helpers import one_torch_thread, t, to_np  # noqa: F401

BENCH_SCENE = dict(n_points=600, n_lines=60, seed=0, width=752, height=480,
                   fx=435.2, fy=435.2, cx=367.4, cy=252.2)
WIDTHS = dict(n_points=1200, n_lines=256)


@pytest.fixture(scope="module")
def detections():
    scene = SyntheticScene(**BENCH_SCENE)
    pairs = [np.stack(scene.render_stereo(T, noise=1.0))
             for T in circular_trajectory(2, step_t=0.05)]
    jcfg = jframe.FrontendConfig(**WIDTHS, use_pallas_patches=False)
    tcfg = tframe.FrontendConfig(**WIDTHS)
    # the JAX package's CPU forms: no Pallas patch gather (its batched line
    # describe always takes it), lines per image as make_batched_detectors
    jdet = jax.jit(lambda imgs: (
        jframe._detect_describe_points_batch(imgs, jcfg),
        jax.vmap(lambda im: jframe._detect_describe_lines(im, jcfg))(imgs)))
    out = []
    for pair in pairs:
        want = to_np(jdet(jnp.asarray(pair)))
        got = to_np((tframe._detect_describe_points_batch(t(pair), tcfg),
                     tframe._detect_describe_lines_batch(t(pair), tcfg)))
        out.append((want, got))
    return out


def _pairs(xy_a, xy_b):
    """For each row of a, its nearest row of b and the distance (max norm)."""
    d = np.abs(xy_a[:, None, :] - xy_b[None, :, :]).max(-1)
    return d.argmin(1), d.min(1)


@pytest.mark.parametrize("frame", [0, 1])
def test_fast_and_orb_at_full_width(detections, frame):
    (jkp, jdesc), _ = detections[frame][0]
    (tkp, tdesc), _ = detections[frame][1]
    n_diff_bits = []
    for img in range(2):
        jv, tv = np.asarray(jkp.valid[img]), tkp.valid[img]
        assert jv.sum() == tv.sum() > 500, (jv.sum(), tv.sum())
        j, dist = _pairs(tkp.xy[img][tv], np.asarray(jkp.xy[img])[jv])
        assert dist.max() <= 1e-4, dist.max()
        assert len(np.unique(j)) == len(j)
        a = tdesc[img][tv].view(np.uint32)
        b = np.asarray(jdesc[img])[jv][j]
        n_diff_bits.append(np.unpackbits((a ^ b).view(np.uint8), axis=-1).sum(-1))
    bits = np.concatenate(n_diff_bits)
    assert (bits == 0).mean() >= 0.999, (bits > 0).sum()
    assert bits.max() <= 1


@pytest.mark.parametrize("frame", [0, 1])
def test_lines_at_full_width(detections, frame):
    _line_pairs(detections, frame)


def _line_pairs(detections, frame):
    """Checks one frame's segment counts, pairing and medians; returns the
    paired endpoint distances of both images."""
    _, (jseg, _) = detections[frame][0]
    _, (tseg, _) = detections[frame][1]
    paired = []
    for img in range(2):
        jv, tv = np.asarray(jseg.valid[img]), tseg.valid[img]
        assert jv.sum() > 30
        assert abs(int(jv.sum()) - int(tv.sum())) <= 3, (jv.sum(), tv.sum())
        js = np.concatenate([jseg.sp[img], jseg.ep[img]], -1)[jv]
        ts = np.concatenate([tseg.sp[img], tseg.ep[img]], -1)[tv]
        j, dist = _pairs(ts, js)
        mutual = _pairs(js, ts)[0][j] == np.arange(len(ts))
        dist = dist[mutual]
        assert mutual.sum() >= min(len(ts), len(js)) - 3
        assert np.median(dist) <= 0.02, np.median(dist)
        paired.append(dist)
    return paired


def test_line_flips_over_frames_0_1(detections):
    """Discrete flips (a cell joins another component, an extent moves)
    over every matched segment of frames 0 and 1."""
    dist = np.concatenate([d for frame in (0, 1) for d in _line_pairs(detections, frame)])
    assert (dist > 0.5).mean() <= 0.02, np.sort(dist)[-5:]
