"""``plslam_tpu_torch.line_match_quality`` against
``scripts/line_match_quality.py``: the ground-truth association and the
three candidate masks are equal on the same segments, the single-image
line detector equals the batched one, and the harness's counts at 2
scenes x 2 view pairs stay within the bar below.

The bar: both packages run their own line detector and LBD on the same
rendered images, so a few segments' endpoints differ by more than a pixel
(tests/test_torch_detect_fullwidth.py; ROADMAP queue 3) and move a match
or a ground-truth association.  Reading at this size, all eight rows on
this CPU: matches within 3 of JAX's, correct within 1, the wrong rate
within 0.7 percentage points, ground-truth-visible detections within 1
(baseline 123 / 114 both; long lines + twoway 206 / 193 against 204 /
192).  Held: matches and correct within 4% (at least 3), the wrong rate
within 2 percentage points."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam_tpu_torch import line_match_quality as Q
from plslam_tpu_torch.frontend import frame as F
from plslam_tpu_torch.io.synthetic import SyntheticScene, circular_trajectory
from test_torch_helpers import load_script, one_torch_thread  # noqa: F401

J = load_script("line_match_quality")


def _segments(rng, n, width=376, height=240):
    sp = np.stack([rng.uniform(0, width, n), rng.uniform(0, height, n)], -1)
    ang = rng.uniform(0, np.pi, n)
    ep = sp + rng.uniform(5, 150, n)[:, None] * np.stack([np.cos(ang), np.sin(ang)], -1)
    return sp.astype(np.float32), ep.astype(np.float32), rng.random(n) < 0.9


def test_gt_assoc_equal():
    rng = np.random.default_rng(0)
    scene = SyntheticScene(n_points=250, n_lines=48, seed=1)
    T = circular_trajectory(3, step_t=0.07, step_r=0.012)[2]
    # the scene's own projected segments, jittered, and random ones
    T_c_w = np.linalg.inv(T)
    ua, va, _ = scene.project(T_c_w, scene.LA)
    ub, vb, _ = scene.project(T_c_w, scene.LB)
    sp, ep, valid = _segments(rng, 64)
    sp = np.concatenate([np.stack([ua, va], -1) + rng.normal(0, 1.5, (48, 2)), sp])
    ep = np.concatenate([np.stack([ub, vb], -1) + rng.normal(0, 1.5, (48, 2)), ep])
    valid = np.concatenate([np.ones(48, bool), valid])
    got = Q._gt_assoc(scene, T, sp, ep, valid)
    np.testing.assert_array_equal(got, J._gt_assoc(scene, T, sp, ep, valid))
    assert (got[:48] >= 0).sum() > 20


@pytest.mark.parametrize("mode", ["full", "oneside", "midpoint"])
def test_masks_equal(mode):
    rng = np.random.default_rng(1)
    a, b = _segments(rng, 96), _segments(rng, 80)
    cfg = F.FrontendConfig()
    ja, jb = (SimpleNamespace(sp=jnp.asarray(s), ep=jnp.asarray(e), valid=jnp.asarray(v))
              for s, e, v in (a, b))
    ta, tb = (SimpleNamespace(sp=torch.from_numpy(s), ep=torch.from_numpy(e),
                              valid=torch.from_numpy(v)) for s, e, v in (a, b))
    got = Q._make_mask(mode, cfg, ta, tb).numpy()
    want = np.asarray(J._make_mask(mode, cfg, ja, jb))
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < got.size


def test_left_view_is_the_stereo_render_left():
    """Consecutive views equal render_stereo's left images, so the noise
    stream runs as in the script's serial stereo render."""
    a, b = (SyntheticScene(n_points=250, n_lines=48, seed=4) for _ in range(2))
    for T in circular_trajectory(3, step_t=0.07, step_r=0.012):
        np.testing.assert_array_equal(Q._left_view(a, T, 1.5),
                                      b.render_stereo(T, noise=1.5)[0])


def test_single_image_detector_is_the_batched_one():
    scene = SyntheticScene(n_points=250, n_lines=48, seed=2)
    il, ir = scene.render_stereo(np.eye(4), noise=1.5)
    cfg = F.FrontendConfig()
    seg_b, desc_b = F._detect_describe_lines_batch(torch.from_numpy(np.stack([il, ir])), cfg)
    for i, img in enumerate((il, ir)):
        seg, desc = F._detect_describe_lines(torch.from_numpy(img), cfg)
        for name, x in seg._asdict().items():
            assert torch.equal(x, getattr(seg_b, name)[i]), name
        assert torch.equal(desc, desc_b[i])
        assert int(seg.valid.sum()) > 10


@pytest.mark.parametrize("label", ["baseline (full-segment)", "PRODUCTION (+twoway 25px)",
                                   "long-lines +twoway 25px"])
def test_run_counts_against_jax(label, capsys):
    kw = dict(Q.CONFIGS)[label]
    got = Q.run(F.FrontendConfig(), n_scenes=2, n_steps=2, label=label, device="cpu", **kw)
    want_m, want_ok = J.run(J.FrontendConfig(), n_scenes=2, n_steps=2, label=label, **kw)
    rows = capsys.readouterr().out.splitlines()
    # the same printed row, field for field but the numbers
    assert rows[0].split("=")[0] == rows[1].split("=")[0]
    for g, w in ((got["matches"], want_m), (got["correct"], want_ok)):
        assert abs(g - w) <= max(3, 0.04 * w), (got, want_m, want_ok)
    rate = lambda m, ok: (m - ok) / max(m, 1)  # noqa: E731
    assert abs(rate(got["matches"], got["correct"]) - rate(want_m, want_ok)) <= 0.02
    assert got["matches"] > 50


def test_configs_are_the_harness_rows():
    """The eight labelled runs of the script's __main__, in order."""
    import inspect

    src = inspect.getsource(J).split('if __name__ == "__main__":')[1]
    assert [label for label, _ in Q.CONFIGS] == [
        ln.split('label="')[1].split('"')[0] for ln in src.splitlines() if 'label="' in ln]
