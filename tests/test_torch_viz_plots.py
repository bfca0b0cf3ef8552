"""``plslam_tpu_torch.viz`` against ``plslam_tpu.viz``: one JAX map state
(the JAX package's ring map, ``__graft_entry__._build_ring_map``, saved in
its checkpoint layout) goes into the JAX mapper and, through
``convert.map_state_from_numpy``, into a port ``PLSLAM``; one feature set
built in numpy goes to both packages' ``StereoFeatures``.  Every figure of
``render_run`` and ``plot_frame`` decodes to the same pixels, exactly, and
the scene HTML is the same text.  matplotlib loads only when a figure is
drawn."""

import os
import subprocess
import sys
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("matplotlib")

import __graft_entry__ as G  # noqa: E402
from plslam_tpu import viz as JV  # noqa: E402
from plslam_tpu.frontend import features as JF  # noqa: E402
from plslam_tpu.io.checkpoint import save_map  # noqa: E402
from plslam_tpu_torch import viz as TV  # noqa: E402
from plslam_tpu_torch.config import PLSLAMConfig  # noqa: E402
from plslam_tpu_torch.convert import map_state_from_numpy, stereo_features_from_numpy  # noqa: E402
from plslam_tpu_torch.core.camera import StereoCamera  # noqa: E402
from plslam_tpu_torch.pipeline import PLSLAM  # noqa: E402
from test_torch_helpers import one_torch_thread  # noqa: E402, F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pixels(path):
    import matplotlib.pyplot as plt

    return plt.imread(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("viz")
    jmapper, (T_true, _) = G._build_ring_map(rng_seed=3, n_kf=12, n_pts=600, n_ls=64,
                                             pose_noise=0.01, lm_noise=0.03)
    ckpt = str(d / "map.npz")
    save_map(ckpt, jmapper)
    cam = StereoCamera.create(458.0, 457.0, 376.0, 240.0, 0.11, width=752, height=480)
    slam = PLSLAM(cam, PLSLAMConfig(multithread_slam=False), device="cpu")
    with np.load(ckpt) as z:
        map_state_from_numpy(z, slam.mapper)
    jslam = SimpleNamespace(mapper=jmapper, keyframe_trajectory=jmapper.keyframe_trajectory)
    return slam, jslam, T_true, d


def test_render_run_same_pixels(runs):
    slam, jslam, T_true, d = runs
    got = TV.render_run(slam, str(d / "port"), gt=T_true)
    want = JV.render_run(jslam, str(d / "jax"), gt=T_true)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want] == [
        "trajectory.png", "map.png", "covisibility.png", "scene.html"]
    for g, w in zip(got[:3], want[:3]):
        a, b = _pixels(g), _pixels(w)
        assert a.shape == b.shape and a.shape[0] > 300
        np.testing.assert_array_equal(a, b, err_msg=os.path.basename(g))
    with open(got[3]) as f, open(want[3]) as h:
        assert f.read() == h.read()
    assert len(slam.mapper.map.keyframes) == 12 and int(slam.mapper.map.ls_valid.sum()) > 10


def _features(rng, n=200, m=40, width=376, height=240):
    f32 = np.float32
    pts = dict(uv=np.stack([rng.uniform(0, width, n), rng.uniform(0, height, n)], -1).astype(f32),
               disp=rng.uniform(1, 30, n).astype(f32), P=rng.normal(size=(n, 3)).astype(f32),
               desc=rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32),
               sigma2=np.ones(n, f32), valid=rng.random(n) < 0.7)
    sp = np.stack([rng.uniform(0, width, m), rng.uniform(0, height, m)], -1).astype(f32)
    ls = dict(sp=sp, ep=(sp + rng.normal(0, 30, (m, 2))).astype(f32),
              sdisp=np.ones(m, f32), edisp=np.ones(m, f32), sP=np.zeros((m, 3), f32),
              eP=np.zeros((m, 3), f32), le=np.zeros((m, 3), f32), angle=np.zeros(m, f32),
              NDc=np.zeros((m, 6), f32),
              desc=rng.integers(0, 2**32, (m, 8), dtype=np.uint64).astype(np.uint32),
              sigma2=np.ones(m, f32), valid=rng.random(m) < 0.6)
    return {"points": pts, "lines": ls}


def test_plot_frame_same_pixels(tmp_path):
    rng = np.random.default_rng(4)
    feats = _features(rng)
    img = rng.uniform(0, 255, (240, 376)).astype(np.float32)
    jfeats = JF.StereoFeatures(
        points=JF.PointSet(**{k: jnp.asarray(v) for k, v in feats["points"].items()}),
        lines=JF.LineSet(**{k: jnp.asarray(v) for k, v in feats["lines"].items()}))
    got = TV.plot_frame(torch.from_numpy(img), stereo_features_from_numpy(feats, "cpu"),
                        str(tmp_path / "port.png"))
    want = JV.plot_frame(img, jfeats, str(tmp_path / "jax.png"))
    np.testing.assert_array_equal(_pixels(got), _pixels(want))
    # a numpy image gives the same figure
    again = TV.plot_frame(img, stereo_features_from_numpy(feats, "cpu"),
                          str(tmp_path / "port_np.png"))
    np.testing.assert_array_equal(_pixels(again), _pixels(want))


def test_matplotlib_loads_only_to_draw():
    code = ("import sys, plslam_tpu_torch.viz as v; "
            "print(any(m.split('.')[0] == 'matplotlib' for m in sys.modules))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True,
                         capture_output=True, text=True, timeout=120).stdout.strip()
    assert out == "False"
