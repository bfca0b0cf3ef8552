"""The port's own copies of the JAX package's numpy-only modules against the
originals: the synthetic renderer, the trajectory helpers and the
``PLSLAMConfig`` dataclass give the same arrays, values, bytes and fields."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from plslam_tpu import config as jcfg
from plslam_tpu.io import synthetic as jsyn
from plslam_tpu.io import trajectory as jtraj
from plslam_tpu_torch import config as tcfg
from plslam_tpu_torch.io import synthetic as tsyn
from plslam_tpu_torch.io import trajectory as ttraj

CONFIGS = Path(__file__).resolve().parent.parent / "configs"


def _poses():
    return jsyn.circular_trajectory(5, step_t=0.08, step_r=0.02)


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_render_stereo_identical(seed):
    kw = dict(n_points=120, n_lines=15, seed=seed, width=188, height=120,
              fx=108.8, fy=108.8, cx=91.8, cy=63.0)
    a, b = jsyn.SyntheticScene(**kw), tsyn.SyntheticScene(**kw)
    np.testing.assert_array_equal(b.P, a.P)
    np.testing.assert_array_equal(b.LB, a.LB)
    for i, T in enumerate(_poses()[::2]):
        opts = dict(noise=1.0, gain=1.0 + 0.1 * i, bias=2.0 * i, n_occluders=i)
        for got, want in zip(b.render_stereo(T, **opts), a.render_stereo(T, **opts)):
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [{}, dict(step_t=0.05), dict(step_t=0.12, step_r=0.015)])
def test_circular_trajectory_identical(kw):
    for got, want in zip(tsyn.circular_trajectory(9, **kw), jsyn.circular_trajectory(9, **kw),
                         strict=True):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("align,with_scale", [(True, False), (False, False), (True, True)])
def test_ate_rmse_identical(align, with_scale):
    rng = np.random.default_rng(4)
    gt = np.stack([T[:3, 3] for T in jsyn.circular_trajectory(30)])
    R = jtraj.umeyama_alignment(rng.normal(size=(8, 3)), rng.normal(size=(8, 3)))[1]
    est = 1.3 * gt @ R.T + np.array([0.2, -0.1, 0.4]) + rng.normal(0, 0.01, gt.shape)
    got = ttraj.ate_rmse(est, gt, align=align, with_scale=with_scale)
    assert got == jtraj.ate_rmse(est, gt, align=align, with_scale=with_scale)


def test_save_tum_same_bytes(tmp_path):
    poses = _poses()
    # a rotation with a negative trace takes the other quaternion branch
    poses[-1] = poses[-1] @ np.diag([-1.0, -1.0, 1.0, 1.0])
    stamps = [0.05 * i + 1e-7 for i in range(len(poses))]
    ttraj.save_tum(str(tmp_path / "t.txt"), stamps, poses)
    jtraj.save_tum(str(tmp_path / "j.txt"), stamps, poses)
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()


def test_plslam_config_defaults():
    want, got = dataclasses.fields(jcfg.PLSLAMConfig), dataclasses.fields(tcfg.PLSLAMConfig)
    assert [(f.name, f.type, f.default) for f in got] == \
        [(f.name, f.type, f.default) for f in want]
    assert dataclasses.asdict(tcfg.PLSLAMConfig()) == dataclasses.asdict(jcfg.PLSLAMConfig())


@pytest.mark.parametrize("name", sorted(p.name for p in CONFIGS.glob("*.yaml")))
def test_plslam_config_from_yaml(name):
    """The same values as the JAX package's from_yaml, except that a float
    field PyYAML leaves as a string (``1e-7``: YAML 1.1 wants a dot) is the
    float the reference's yaml-cpp reads."""
    got = dataclasses.asdict(tcfg.PLSLAMConfig.from_yaml(str(CONFIGS / name)))
    want = dataclasses.asdict(jcfg.PLSLAMConfig.from_yaml(str(CONFIGS / name)))
    floats = {f.name for f in dataclasses.fields(jcfg.PLSLAMConfig) if isinstance(f.default, float)}
    want = {k: float(v) if k in floats and isinstance(v, str) else v for k, v in want.items()}
    assert got == want
    assert all(isinstance(got[k], float) for k in floats)
