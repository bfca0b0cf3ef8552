"""Helpers shared by the ``test_torch_*`` parity tests: numpy inputs made
from a seed go to the JAX function and to its ``plslam_tpu_torch``
counterpart, and outputs come back as numpy."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

SMALL_SCENE = dict(n_points=80, n_lines=12, seed=0, width=188, height=120,
                   fx=100.0, fy=100.0, cx=94.0, cy=60.0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for a module's tests: the suite runs several
    worker processes, and the mapping tests run two threads of their own,
    so torch's per-process pool oversubscribes the cores (measured: the
    threaded pipeline run went from 12 s alone to 260 s under 6 workers).
    Import it into a test module to use it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_np(tree):
    """JAX or torch pytree (NamedTuples, tuples) -> same structure of numpy;
    torch int32 descriptor words stay int32, JAX uint32 stay uint32."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_np(x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_np(x) for x in tree)
    return np.asarray(tree)


def words(a: np.ndarray) -> np.ndarray:
    """Descriptor words of either side as int32 bit patterns."""
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def t(a, dtype=None) -> torch.Tensor:
    """numpy (or JAX) array -> CPU tensor; uint32 words -> int32 view."""
    a = words(np.asarray(a))
    x = torch.from_numpy(np.array(a, copy=True, order="C"))
    return x if dtype is None else x.to(dtype)


def cams(fx=435.2, fy=435.2, cx=367.4, cy=252.2, b=0.110074, width=752, height=480):
    """(JAX f32 camera, port camera) with the same intrinsics."""
    from plslam_tpu.core.camera import StereoCamera as JCam
    from plslam_tpu_torch.core.camera import StereoCamera as TCam

    return (JCam.create(fx, fy, cx, cy, b, width, height, dtype=jnp.float32),
            TCam.create(fx, fy, cx, cy, b, width, height))


def load_script(name: str, argv=()):
    """Import ``scripts/<name>.py`` of the JAX package's repository as a
    module, with ``argv`` as its command line while it loads (a script may
    read it at import)."""
    import importlib.util
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(f"_script_{name}",
                                                  os.path.join(root, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    saved, sys.argv = sys.argv, [spec.origin, *argv]
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.argv = saved
    return mod


# -- the static-buffer trackers (tests/test_torch_graphs*.py) -----------------


def port_cam(scene):
    """The port's camera of a synthetic scene."""
    from plslam_tpu_torch.core.camera import StereoCamera

    return StereoCamera.create(scene.fx, scene.fy, scene.cx, scene.cy, scene.b,
                               width=scene.width, height=scene.height)


def tt(x):
    """numpy -> CPU tensor (no copy)."""
    return torch.from_numpy(np.ascontiguousarray(x))


def mark_keyframe_fn(state):
    """The functional ``mark_keyframe`` (the JAX package's)."""
    return state._replace(T_prevKF=state.T_f_w,
                          cov_prevKF_accum=torch.zeros_like(state.cov_prevKF_accum),
                          frames_since_kf=torch.zeros_like(state.frames_since_kf),
                          prev_was_kf=torch.ones_like(state.prev_was_kf))


def bits_equal(a, b):
    """Two tensors with the same bits (a NaN equals the same NaN)."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def results_equal(a, b):
    """Two NamedTuples of tensors bit for bit, field by field."""
    return all(bits_equal(x, y) for x, y in zip(a, b))


def tree_equal(a, b):
    """Two nested NamedTuples of tensors bit for bit."""
    if isinstance(a, torch.Tensor):
        return bits_equal(a, b)
    return all(tree_equal(x, y) for x, y in zip(a, b))


def ate_within_jax(got, want, poses):
    """test_torch_vo.py's bar: the port's unaligned ATE over the frames
    under max(2x JAX's, 0.01 m)."""
    from plslam_tpu_torch.io import ate_rmse

    gt = np.stack([p[:3, 3] for p in poses])
    ate_t = ate_rmse(np.stack([to_np(T)[..., :3, 3] for T in got]).reshape(-1, 3),
                     gt, align=False)
    ate_j = ate_rmse(np.stack([np.asarray(T)[..., :3, 3] for T in want]).reshape(-1, 3),
                     gt, align=False)
    assert ate_t <= max(2.0 * ate_j, 0.01), (ate_t, ate_j)


# -- chip_smoke.py's phase rehearsals (tests/test_torch_chip_smoke*.py) --------


def load_chip_smoke():
    """chip_smoke.py, at the repository's root, loaded as a module."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# phase 11 at CPU sizes: the dry run's programs cut small, 2 streams at
# 376x240 and one frame after initialize
SMALL_DIST = dict(ba=dict(K=8, P=256, L=32, obs_k=4), iters=2, q=160, masked=0.05, pgo_k=32,
                  pgo_iters=5, ring=dict(rng_seed=3, n_kf=16, n_pts=800, n_ls=80, pose_noise=0.01,
                                         lm_noise=0.03),
                  b=2, frames=1, widths=dict(n_points=512, n_lines=128),
                  scene=dict(n_points=300, n_lines=40, width=376, height=240, fx=217.6,
                             fy=217.6, cx=183.7, cy=126.1))


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def json_literals(path: str) -> list[dict]:
    """The dict literals with string keys in a program's source text (the
    JSON objects it prints): per literal its keys in order (None for a
    ``**`` splat), its ``"metric"`` value as a regular expression (an
    f-string's fields match any text; None without a metric) and the
    subscript it is assigned to (``results["mesh8"] = {...}``; else None)."""
    import ast
    import re

    with open(path) as f:
        tree = ast.parse(f.read())
    targets = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and isinstance(node.targets[0], ast.Subscript)
                and isinstance(node.targets[0].slice, ast.Constant)):
            targets[id(node.value)] = node.targets[0].slice.value
    out = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Dict) and node.keys and all(
                k is None or (isinstance(k, ast.Constant) and isinstance(k.value, str))
                for k in node.keys)):
            continue
        keys = [None if k is None else k.value for k in node.keys]
        metric = None
        if "metric" in keys:
            v = node.values[keys.index("metric")]
            if isinstance(v, ast.Constant):
                metric = re.escape(v.value)
            elif isinstance(v, ast.JoinedStr):
                metric = "".join(re.escape(p.value) if isinstance(p, ast.Constant) else ".+"
                                 for p in v.values)
        out.append({"keys": keys, "metric": metric, "target": targets.get(id(node))})
    return out


def assert_printed_like(line: dict, literals: list[dict]) -> None:
    """``line`` carries exactly the keys, in order, of one of ``literals``
    (``json_literals``) and a metric name its metric pattern matches."""
    import re

    for lit in literals:
        if lit["keys"] == list(line) and (lit["metric"] is None
                                          or re.fullmatch(lit["metric"], line["metric"])):
            return
    raise AssertionError(f"no JSON object of the JAX program has the keys and metric of {line}")
