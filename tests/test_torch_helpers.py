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
