"""State carried across from the JAX package, as numpy arrays.

There are no learned weights.  What crosses over is the camera, the
feature sets (with or without a leading stream axis), the tracking state
(``VOState``, single or batched), BA problems and the whole SLAM map with
the loop closer's state (``map_state_from_numpy``, the checkpoint layout);
the descriptor tables are re-derived by the same numpy code in
``ops/orb.py``, ``ops/lbd.py`` and ``ops/image.py``.  Inputs are numpy
arrays, dicts of them, or NamedTuples of them (e.g.
``jax.tree.map(np.asarray, state)`` on the JAX side); this module never
imports jax.  uint32 descriptor words become int32 by a bit-preserving
view, keeping the LSB-first bit order.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .backend.ba import BAProblem
from .core.camera import StereoCamera
from .frontend.features import LineSet, PointSet, StereoFeatures
from .vo import VOState


def _fields(obj) -> dict:
    if isinstance(obj, Mapping):
        return dict(obj)
    if hasattr(obj, "_asdict"):
        return obj._asdict()
    raise TypeError(f"expected a mapping or NamedTuple, got {type(obj).__name__}")


def tensor_from_numpy(a, device) -> torch.Tensor:
    """numpy -> tensor on ``device``; uint32 words are viewed as int32."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a, copy=True, order="C")).to(device)


def camera_from_numpy(cam) -> StereoCamera:
    """``StereoCamera`` from fx, fy, cx, cy, b (scalars or 0-d arrays),
    width and height."""
    f = _fields(cam)
    return StereoCamera.create(*(float(np.asarray(f[k])) for k in
                                 ("fx", "fy", "cx", "cy", "b")),
                               width=int(f.get("width", 752)),
                               height=int(f.get("height", 480)))


def _named(cls, obj, device):
    f = _fields(obj)
    return cls(**{k: tensor_from_numpy(f[k], device) for k in cls._fields})


def stereo_features_from_numpy(feats, device) -> StereoFeatures:
    """``StereoFeatures`` from {"points": {...}, "lines": {...}}."""
    f = _fields(feats)
    return StereoFeatures(points=_named(PointSet, f["points"], device),
                          lines=_named(LineSet, f["lines"], device))


def vo_state_from_numpy(state, device) -> VOState:
    """``VOState`` with every field on ``device``; fast_th as f32."""
    f = _fields(state)
    out = {k: tensor_from_numpy(f[k], device) for k in VOState._fields
           if k != "features"}
    out["fast_th"] = out["fast_th"].to(torch.float32)
    return VOState(features=stereo_features_from_numpy(f["features"], device), **out)


def batch_vo_state_from_numpy(state, device) -> VOState:
    """A ``BatchedVisualOdometry`` state (every field (B,)-leading, the
    JAX package's ``BatchedVisualOdometry.state`` as numpy) on ``device``;
    raises when the fields disagree on B."""
    out = vo_state_from_numpy(state, device)
    sizes = {x.shape[0] if x.dim() else None
             for x in (*out.features.points, *out.features.lines, *out[1:])}
    if len(sizes) != 1 or None in sizes:
        raise ValueError(f"batched VO state: fields disagree on the stream axis: {sizes}")
    return out


def stereo_features_to_numpy(feats: StereoFeatures) -> dict:
    """``StereoFeatures`` -> {"points": {...}, "lines": {...}} of numpy, the
    descriptor words as uint32 (the JAX package's layout)."""
    def side(x):
        out = {k: v.detach().cpu().numpy() for k, v in x._asdict().items()}
        out["desc"] = out["desc"].view(np.uint32)
        return out
    return {"points": side(feats.points), "lines": side(feats.lines)}


def ba_problem_from_numpy(prob, device) -> BAProblem:
    """``BAProblem`` on ``device`` from a mapping or NamedTuple of numpy
    arrays (absent endpoint fields may be None); index fields become int64."""
    f = _fields(prob)
    out = {}
    for k in BAProblem._fields:
        v = f.get(k)
        if v is not None:
            v = np.asarray(v)
            v = tensor_from_numpy(v.astype(np.int64) if v.dtype.kind in "iu" else v,
                                  device)
        out[k] = v
    return BAProblem(**out)


def map_state_from_numpy(state, mapper, loop_closer=None):
    """Restore a map saved by either package (an ``np.load`` npz, or the
    dict of numpy arrays of ``plslam_tpu.io.checkpoint.save_map``'s layout)
    into the port's ``MapHandler`` and ``LoopCloser``, in place."""
    from .io.checkpoint import restore_map_state

    return restore_map_state(state, mapper, loop_closer)
