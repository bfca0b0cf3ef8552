"""The port's overlays, scene export and stage timer against the JAX
package's: ``compute_frame_diagnostics`` on the same features and pose (the
association, inlier flags and valid masks equal, pixels to 1e-4, residuals
to 1e-4 + 1e-3 relative: the Pluecker residual's image line has f32
coefficients up to fx*fy ~ 2e5, which round at ~1e-4 relative),
``dump_residuals_jsonl`` records, ``_scene_data`` and the scene HTML
on the same feature-level map (tests/test_viz_scene.py's cases)."""

import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _map_fixtures import World, lateral_poses, make_camera, render_features
from plslam_tpu import viz_frame as jviz
from plslam_tpu import viz_scene as jscene
from plslam_tpu.backend import mapping as jmap
from plslam_tpu.frontend import tracker as jtrk
from plslam_tpu_torch import viz_frame, viz_scene
from plslam_tpu_torch.backend import mapping as tmap
from plslam_tpu_torch.convert import stereo_features_from_numpy
from plslam_tpu_torch.core.camera import StereoCamera
from plslam_tpu_torch.frontend import tracker as ttrk

from test_torch_helpers import one_torch_thread  # noqa: F401

JCAM = make_camera()
TCAM = StereoCamera.create(458.0, 457.0, 376.0, 240.0, 0.11, width=752, height=480)
MAP_KW = dict(ba_points=2048, ba_pobs=8192, ba_lobs=2048)
BOOL_KEYS = ("p_valid", "p_inlier", "l_valid", "l_inlier")


def _noisy_pair(seed: int):
    """Two lateral keyframes of the fixture world; the second frame's
    observations carry 0.4 px noise and ten points are moved by 15 px."""
    world = World(n_pts=120, n_ls=12)
    poses = lateral_poses(2, 0.06)
    prev, curr = (render_features(world, T, JCAM) for T in poses)
    rng = np.random.default_rng(seed)
    uv = np.asarray(curr.points.uv) + rng.normal(0, 0.4, curr.points.uv.shape)
    uv[rng.choice(len(uv), 10, replace=False)] += 15.0
    sp = np.asarray(curr.lines.sp) + rng.normal(0, 0.4, curr.lines.sp.shape)
    ep = np.asarray(curr.lines.ep) + rng.normal(0, 0.4, curr.lines.ep.shape)
    curr = curr._replace(
        points=curr.points._replace(uv=jnp.asarray(uv, jnp.float32)),
        lines=curr.lines._replace(sp=jnp.asarray(sp, jnp.float32),
                                  ep=jnp.asarray(ep, jnp.float32)))
    DT = (np.linalg.inv(poses[1]) @ poses[0]).astype(np.float32)
    DT[:3, 3] += rng.normal(0, 0.002, 3)
    return prev, curr, DT


@pytest.mark.parametrize("plucker", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_frame_diagnostics_match_jax(plucker, seed, tmp_path):
    prev, curr, DT = _noisy_pair(seed)
    want = jviz.compute_frame_diagnostics(prev, curr, DT, JCAM,
                                          jtrk.TrackerConfig(plucker_lines=plucker))
    got = viz_frame.compute_frame_diagnostics(
        stereo_features_from_numpy(prev, "cpu"), stereo_features_from_numpy(curr, "cpu"),
        torch.from_numpy(DT), TCAM, ttrk.TrackerConfig(plucker_lines=plucker))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        if k in BOOL_KEYS:
            assert got[k].dtype == bool
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        elif k.endswith("_res"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-4, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4, err_msg=k)
    assert got["p_valid"].sum() > 50 and 0 < got["p_inlier"].sum() < got["p_valid"].sum()
    # the residual records are the JAX package's
    viz_frame.dump_residuals_jsonl(got, str(tmp_path / "t" / "r.jsonl"), 3)
    jviz.dump_residuals_jsonl(want, str(tmp_path / "j" / "r.jsonl"), 3)
    a = json.loads((tmp_path / "t" / "r.jsonl").read_text())
    b = json.loads((tmp_path / "j" / "r.jsonl").read_text())
    assert a["frame"] == b["frame"] == 3
    for key in ("pt", "ls"):
        assert [(i, inl) for i, _, inl in a[key]] == [(i, inl) for i, _, inl in b[key]]
        np.testing.assert_allclose([r for _, r, _ in a[key]], [r for _, r, _ in b[key]],
                                   rtol=1e-3, atol=1.001e-3)


def test_render_frame_overlay(tmp_path):
    pytest.importorskip("matplotlib")
    prev, curr, DT = _noisy_pair(0)
    diag = viz_frame.compute_frame_diagnostics(
        stereo_features_from_numpy(prev, "cpu"), stereo_features_from_numpy(curr, "cpu"),
        torch.from_numpy(DT), TCAM, ttrk.TrackerConfig())
    path = str(tmp_path / "ov" / "overlay.png")
    viz_frame.render_frame_overlay(np.full((480, 752), 40.0, np.float32), diag, path,
                                   frame_id=4)
    assert os.path.getsize(path) > 0


def _mappers(n_kf=5):
    """The same feature-level map in both packages (test_viz_scene's)."""
    world = World(n_pts=120, n_ls=12)
    jm = jmap.MapHandler(JCAM, jmap.MapConfig(**MAP_KW))
    tm = tmap.MapHandler(TCAM, tmap.MapConfig(**MAP_KW), device="cpu")
    poses = lateral_poses(n_kf, 0.05)
    feats = [render_features(world, T, JCAM) for T in poses]
    jm.initialize(poses[0], feats[0])
    tm.initialize(poses[0], stereo_features_from_numpy(feats[0], "cpu"))
    for T, f in zip(poses[1:], feats[1:]):
        jm.add_keyframe(T, f, run_ba=False)
        tm.add_keyframe(T, stereo_features_from_numpy(f, "cpu"), run_ba=False)
    return jm, tm


def _assert_same_data(got: dict, want: dict):
    assert set(got) == set(want)
    for k in ("kf_ids", "cov_threshold"):
        assert got[k] == want[k], k
    for k in ("points", "lines", "kf_T", "cov_edges", "gt"):
        if k in want:
            a, b = np.asarray(got[k], float), np.asarray(want[k], float)
            assert a.shape == b.shape, k
            np.testing.assert_allclose(a, b, rtol=0, atol=2e-4, err_msg=k)


@pytest.mark.parametrize("gt", ["none", "positions", "poses"])
def test_scene_data_matches_jax(gt):
    jm, tm = _mappers()
    Ts = np.broadcast_to(np.eye(4), (4, 4, 4)).copy()
    Ts[:, 0, 3] = np.arange(4)
    g = {"none": None, "positions": np.zeros((4, 3)), "poses": Ts}[gt]
    got, want = viz_scene._scene_data(tm, gt=g), jscene._scene_data(jm, gt=g)
    _assert_same_data(got, want)
    m = tm.map
    assert len(got["points"]) == int(np.sum(m.pt_valid)) > 0
    assert len(got["kf_T"]) == len(m.keyframes) and len(got["lines"]) > 0
    n_exp = int(np.sum(np.triu(np.asarray(m.covis), 1) >= got["cov_threshold"]))
    assert len(got["cov_edges"]) == n_exp > 0
    if gt == "poses":
        assert [r[0] for r in got["gt"]] == [0.0, 1.0, 2.0, 3.0]
    small = viz_scene._scene_data(tm, max_points=10)
    assert len(small["points"]) == 10


def test_scene_html_matches_jax(tmp_path):
    jm, tm = _mappers()
    got = open(viz_scene.export_scene_html(tm, str(tmp_path / "t.html"))).read()
    want = open(jscene.export_scene_html(jm, str(tmp_path / "j.html"))).read()
    assert "http://" not in got and "https://" not in got and "<script src" not in got
    pat = re.compile(r"const DATA = (\{.*?\});\n", re.S)
    mg, mw = pat.search(got), pat.search(want)
    assert mg and mw
    assert got.replace(mg.group(1), "") == want.replace(mw.group(1), "")
    _assert_same_data(json.loads(mg.group(1)), json.loads(mw.group(1)))
