"""Endpoint-line mapping against the JAX package under tight BA tables
(the point-observation table's endpoint ``room`` rule, a multi-chunk
endpoint GBA), and the keyframe pose refinement on drifted VO poses; the
same exact and 1e-4 m comparisons as test_torch_mapping_endpoint.py."""

import dataclasses
import logging

import numpy as np

from test_torch_helpers import one_torch_thread  # noqa: F401
from test_torch_mapping_endpoint import _assert_same, _ring, _run


def test_refinement_moves_the_pose():
    """With drifted VO poses the refinement re-solves each keyframe pose
    from the landmark correspondences; both sides take the same poses."""
    poses, feats = _ring(5)
    rng = np.random.default_rng(4)
    drifted = [poses[0]]
    for T in poses[1:]:
        D = np.eye(4)
        D[:3, 3] = rng.normal(0.0, 0.01, 3)
        drifted.append(T @ D)
    jm, tm = _run(drifted, feats, gba=False, has_refinement=True, local_ba_kf=4)
    kf_err = [np.linalg.norm(k.T_w_k[:3, 3] - T[:3, 3])
              for k, T in zip(tm.map.keyframes[1:], poses[1:])]
    vo_err = [np.linalg.norm(D[:3, 3] - T[:3, 3]) for D, T in zip(drifted[1:], poses[1:])]
    assert np.mean(kf_err) < np.mean(vo_err)


def test_endpoint_capacity_rules(caplog):
    """Small BA tables: the endpoint rows of the last local BA overflow the
    point-observation table's ``room`` and are cut there, and the GBA runs
    in several chunks with |points| + 2 |lines| within each chunk's point
    table."""
    poses, feats = _ring()
    with caplog.at_level(logging.WARNING, logger="plslam"):
        jm, tm = _run(poses, feats, gba=False, ba_points=1024, ba_lines=64, ba_pobs=900,
                      ba_lobs=256)
    assert any("endpoint-line obs overflow" in m for m in caplog.messages)
    caplog.clear()
    for m in (jm, tm):
        m.cfg = dataclasses.replace(m.cfg, ba_points=256)
    with caplog.at_level(logging.INFO, logger="plslam"):
        jm.global_bundle_adjustment()
        tm.global_bundle_adjustment()
    _assert_same(jm, tm)
    n_chunks = [int(m.split(" in ")[1].split()[0]) for m in caplog.messages
                if m.startswith("GBA:")]
    assert n_chunks == [n_chunks[0]] * 2 and n_chunks[0] >= 2, caplog.messages
    assert tm._gba_chunk_caps() == jm._gba_chunk_caps() == (256, 64, 128, 64)
