"""``plslam_tpu_torch.endpoint_gba_ab`` against ``scripts/endpoint_gba_ab.py``
on the JAX package's ring map (``__graft_entry__._build_ring_map``; the
port's ``io/ring_map.build_ring_map`` draws the same tables).

- ``extract_problem``: the flat f64 tables of both packages are equal,
  exactly.
- The f64 dense endpoint LM oracle, 5 iterations on the 16-keyframe ring
  cut to 256 points and 64 lines (116 points and 10 lines seen twice or
  more: a 444-parameter system).  A 6-keyframe ring has no landmark seen
  twice (60 degrees between keyframes), so the oracle's own 16 keyframes
  are kept and the landmarks cut.  The normal equations are singular along
  each line endpoint's own line (a point-to-line residual does not see an
  endpoint slide along it; only lambda*diag(H) and 1e-12 I hold it), so
  the two packages' rounding-level differences in H (their sums run in
  different orders) grow with every step.  Reading on this CPU, relative
  cost differences per iteration: 0, 7e-12, 2.4e-10, 1.5e-8, 1.9e-7, 1.6e-9;
  poses and points 2.3e-11 m apart after 5 iterations, endpoints 6.8e-8 m
  (along their lines).  Held: the first three costs within 1e-9 relative,
  all six within 1e-6; poses and points within 1e-9 m, endpoints within
  1e-6 m.
- The full-size run (16 keyframes, 1024 points, 128 lines, 40 iterations)
  is ``slow``: the oracle's iteration count, last cost and median point
  error to 1e-6 relative of JAX's (``scripts/jax_eval_reference.py
  gba``); (a), the f32 Plücker GBA, under the error before it and under
  chip_smoke's ``GBA_PLUCKER_RATIO`` (1.39) x JAX's median point error: the
  largest port/JAX ratio over the ring's seeds 1-7 on a CPU is 1.29
  (seed 3, this ring: JAX 0.00489 m, the port 0.00631 m;
  ``scripts/jax_eval_reference.py gba-seeds``), plus 0.10; (b), the f32
  endpoint GBA, finite only.  Its outcome is chaotic in f32 on both sides
  (seed 3: JAX 0.0064 m, the port 0.047 m, no better than before it;
  seed 6: 0.078 and 0.18 m; seed 7: 0.016 and 0.0072 m), so on the CPU no
  tighter bar holds; on the card it reads 0.00625 m in every run and
  chip_smoke holds it within max(10%, 5e-4 m) of JAX's.  On seed 3 the
  first LM step decides it: at lambda 1e-4 JAX's f32 reduced camera
  system is indefinite, its Cholesky fails and lambda rises, while the
  port's factors and takes the step; from lambda_init 1e-3 both land at
  0.0065-0.0068 m."""

import numpy as np
import pytest

from plslam_tpu_torch import endpoint_gba_ab as E
from test_torch_helpers import load_script, one_torch_thread  # noqa: F401

J = load_script("endpoint_gba_ab")
SMALL = dict(n_kf=16, n_pts=256, n_ls=64)
GBA_PLUCKER_RATIO = 1.29 + 0.10   # chip_smoke.GBA_PLUCKER_RATIO
# scripts/jax_eval_reference.py gba on a CPU (x86-64)
JAX_FULL = {"plucker": 0.004888185405764885, "endpoint": 0.006422390450644931,
            "oracle_pt": 0.005751876630915977, "oracle_last": 1.5451575653142723e-08,
            "iters": 40}


def _jax_map(plucker, n_kf, n_pts, n_ls):
    import dataclasses

    mapper, truth = J.G._build_ring_map(rng_seed=J.SEED, n_kf=n_kf, n_pts=n_pts, n_ls=n_ls,
                                        pose_noise=0.01, lm_noise=0.03)
    mapper.cfg = dataclasses.replace(mapper.cfg, plucker_lines=plucker)
    return mapper, truth


def test_extract_problem_equal():
    got = E.extract_problem(E.build(False, device="cpu", **SMALL)[0])
    want = J.extract_problem(_jax_map(False, **SMALL)[0])
    assert len(got) == len(want) == 11
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, i
        np.testing.assert_array_equal(g, w, err_msg=f"field {i}")
    assert len(got[0]) == 16 and len(got[1]) > 100 and len(got[2]) > 5


def test_oracle_cost_history_against_jax():
    xi, X, Ep, ids, hist = E.faithful_endpoint_lm(E.build(False, device="cpu", **SMALL)[0],
                                                  iters=5)
    jxi, jX, jE, jids, jhist = J.faithful_endpoint_lm(_jax_map(False, **SMALL)[0], iters=5)
    assert len(hist) == len(jhist) == 6
    np.testing.assert_allclose(hist[:3], jhist[:3], rtol=1e-9, atol=0)
    np.testing.assert_allclose(hist, jhist, rtol=1e-6, atol=0)
    assert hist[-1] < 1e-6 * hist[0]
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_allclose(X, jX, rtol=0, atol=1e-9)
    np.testing.assert_allclose(Ep, jE, rtol=0, atol=1e-6)
    np.testing.assert_allclose(xi, jxi, rtol=0, atol=1e-9)


def test_main_prints_the_scripts_line(capsys, monkeypatch):
    """The JSON line's keys and rounding are the script's (the solves cut
    to the small ring)."""
    import json

    build = E.build
    monkeypatch.setattr(E, "build", lambda plucker, device: build(plucker, device, **SMALL))
    lm = E.faithful_endpoint_lm
    monkeypatch.setattr(E, "faithful_endpoint_lm", lambda m, timings: lm(
        m, iters=3, timings=timings))
    raw = E.main(["--device", "cpu"])
    out = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert list(out) == ["n_kf", "n_pts", "n_ls", "pre", "ours_plucker", "ours_endpoint",
                         "oracle_endpoint_f64"]
    assert list(out["oracle_endpoint_f64"]) == ["pt", "wall_s", "cost_first_last", "iters_used"]
    assert out["oracle_endpoint_f64"]["iters_used"] == raw["oracle_endpoint_f64"]["iters_used"] == 3
    assert out["ours_plucker"]["pt"] == round(raw["ours_plucker"]["pt"], 5)
    assert raw["ours_plucker"]["pt"] < raw["pre"]["pt"]


@pytest.mark.slow
def test_full_size_against_jax():
    raw = E.main(["--device", "cpu"])
    assert raw["ours_plucker"]["pt"] < raw["pre"]["pt"]
    assert raw["ours_plucker"]["pt"] <= GBA_PLUCKER_RATIO * JAX_FULL["plucker"]
    assert np.isfinite(raw["ours_endpoint"]["pt"])
    o = raw["oracle_endpoint_f64"]
    assert o["iters_used"] == JAX_FULL["iters"]
    assert abs(o["cost_hist"][-1] / JAX_FULL["oracle_last"] - 1) <= 1e-6
    assert abs(o["pt"] / JAX_FULL["oracle_pt"] - 1) <= 1e-6
