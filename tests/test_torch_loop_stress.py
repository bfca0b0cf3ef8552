"""``plslam_tpu_torch.loop_stress``: tests/test_loop_stress.py's three
properties on the port (the ring renderer is held equal to the fixture's
by tests/test_torch_chip_smoke.py).

The tier-1 case cuts the stress to 40 + 24 + 12 keyframes with
``vocab_refresh_kfs=16`` (four online retrains); ring A keeps the full
size's raster (100 keyframes per revolution), so the first pass covers 40
sectors and the revisit closes against it across the corridor
(``lc_kf_dist`` is 50).  Reading on this CPU: one closure, keyframe 74 ->
10.  The full size (100 + 60 + 30, refresh 40) is ``slow``, as the JAX
package's test is.

The local BAs that the divergence guard (``MapConfig.lba_max_jump``)
throws out are held against a JAX rendition of tests/test_loop_stress.py's
replay at the same sizes: both packages log each one on the ``plslam``
logger, and the test counts those records on each side."""

import contextlib
import logging

import jax.numpy as jnp
import numpy as np
import pytest

import _map_fixtures as F
from plslam_tpu.backend.mapping import MapConfig as JMapConfig
from plslam_tpu.config import PLSLAMConfig as JConfig
from plslam_tpu.core import lie as jlie
from plslam_tpu.pipeline import PLSLAM as JPLSLAM
from plslam_tpu_torch import loop_stress as L
from test_loop_stress import _ShiftedRing
from test_torch_helpers import one_torch_thread  # noqa: F401

# A full revolution of ring A in 30 keyframes, then 2 of the corridor: the
# corridor's first keyframe (30) lands 60 m from ring A's start, and the
# local BA of its window [28, 29, 30] pulls it back towards the ring by
# ~70 m in both packages (at the full size, keyframe 100's window
# [98, 99, 100]: JAX 63.483711 m, the port 63.484508 m, this CPU).
TELEPORT = dict(n_a1=30, n_b=2, n_a2=0, refresh=16)
# That solve diverges, and where it ends is set by rounding.  On this CPU
# JAX reads 70.042219 m and the port 70.102255 m; the maps they start from
# differ by 7 mm in the poses and 19 mm in the points (earlier f32 local
# BAs), and on JAX's own problem the port's f32 solve reads 70.028602 m
# and its f64 solve 70.058329 m.  The jump is held to 0.2% of JAX's.
JUMP_RTOL = 2e-3


class _Discards(logging.Handler):
    """The pose jumps of the local BAs the divergence guard threw out, read
    off the records on the ``plslam`` logger (both packages log there)."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.jumps = []

    def emit(self, record):
        if record.msg.startswith("local BA discarded"):
            self.jumps.append(float(record.args[0]))


@contextlib.contextmanager
def _discards():
    handler, log = _Discards(), logging.getLogger("plslam")
    log.addHandler(handler)
    try:
        yield handler.jumps
    finally:
        log.removeHandler(handler)


def _jax_replay(n_a1, n_b, n_a2, refresh):
    """tests/test_loop_stress.py's replay (its worlds, configurations,
    odometry draws and descriptor noise) at these sizes, ring A on a raster
    of n_a1 keyframes per revolution, as ``loop_stress.run``'s default."""
    cam = F.make_camera()
    ring = F.RingWorld(n_pts=2200, n_ls=220, seed=5)
    corridor = _ShiftedRing(offset=(0.0, 60.0, 0.0), n_pts=1600, n_ls=160, seed=77)
    cfg = JConfig(use_line_plucker=False, use_loop_closure=True, multithread_slam=True,
                  vocab_refresh_kfs=refresh)
    mcfg = JMapConfig(use_lines=True, plucker_lines=False, local_ba_kf=8, ba_points=512,
                      ba_lines=64, ba_pobs=2048, ba_lobs=512)
    slam = JPLSLAM(cam, cfg, mcfg)
    worlds = [ring] * n_a1 + [corridor] * n_b + [ring] * n_a2
    thetas = ([2 * np.pi * i / n_a1 for i in range(n_a1)]
              + [np.pi * i / n_b for i in range(n_b)]
              + [2 * np.pi * i / n_a1 for i in range(n_a2)])
    T_true = [w.pose_at(th) for w, th in zip(worlds, thetas)]
    rng = np.random.default_rng(21)
    T_est = [T_true[0]]
    for i in range(1, len(T_true)):
        rel = np.linalg.inv(T_true[i - 1]) @ T_true[i]
        eps = np.concatenate([rng.normal(0, 0.010, 3), rng.normal(0, 0.0025, 3)])
        T_est.append(T_est[-1] @ rel @ np.asarray(jlie.exp_se3(jnp.asarray(eps))))
    saved, F._RING_DESC_RNG = F._RING_DESC_RNG, np.random.default_rng(1234)
    try:
        for i, (w, T) in enumerate(zip(worlds, T_est)):
            slam.insert_keyframe_features(T, F.render_ring_features(w, T_true[i], cam),
                                          timestamp=0.1 * i)
        slam.wait_until_idle()
        assert not slam._map_errors, slam._map_errors
    finally:
        F._RING_DESC_RNG = saved
        slam.finish(run_gba=False)


def _run(n_a1, n_b, n_a2, refresh, ring_steps=None):
    slam, layout = L.run(n_a1, n_b, n_a2, refresh, device="cpu", ring_steps=ring_steps)
    try:
        assert not slam._map_errors, slam._map_errors
        return slam, L.check(slam, layout)
    finally:
        slam.finish(run_gba=False)


def test_small_stress_keeps_the_three_properties():
    slam, out = _run(40, 24, 12, 16, ring_steps=100)
    assert out["keyframes"] == 76 == out["conf_rows"]
    assert any(kf >= 64 for kf, _ in out["closures"])
    assert slam.loop_closer.voc.num_words > 0


def test_discarded_local_bas_equal_jax():
    """The corridor's first keyframe trips the divergence guard in both
    packages: as many discards (the mapper is threaded, and each side read
    the same count in every run), each a jump of the corridor's scale, the
    port's within JUMP_RTOL of JAX's."""
    with _discards() as want:
        _jax_replay(**TELEPORT)
    with _discards() as got:
        slam, _ = L.run(TELEPORT["n_a1"], TELEPORT["n_b"], TELEPORT["n_a2"],
                        TELEPORT["refresh"], device="cpu")
        try:
            assert not slam._map_errors, slam._map_errors
        finally:
            slam.finish(run_gba=False)
    assert len(want) >= 1 and len(got) == len(want), (got, want)
    for a, b in zip(got, want):
        assert a > 50.0 and abs(a - b) <= JUMP_RTOL * b, (got, want)


def test_check_refuses_a_corridor_closure():
    """A closure touching the corridor, or pairing distant angles, fails."""
    from types import SimpleNamespace

    import numpy as np

    thetas = [2 * np.pi * i / 10 for i in range(10)] + [0.0] * 4 + [0.0, 2.5]
    lc = SimpleNamespace(voc=object(), conf=np.zeros((16, 16)))
    fake = SimpleNamespace(loop_closer=lc, mapper=SimpleNamespace(
        map=SimpleNamespace(keyframes=[None] * 16)))
    layout = {"thetas": thetas, "n_a1": 10, "n_b": 4, "steps": 10}
    for reports in ([{"kf": 14, "candidate": 11}], [{"kf": 15, "candidate": 0}],
                    [{"kf": 9, "candidate": 0}], []):
        fake.loop_reports = reports
        with pytest.raises(AssertionError):
            L.check(fake, layout)
    fake.loop_reports = [{"kf": 14, "candidate": 0}]
    assert L.check(fake, layout)["closures"] == [[14, 0]]


@pytest.mark.slow
def test_full_size_stress():
    _run(L.N_A1, L.N_B, L.N_A2, 40)
