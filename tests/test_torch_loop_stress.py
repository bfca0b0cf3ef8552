"""``plslam_tpu_torch.loop_stress``: tests/test_loop_stress.py's three
properties on the port (the ring renderer is held equal to the fixture's
by tests/test_torch_chip_smoke.py).

The tier-1 case cuts the stress to 40 + 24 + 12 keyframes with
``vocab_refresh_kfs=16`` (four online retrains); ring A keeps the full
size's raster (100 keyframes per revolution), so the first pass covers 40
sectors and the revisit closes against it across the corridor
(``lc_kf_dist`` is 50).  Reading on this CPU: one closure, keyframe 74 ->
10.  The full size (100 + 60 + 30, refresh 40) is ``slow``, as the JAX
package's test is."""

import pytest

from plslam_tpu_torch import loop_stress as L
from test_torch_helpers import one_torch_thread  # noqa: F401


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
