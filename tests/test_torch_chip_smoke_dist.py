"""chip_smoke.py's phase 11 (distribution) rehearsed on the CPU."""

import torch

from test_torch_helpers import SMALL_DIST, load_chip_smoke

chip_smoke = load_chip_smoke()


def test_dist_phase_on_the_cpu():
    """Phase 11 rehearsed on the CPU with gloo at world 1 (SMALL_DIST):
    every program against its single-device counterpart, the sharded batch
    bit-identical to the unsharded one; not the kernels' launch counts or
    the card."""
    streams = [chip_smoke.render_stream(s, 2, SMALL_DIST["scene"]) for s in range(2)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        launches, ms = chip_smoke.phase_dist(torch.device("cpu"), "CPU", streams, SMALL_DIST)
    finally:
        torch.set_num_threads(threads)
    assert set(launches) == set(chip_smoke._wrappers()) and not any(launches.values())
    assert {"dist_ba", "dist_ba_2d", "dist_match", "dist_pgo", "dist_gba 1-axis",
            "dist_gba 2-axis", "dist_batch_vo", "batch_vo"} <= set(ms)
    assert not torch.distributed.is_initialized()
