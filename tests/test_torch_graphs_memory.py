"""``graphs.must_release``: whether a capture first has the caching
allocator give back its cached blocks, from the last warm-up's peak
(``need``), the card's free bytes and the allocator's reserved and
allocated bytes; and the release counters of ``graphs.stats()``.  The
release itself runs on the card only (tests/test_torch_gpu_graphs.py)."""

import pytest

from plslam_tpu_torch import graphs

GiB = 1 << 30


def _want(need: int) -> float:
    return need * graphs.CAPTURE_MARGIN + graphs.CAPTURE_SLACK


@pytest.mark.parametrize("need, free", [
    (0, graphs.CAPTURE_SLACK),                  # a capture that allocates nothing
    (GiB, int(_want(GiB))),                      # free covers the need and its margin exactly
    (6 * GiB, 70 * GiB),                         # a fresh process: the card is mostly free
])
def test_no_release_while_free_memory_covers_the_need(need, free):
    assert not graphs.must_release(need, free, reserved=74 * GiB, allocated=2 * GiB)


@pytest.mark.parametrize("need, free, reserved, allocated", [
    (GiB, GiB, 74 * GiB, 2 * GiB),               # after a long run: the reserve is cached
    (GiB, int(_want(GiB)) - 1, 2 * GiB, GiB),     # one byte short, the cache covers it
    (3 * GiB, GiB // 2, 6 * GiB, 0),             # nothing allocated, a dead graph's pool cached
])
def test_release_when_only_the_cached_blocks_make_room(need, free, reserved, allocated):
    assert graphs.must_release(need, free, reserved, allocated)


@pytest.mark.parametrize("need, free, reserved, allocated", [
    (80 * GiB, GiB, 74 * GiB, 2 * GiB),          # more than the card holds
    (4 * GiB, GiB, 6 * GiB, 3 * GiB),            # free + cached falls short of the margin
    (GiB, 0, 2 * GiB, 2 * GiB),                  # nothing cached
])
def test_no_release_when_even_the_whole_reserve_would_not_cover_it(need, free, reserved,
                                                                   allocated):
    """The capture then raises out of memory as it would have; a release
    could not make it fit."""
    assert not graphs.must_release(need, free, reserved, allocated)


def test_stats_carry_the_release_counters_as_zeros_on_the_cpu():
    """A CPU program runs its function and never touches the allocator."""
    prog = graphs.Program(lambda: None, "cpu")
    prog()
    st = graphs.stats()
    assert st["releases"] == 0 and st["released_bytes"] == 0
    assert {"captures", "replays", "live", "pool_bytes"} <= set(st)
