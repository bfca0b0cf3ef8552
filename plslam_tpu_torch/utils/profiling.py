"""Spans and counters of the port's layers, on the profiler's clock.

- ``span(name)``: while a ``torch.profiler`` records, the block is a
  ``record_function`` range, so it lands in the trace beside the device
  work it launches (Kineto's host clock is the Unix clock).  Otherwise it
  costs one read of the flag torch sets while it records.  A thread that
  was running before the profiler started is recorded only when the
  profiler runs with ``_ExperimentalConfig(profile_all_threads=True)``.
- ``timed(name)``: a ``span`` that also adds its duration
  (``perf_counter_ns``) and one call to the calling thread's counters
  ``<name>.ns`` and ``<name>.calls``, whether or not the block raises.
- ``add(name, n)``: adds ``n`` to the calling thread's counter ``name``.
- ``counters()``: a snapshot ``{thread name: {counter: value}}``.  Each
  thread writes its own dict, so the hot path takes no lock; threads of
  one name add up.  ``per_call_ms`` and ``added`` read the difference of
  two snapshots.
- While the profiler records, each pass of Python's cyclic collector is a
  ``host.gc`` span on the thread it interrupts.

Counters are always on; nothing turns spans on but the profiler.  Names
are ``<layer>.<what>`` (PERF.md's layers); a name that ends in ``.wait``
is time the thread spent blocked on the card or on a queue.

An operator's trace of the program's spans::

    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        for pair in frames:
            slam.process(*pair)
    prof.export_chrome_trace("trace.json")
"""

from __future__ import annotations

import gc
import threading
import time

import torch.autograd.profiler as _autograd_profiler
from torch.autograd.profiler import record_function

_local = threading.local()
_lock = threading.Lock()
_threads: list = []         # (thread, its counters), every thread that counted


def _mine() -> dict:
    try:
        return _local.counts
    except AttributeError:
        counts = _local.counts = {}
        with _lock:
            _threads.append((threading.current_thread(), counts))
        return counts


def add(name: str, n: int = 1) -> None:
    """Add ``n`` to this thread's counter ``name``."""
    counts = _mine()
    counts[name] = counts.get(name, 0) + n


def counters() -> dict:
    """``{thread name: {counter: value}}`` of every thread that counted,
    the finished ones included."""
    with _lock:
        snap = [(th.name, dict(counts)) for th, counts in _threads]
    out: dict = {}
    for name, counts in snap:
        mine = out.setdefault(name, {})
        for k, v in counts.items():
            mine[k] = mine.get(k, 0) + v
    return out


class span:
    """The block as a ``record_function`` range while the profiler records."""

    __slots__ = ("name", "_rf")

    def __init__(self, name: str):
        self.name = name
        self._rf = None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self._rf = record_function(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        return False


class timed(span):
    """A ``span`` that adds its ns and one call to this thread's counters."""

    __slots__ = ("_t0",)

    def __enter__(self):
        span.__enter__(self)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self._t0
        counts = _mine()
        ns, calls = self.name + ".ns", self.name + ".calls"
        counts[ns] = counts.get(ns, 0) + dt
        counts[calls] = counts.get(calls, 0) + 1
        return span.__exit__(self, *exc)


def per_call_ms(before: dict, after: dict) -> dict:
    """``{thread: {name: (ms per call, calls)}}`` of the ``timed`` blocks
    that ran between two ``counters()`` snapshots."""
    out = {}
    for th, counts in after.items():
        old = before.get(th, {})
        rows = {}
        for key, calls in counts.items():
            if not key.endswith(".calls"):
                continue
            name = key[:-len(".calls")]
            n = calls - old.get(key, 0)
            if n:
                ns = counts.get(name + ".ns", 0) - old.get(name + ".ns", 0)
                rows[name] = (ns / n / 1e6, n)
        if rows:
            out[th] = rows
    return out


def added(before: dict, after: dict) -> dict:
    """``{thread: {name: increase}}`` of the ``add`` counters (not the
    ``timed`` blocks' ``.ns`` and ``.calls``) between two ``counters()``
    snapshots."""
    out = {}
    for th, counts in after.items():
        old = before.get(th, {})
        rows = {k: v - old.get(k, 0) for k, v in counts.items()
                if not k.endswith((".ns", ".calls")) and v != old.get(k, 0)}
        if rows:
            out[th] = rows
    return out


def _gc_span(phase: str, info: dict) -> None:
    """``gc.callbacks`` hook: a collector pass is a ``host.gc`` range
    while the profiler records."""
    if phase == "start":
        if _autograd_profiler._is_profiler_enabled:
            rf = _local.gc = record_function("host.gc")
            rf.__enter__()
    else:
        rf = getattr(_local, "gc", None)
        if rf is not None:
            _local.gc = None
            rf.__exit__(None, None, None)


if _gc_span not in gc.callbacks:
    gc.callbacks.append(_gc_span)
