"""Captured per-frame programs: the port's counterpart of ``jax.jit`` with
``.lower().compile()``.

A ``Program`` wraps a function of no arguments that reads and writes
tensors its caller owns ("static buffers": the input images, the VO
state, a BA problem's upload buffers).  On a CUDA device it runs the
function WARMUP times on a side stream (lazy handles, cached
constants and workspaces settle), then captures one call into a
``torch.cuda.CUDAGraph``; every later call replays the graph and returns
the tensors the captured call returned, which the next replay overwrites.
A caller that hands a result out copies it first (``pack`` and ``unpack``
make that one copy).

- Capture runs with ``capture_error_mode="thread_local"``: the tracker
  and the ``plslam-mapper`` thread capture and replay on one card at the
  same time, and the default ``"global"`` mode fails the other thread's
  allocations mid-capture.  It calls ``capture_begin``/``capture_end``
  itself rather than ``torch.cuda.graph``, whose entry empties the
  allocator's cache (which asserts while another thread captures).
- One capture at a time in the process (a lock around warm-up and
  capture): the side streams come from PyTorch's round-robin pool, and two
  concurrent captures must not meet on one stream.  Replays take no lock.
  Python's cyclic garbage collector runs before a capture and is off
  during it: a graph destroyed on the capturing thread (a dropped tracker's
  reference cycle collected mid-capture) invalidates the capture.
- A capture or replay error raises.  Nothing falls back to eager.
- Kernel launch counts stay true: the wrappers' launches during the
  capture are recorded (``cuda_lib.recording``), and each replay adds them
  again on the replaying thread.
- On a CPU device, or with ``capture=False`` (the counterpart of
  ``jax.disable_jit``), a call runs the function itself, so the CPU tests
  exercise the code the graph captures.
"""

from __future__ import annotations

import gc
import threading
import weakref
from typing import Callable, NamedTuple

import torch

from .ops import cuda_lib

WARMUP = 2
CAPTURE_MODE = "thread_local"

_lock = threading.Lock()
_capture_lock = threading.Lock()
_counts = {"captures": 0, "replays": 0}
_live: "weakref.WeakSet[Program]" = weakref.WeakSet()


class Program:
    """One function over static buffers, captured once on a CUDA device
    and replayed by each call (see the module docstring)."""

    def __init__(self, fn: Callable[[], object], device, *, capture: bool = True):
        self.fn = fn
        self.device = torch.device(device)
        self.graph = None
        self.outputs = None
        self.replays = 0
        self._tally: dict = {}
        if self.device.type == "cuda" and capture:
            self._capture()

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def _capture(self) -> None:
        cuda_lib.load()  # the kernel library is built and loaded before any capture
        with _capture_lock:
            self._capture_locked()
        with _lock:
            _counts["captures"] += 1
            _live.add(self)

    def _capture_locked(self) -> None:
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                self.fn()
            # a graph destroyed on this thread mid-capture (the cyclic
            # collector freeing an old tracker object) invalidates the capture
            gc.collect()
            collecting = gc.isenabled()
            gc.disable()
            try:
                with cuda_lib.recording() as tally:
                    graph.capture_begin(capture_error_mode=CAPTURE_MODE)
                    try:
                        outputs = self.fn()
                    except BaseException:
                        try:
                            graph.capture_end()
                        except RuntimeError:
                            pass  # the capture was invalidated by the error raised above
                        raise
                    graph.capture_end()
            finally:
                if collecting:
                    gc.enable()
        current.wait_stream(side)
        self.graph, self.outputs, self._tally = graph, outputs, dict(tally)

    def __call__(self):
        if self.graph is None:
            return self.fn()
        self.graph.replay()
        for wrapper, n in self._tally.items():
            wrapper.add(n)
        self.replays += 1
        with _lock:
            _counts["replays"] += 1
        return self.outputs

    def launches_per_replay(self) -> dict[str, int]:
        """Kernel launches of one replay, by wrapper name."""
        return {w.__name__: n for w, n in self._tally.items()}

    def pool_bytes(self) -> int:
        """Bytes of device memory held by this graph's private pool."""
        if self.graph is None:
            return 0
        pool = tuple(self.graph.pool())
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)


def stats() -> dict:
    """Captures and replays since start-up, the live graphs and their pools' bytes."""
    with _lock:
        counts, live = dict(_counts), list(_live)
    pools = {tuple(p.graph.pool()) for p in live}
    pool_bytes = 0
    if pools:
        pool_bytes = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                         if tuple(seg.get("segment_pool_id", ())) in pools)
    return {**counts, "live": len(live), "pool_bytes": pool_bytes}


class Layout(NamedTuple):
    """Where each packed tensor lies in a byte buffer: (name, shape,
    dtype, byte offset, byte count) per field."""

    fields: tuple


def pack(named: dict[str, torch.Tensor]) -> tuple[torch.Tensor, Layout]:
    """Concatenate the bytes of several tensors into one uint8 buffer (one
    kernel), widest elements first so every field starts aligned to its
    element size.  ``unpack`` of a copy of the buffer gives views that no
    later replay can change."""
    items = sorted(named.items(), key=lambda kv: -kv[1].element_size())
    parts, fields, off = [], [], 0
    for name, t in items:
        b = t.reshape(-1).view(torch.uint8)
        parts.append(b)
        fields.append((name, tuple(t.shape), t.dtype, off, b.numel()))
        off += b.numel()
    return torch.cat(parts), Layout(tuple(fields))


def unpack(buf: torch.Tensor, layout: Layout) -> dict[str, torch.Tensor]:
    """Views of ``buf`` as the tensors ``pack`` put in it (no kernel)."""
    return {name: buf[off:off + n].view(dtype).reshape(shape)
            for name, shape, dtype, off, n in layout.fields}


def tree_clone(tree):
    """A NamedTuple tree of tensors copied leaf by leaf."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    return type(tree)(*(tree_clone(x) for x in tree))


def tree_copy_(dst, src) -> None:
    """Copy a NamedTuple tree of tensors into ``dst``'s buffers, in place
    (a leaf that already is its destination is skipped)."""
    if isinstance(dst, torch.Tensor):
        if src is not dst:
            dst.copy_(src)
        return
    for d, s in zip(dst, src):
        tree_copy_(d, s)


def same_layout(a, b) -> bool:
    """Two NamedTuple trees of tensors with equal structure, shapes and dtypes."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.shape == b.shape and a.dtype == b.dtype)
    return (type(a) is type(b) and len(a) == len(b)
            and all(same_layout(x, y) for x, y in zip(a, b)))
