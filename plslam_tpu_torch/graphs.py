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
  Python's cyclic garbage collector is off during a capture: a graph
  destroyed on the capturing thread (a dropped tracker's reference cycle
  collected mid-capture) invalidates the capture.  No collection runs
  before it: with the collector off none can start mid-capture, and a
  full pass over a SLAM process's objects takes a few hundred ms.
- The allocator frees no cached block while a capture is underway, and a
  capture's private pool cannot reuse the blocks the default pool keeps
  cached: after large eager work the card can be nearly full of free
  cached blocks, and the capture runs out of memory.  So before
  ``capture_begin`` the last warm-up's peak (``need``) is held against the
  card's free memory (``must_release``); where it does not fit and the
  cached blocks would make room, the device is synchronized and the
  allocator's cache emptied (``releases``, ``released_bytes`` in
  ``stats()``).  That covers the pools of dropped graphs too, which stay
  cached until then.  Under the capture lock no other thread captures, and
  ``empty_cache`` asserts only mid-capture.
- A capture or replay error raises.  Nothing falls back to eager: a
  capture that still does not fit raises ``torch.OutOfMemoryError``.
- Kernel launch counts stay true: the wrappers' launches during the
  capture are recorded (``cuda_lib.recording``), and each replay adds them
  again on the replaying thread.
- The capture is timed (``graphs.capture``), and so is a staged
  program's wait for its last replay (``graphs.staged.wait``); the cache
  release is a span (``graphs.release``): ``utils/profiling``.
- On a CPU device, or with ``capture=False`` (the counterpart of
  ``jax.disable_jit``), a call runs the function itself, so the CPU tests
  exercise the code the graph captures.

A ``Trips`` object runs the body of a fixed-trip loop (an LM or
Gauss-Newton iteration: the counterpart of a ``lax.scan`` body) as one
``Program``, built inside the call that owns the loop and dropped at its
end: the warm-up calls are trips the loop needs anyway, and every later
trip is a replay.

A ``StagedProgram`` is a ``Program`` whose inputs are host arrays (the
counterpart of a jitted function called with numpy arguments): they are
staged by dtype in one host buffer each (pinned on the card), uploaded
inside the program into device buffers their views read, and a call
returns a copy of the output.  A ``ProgramCache`` keeps such programs by
shape bucket, the least recently used evicted.
"""

from __future__ import annotations

import gc
import threading
import weakref
from collections import OrderedDict
from typing import Callable, NamedTuple

import numpy as np
import torch

from .ops import cuda_lib
from .utils.profiling import span, timed

WARMUP = 2
CAPTURE_MODE = "thread_local"
# What a capture's private pool holds beyond its warm-up's peak: the pool
# rounds each request up to the allocator's block and segment sizes and
# keeps the blocks the capture freed for the capture alone.  The batched
# VO step's pools at B = 1-16 are 1.53-1.58 times that peak on an H100
# (chip_smoke phase 10 prints both); small programs round up to whole
# 2 MiB and 20 MiB segments.
CAPTURE_MARGIN = 1.75
CAPTURE_SLACK = 256 << 20

_lock = threading.Lock()
_capture_lock = threading.Lock()
_counts = {"captures": 0, "replays": 0, "releases": 0, "released_bytes": 0}
_live: "weakref.WeakSet[Program]" = weakref.WeakSet()


def must_release(need: int, free: int, reserved: int, allocated: int) -> bool:
    """Whether a capture whose warm-up peaked ``need`` bytes above what was
    allocated before it should first have the allocator give back its
    cached blocks: yes when the card's ``free`` bytes do not cover the need
    with its margin and the cached unused bytes (``reserved - allocated``)
    would.  When even they would not, releasing cannot make the capture
    fit, and it raises out of memory as it would have."""
    want = need * CAPTURE_MARGIN + CAPTURE_SLACK
    return free < want <= free + reserved - allocated


def _make_room(device: torch.device, need: int) -> None:
    """Empty the allocator's cache before a capture that ``must_release``
    (under the capture lock: no other thread is capturing)."""
    free, _ = torch.cuda.mem_get_info(device)
    reserved = torch.cuda.memory_reserved(device)
    if not must_release(need, free, reserved, torch.cuda.memory_allocated(device)):
        return
    with span("graphs.release"):
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
    with _lock:
        _counts["releases"] += 1
        _counts["released_bytes"] += reserved - torch.cuda.memory_reserved(device)


class Program:
    """One function over static buffers, captured once on a CUDA device
    and replayed by each call (see the module docstring)."""

    def __init__(self, fn: Callable[[], object], device, *, capture: bool = True):
        self.fn = fn
        self.device = torch.device(device)
        self.graph = None
        self.outputs = None
        self.replays = 0
        self.warmups = 0      # calls of ``fn`` the capture made before it
        self.need = 0         # bytes the last warm-up allocated at its peak
        self._tally: dict = {}
        if self.device.type == "cuda" and capture:
            self._capture()

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def _capture(self) -> None:
        with timed("graphs.capture"):
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
            for _ in range(WARMUP - 1):
                self.fn()
            # the last warm-up's peak is what the capture will allocate
            # (another thread's allocations meanwhile count in it too)
            before = torch.cuda.memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
            self.fn()
            self.need = torch.cuda.max_memory_allocated(self.device) - before
            _make_room(self.device, self.need)
            # a graph destroyed on this thread mid-capture (the cyclic
            # collector freeing an old tracker object) invalidates the capture
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
        self.warmups = WARMUP

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

    def release(self) -> None:
        """Drop the graph and its outputs, out of any other thread's
        capture (a graph destroyed mid-capture can invalidate it).  Its
        pool stays cached until a capture that needs the room empties the
        allocator's cache."""
        with _capture_lock:
            self.graph = self.outputs = None


class Trips:
    """``fn``, one trip of a fixed-trip loop over static buffers (it reads
    the loop's carry from them and writes the next carry back with
    ``copy_``), as one ``Program``.

    ``run(n)`` runs n trips.  The program is built at the first ``run``
    of at least WARMUP trips, so its warm-up calls are trips of that run;
    every later trip replays it.  A loop of ``total`` trips that would
    leave no trip to replay after the warm-ups is not captured.  Exactly
    the trips asked for run, and they compute what ``fn`` called in a loop
    computes.  Used as a context manager: the graph is dropped at the end
    of the ``with`` block, once its last replay has run."""

    def __init__(self, fn: Callable[[], object], device, total: int, *, capture: bool = True):
        self.fn = fn
        self.device = torch.device(device)
        self.capture = capture
        self.left = total
        self.program = None
        self.eager = self.replayed = 0

    def run(self, n: int) -> None:
        if self.program is None and n >= WARMUP:
            self.program = Program(self.fn, self.device,
                                   capture=self.capture and self.left > WARMUP)
            n -= self.program.warmups
            self.left -= self.program.warmups
            self.eager += self.program.warmups
        for _ in range(n):
            if self.program is None:
                self.fn()
            else:
                self.program()
            replay = self.program is not None and self.program.captured
            self.replayed += replay
            self.eager += not replay
            self.left -= 1

    def stats(self) -> dict:
        """Trips run by ``fn`` itself (the warm-ups, or every trip when
        nothing was captured) and by replay, and the graph's pool bytes."""
        captured = self.program is not None and self.program.captured
        return {"eager": self.eager, "replayed": self.replayed, "captured": captured,
                "pool_bytes": self.program.pool_bytes() if captured else 0}

    def __enter__(self) -> "Trips":
        return self

    def __exit__(self, *exc) -> None:
        if self.program is not None and self.program.captured:
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            self.program.release()
        self.program = None


def captures() -> int:
    """Captures since start-up: ``stats()["captures"]`` without the
    allocator's snapshot that ``stats`` takes while a graph is held."""
    with _lock:
        return _counts["captures"]


def stats() -> dict:
    """Captures and replays since start-up, the allocator's cache releases
    before a capture and the bytes they gave back, the live graphs and
    their pools' bytes (a released program holds no graph; the allocator's
    snapshot is taken only when a graph is held)."""
    with _lock:
        live = [p.graph for p in _live]
        counts = dict(_counts)
    live = [g for g in live if g is not None]
    pools = {tuple(g.pool()) for g in live}
    pool_bytes = 0
    if pools:
        pool_bytes = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                         if tuple(seg.get("segment_pool_id", ())) in pools)
    return {**counts, "live": len(live), "pool_bytes": pool_bytes}


class Layout(NamedTuple):
    """Where each packed tensor lies in a byte buffer: (name, shape,
    dtype, byte offset, byte count) per field."""

    fields: tuple


def layout_of(named: dict[str, torch.Tensor]) -> Layout:
    """``pack``'s layout of ``named``: widest elements first, so every
    field starts aligned to its element size."""
    items = sorted(named.items(), key=lambda kv: -kv[1].element_size())
    fields, off = [], 0
    for name, t in items:
        n = t.numel() * t.element_size()
        fields.append((name, tuple(t.shape), t.dtype, off, n))
        off += n
    return Layout(tuple(fields))


def pack_into(named: dict[str, torch.Tensor], layout: Layout, out: torch.Tensor) -> torch.Tensor:
    """Write the bytes of ``named`` into the uint8 buffer ``out`` as
    ``layout`` places them (one kernel)."""
    return torch.cat([named[name].reshape(-1).view(torch.uint8)
                      for name, *_ in layout.fields], out=out)


def pack(named: dict[str, torch.Tensor]) -> tuple[torch.Tensor, Layout]:
    """Concatenate the bytes of several tensors into one uint8 buffer (one
    kernel; ``layout_of`` places them).  ``unpack`` of a copy of the
    buffer gives views that no later replay can change."""
    layout = layout_of(named)
    return torch.cat([named[name].reshape(-1).view(torch.uint8)
                      for name, *_ in layout.fields]), layout


def unpack(buf: torch.Tensor, layout: Layout) -> dict[str, torch.Tensor]:
    """Views of ``buf`` as the tensors ``pack`` put in it (no kernel)."""
    return {name: buf[off:off + n].view(dtype).reshape(shape)
            for name, shape, dtype, off, n in layout.fields}


def leaves(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """A NamedTuple tree's tensors by dotted path (``points.uv``)."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    out = {}
    for name, x in zip(tree._fields, tree):
        out.update(leaves(x, f"{prefix}.{name}" if prefix else name))
    return out


def rebuild(like, named: dict[str, torch.Tensor], prefix: str = ""):
    """The NamedTuple tree of ``like``'s structure whose leaves are
    ``named``'s tensors by dotted path (the inverse of ``leaves``)."""
    if isinstance(like, torch.Tensor):
        return named[prefix]
    return type(like)(*(rebuild(x, named, f"{prefix}.{name}" if prefix else name)
                        for name, x in zip(like._fields, like)))


def tree_pack_clone(tree):
    """A copy of a NamedTuple tree of tensors in one kernel: its leaves are
    views of one new byte buffer."""
    buf, layout = pack(leaves(tree))
    return rebuild(tree, unpack(buf, layout))


def tree_clone(tree):
    """A tree of tensors (NamedTuples, tuples; None leaves) copied leaf by leaf."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    items = [tree_clone(x) for x in tree]
    return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)


def tree_copy_(dst, src) -> None:
    """Copy a tree of tensors into ``dst``'s buffers, in place (a leaf that
    already is its destination is skipped)."""
    if dst is None:
        return
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


def _torch_dtype(a: np.ndarray) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, a.dtype)).dtype


class StagedProgram:
    """``fn(inputs)`` as one ``Program`` over host arrays and device trees.

    ``arrays`` (name -> numpy array) are packed by dtype into one host
    staging buffer each, pinned on the card; the program uploads each into
    a device buffer, and ``inputs[name]`` is the view of that buffer with
    the array's shape and dtype.  ``trees`` (name -> NamedTuple tree of
    device tensors) each get one static byte buffer, filled before the
    replay by one kernel (``pack_into``); ``inputs[name]`` is the tree of
    views of it.  ``fn`` must read its inputs only through ``inputs``.

    A call waits for the previous replay (whose upload reads the staging
    buffers), fills them, replays and returns a copy of the output, which
    a later call leaves as it is.  On a CPU device or with ``capture=False``
    the same code runs eagerly (``Program``)."""

    def __init__(self, fn: Callable[[dict], torch.Tensor], arrays: dict, device, *,
                 trees: dict | None = None, capture: bool = True):
        dev = torch.device(device)
        pinned = dev.type == "cuda"
        self.fn = fn
        self.slots = {}   # name -> (dtype, offset, shape)
        sizes: dict = {}
        for name, a in arrays.items():
            dt = _torch_dtype(a)
            self.slots[name] = (dt, sizes.get(dt, 0), a.shape)
            sizes[dt] = sizes.get(dt, 0) + a.size
        self.host = {dt: torch.empty(n, dtype=dt, pin_memory=pinned) for dt, n in sizes.items()}
        self.host_np = {dt: h.numpy() for dt, h in self.host.items()}
        self.dev = {dt: torch.empty(n, dtype=dt, device=dev) for dt, n in sizes.items()}
        self.inputs = {name: self.dev[dt][off:off + int(np.prod(shape))].view(shape)
                       for name, (dt, off, shape) in self.slots.items()}
        self.layouts, self.buffers = {}, {}
        for name, tree in (trees or {}).items():
            lay = self.layouts[name] = layout_of(leaves(tree))
            size = sum(f[4] for f in lay.fields)
            buf = self.buffers[name] = torch.zeros(size, dtype=torch.uint8, device=dev)
            self.inputs[name] = rebuild(tree, unpack(buf, lay))
        self._done = None
        # the capture's warm-up runs read the staging and tree buffers: this
        # call's inputs, not what a reused pinned block held (indices out of range)
        self._fill(arrays, trees or {})
        self.program = Program(self._run, dev, capture=capture)

    @staticmethod
    def key(arrays: dict, trees: dict | None = None) -> tuple:
        """The bucket: every array's name, shape and dtype, and every
        tree's layout."""
        return (tuple((k, a.shape, a.dtype.str) for k, a in arrays.items()),
                tuple((k, layout_of(leaves(t))) for k, t in (trees or {}).items()))

    def _run(self) -> torch.Tensor:
        for dt, d in self.dev.items():
            d.copy_(self.host[dt], non_blocking=True)
        return self.fn(self.inputs)

    def _fill(self, arrays: dict, trees: dict) -> None:
        for name, a in arrays.items():
            dt, off, _ = self.slots[name]
            self.host_np[dt][off:off + a.size] = a.reshape(-1)
        for name, tree in trees.items():
            pack_into(leaves(tree), self.layouts[name], self.buffers[name])

    def wait(self) -> None:
        """Block until the last replay has run."""
        if self._done is not None:
            with timed("graphs.staged.wait"):
                self._done.synchronize()

    def __call__(self, arrays: dict, trees: dict | None = None) -> torch.Tensor:
        self.wait()  # the staging buffers are the last replay's upload source
        self._fill(arrays, trees or {})
        out = self.program().clone()
        if self.program.device.type == "cuda":
            self._done = torch.cuda.Event()
            self._done.record()
        return out


class ProgramCache:
    """``StagedProgram``s by shape bucket, most recently used last; beyond
    ``size`` the least recently used is evicted once its last replay has
    run.  Counts the programs built and evicted, and the captures and
    replays of those evicted."""

    def __init__(self, size: int):
        self.size = size
        self._progs: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self.counts = {"built": 0, "evicted": 0, "captures": 0, "replays": 0}

    def get(self, key, build: Callable[[], StagedProgram]) -> StagedProgram:
        """The program of ``key``, built by ``build()`` if not held."""
        with self._lock:
            prog = self._progs.pop(key, None)
        if prog is None:
            prog = build()
            with self._lock:
                self.counts["built"] += 1
        with self._lock:
            self._progs[key] = prog
            evicted = []
            while len(self._progs) > self.size:
                evicted.append(self._progs.popitem(last=False)[1])
        self._drop(evicted)
        return prog

    def _drop(self, progs: list) -> None:
        for old in progs:
            old.wait()  # its last replay ends before its pool is given back
            with self._lock:
                self.counts["evicted"] += 1
                self.counts["captures"] += old.program.captured
                self.counts["replays"] += old.program.replays
            old.program.release()

    def clear(self) -> None:
        """Evict every program."""
        with self._lock:
            progs = list(self._progs.values())
            self._progs.clear()
        self._drop(progs)

    def __iter__(self):
        with self._lock:
            return iter(list(self._progs))

    def __reversed__(self):
        with self._lock:
            return iter(list(reversed(self._progs)))

    def __len__(self) -> int:
        return len(self._progs)

    def stats(self) -> dict:
        """Built and evicted since start-up, the buckets held, the captured
        ones among them, captures and replays since start-up, and the bytes
        of the held graphs' pools."""
        with self._lock:
            progs, counts = list(self._progs.values()), dict(self.counts)
        return {"built": counts["built"], "evicted": counts["evicted"], "buckets": len(progs),
                "captured": sum(p.program.captured for p in progs),
                "captures": counts["captures"] + sum(p.program.captured for p in progs),
                "replays": counts["replays"] + sum(p.program.replays for p in progs),
                "pool_bytes": sum(p.program.pool_bytes() for p in progs)}
