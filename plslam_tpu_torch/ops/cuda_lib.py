"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with its own nvcc, all started together, and the
objects link into one shared library with a plain C interface, loaded
with ctypes; no PyTorch headers, so a build takes seconds.  The library
goes to ``plslam_tpu_torch/_build/`` under a name that hashes the sources
and flags, so an edited source rebuilds.  ``csrc/probe/`` holds
measurement probes, built apart by their scripts.  The build happens on first use,
never at import: the CPU tests import every module on machines without
nvcc.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

from ..utils import profiling

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# flags of one source beside NVCC_FLAGS: the GN solve rounds every product
# and sum on its own, as the plain code's separate kernels do
SOURCE_FLAGS = {"gauss_newton.cu": ("-fmad=false",)}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# C entry points: name -> argument types; each returns a cudaError_t
SIGNATURES = {
    "plslam_gather_patches": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "plslam_fast_score_nms": (_P, _P, _P, _P, _I, _I, _I, _P),
    "plslam_hamming": (_P, _P, _P, _I, _I, _I, _LL, _LL, _P),
    "plslam_gauss_newton": (_P, _P),
    "plslam_gn_select_test": (_P, _P, _I, _I, _P, _P),
    "plslam_gn_max_rows": (),
}


class KernelBuild:
    """The loaded library, its path, build seconds and nvcc's log."""

    def __init__(self, lib: ctypes.CDLL, path: Path, seconds: float, log: str):
        self.lib, self.path, self.seconds, self.log = lib, path, seconds, log


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources() -> list[Path]:
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources in {CSRC_DIR}")
    return srcs


def build(srcs: list[Path], stem: str) -> tuple[Path, float, str]:
    """Compile srcs, one nvcc each, all started together, and link them
    into ``_build/<stem>_<hash>.so`` unless that library exists.  The hash
    covers the flags and every source under ``csrc/`` (a probe includes
    the kernels' sources).  Returns the library's path, the seconds taken
    and nvcc's log."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    for s in sorted(CSRC_DIR.rglob("*.cu")):
        h.update(str(s.relative_to(CSRC_DIR)).encode())
        h.update(s.read_bytes())
    path = BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"
    log_path = path.with_suffix(".log")
    t0 = time.perf_counter()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            nvcc = _nvcc()
            objs = [os.path.join(tmp, f"{s.stem}.o") for s in srcs]
            jobs = [[nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(s.name, ()), "-c", "-o", o, str(s)]
                    for o, s in zip(objs, srcs)]
            procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True) for cmd in jobs]
            runs = [(cmd, p.communicate()[0], p.returncode) for cmd, p in zip(jobs, procs)]
            link = [nvcc, "-shared", "-o", os.path.join(tmp, "lib.so"), *objs]
            if all(rc == 0 for _, _, rc in runs):
                p = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                   text=True)
                runs.append((link, p.stdout, p.returncode))
            for cmd, out, rc in runs:
                if rc != 0:
                    raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}")
            log_path.write_text("".join(out for _, out, _ in runs))
            os.replace(os.path.join(tmp, "lib.so"), path)
    seconds = time.perf_counter() - t0
    return path, seconds, log_path.read_text() if log_path.exists() else ""


@functools.lru_cache(maxsize=None)
def load() -> KernelBuild:
    """Compile (if needed) and load the kernel library."""
    path, seconds, log = build(_sources(), "libplslam_kernels")
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.plslam_error_string.argtypes = [ctypes.c_int]
    lib.plslam_error_string.restype = ctypes.c_char_p
    return KernelBuild(lib, path, seconds, log)


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = load().lib.plslam_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def require_cuda(what: str, *tensors: torch.Tensor) -> None:
    """Every tensor on the same CUDA device and contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{what}: tensors must share one CUDA device, got "
                             f"{[str(x.device) for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


_recorder = threading.local()


@contextlib.contextmanager
def recording():
    """While a CUDA graph is captured on this thread: a launch is recorded
    in the yielded {wrapper: launches} tally instead of counted (a captured
    launch does not run); ``graphs.Program`` adds the tally again at each
    replay, where the kernels do run."""
    tally: dict = {}
    _recorder.tally = tally
    try:
        yield tally
    finally:
        _recorder.tally = None


_observer = threading.local()


@contextlib.contextmanager
def observing(hook):
    """While active on this thread, a call of a ``counted`` wrapper goes to
    ``hook(wrapper, args, kwargs)``, which calls ``wrapper.__wrapped__``
    itself and returns its result (``roofline.WorkCounter`` counts each
    kernel's work by its formula this way)."""
    _observer.hook = hook
    try:
        yield
    finally:
        _observer.hook = None


class counted:
    """Decorator for a kernel wrapper: the wrapper calls ``count()`` where
    it launches its kernel, and the launches are counted under a lock,
    keyed by the launching thread's name (the tracker and the mapping
    worker launch the same kernels).  Under ``recording()`` the launch is
    recorded for the graph being captured instead.  ``launches`` is the
    total; assigning 0 to it resets every count.

    ``counted.unobserved(counter)`` decorates a wrapper whose calls never
    reach the ``observing`` hook (its launches are still counted and
    tallied for replays), and whose launches are also added to the
    thread's ``utils/profiling`` counter ``counter``."""

    def __init__(self, fn, observed: bool = True, counter: str | None = None):
        functools.update_wrapper(self, fn)
        self._lock = threading.Lock()
        self._by_thread: dict[str, int] = {}
        self._observed, self._counter = observed, counter

    @classmethod
    def unobserved(cls, counter: str):
        return functools.partial(cls, observed=False, counter=counter)

    def __call__(self, *args, **kwargs):
        hook = getattr(_observer, "hook", None) if self._observed else None
        if hook is not None:
            return hook(self, args, kwargs)
        return self.__wrapped__(*args, **kwargs)

    def count(self) -> None:
        tally = getattr(_recorder, "tally", None)
        if tally is not None:
            tally[self] = tally.get(self, 0) + 1
        else:
            self.add(1)

    def add(self, n: int) -> None:
        """Count ``n`` launches on this thread (a graph replay's)."""
        name = threading.current_thread().name
        with self._lock:
            self._by_thread[name] = self._by_thread.get(name, 0) + n
        if self._counter is not None:
            profiling.add(self._counter, n)

    def launches_by_thread(self) -> dict[str, int]:
        with self._lock:
            return dict(self._by_thread)

    @property
    def launches(self) -> int:
        with self._lock:
            return sum(self._by_thread.values())

    @launches.setter
    def launches(self, value: int) -> None:
        if value != 0:
            raise ValueError("launch counts can only be reset to 0")
        with self._lock:
            self._by_thread.clear()
