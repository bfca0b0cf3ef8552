"""Which inner product suits the Hamming kernel, on one GPU.

    python -m plslam_tpu_torch.hamming_probe

Builds ``csrc/probe/hamming_variants.cu``: the shipped kernel of
``csrc/hamming.cu`` (two b1 AND products per n-tile) and six other inner
products inside the same staging and store (the source names them).  Each
is held bit-exact against the plain Hamming matrix, then timed at the
shapes the port gives the kernel: a CUDA graph of 100 launches, each into
its own preallocated output, between CUDA events, per launch.  The
variants run in turn, forward then backward, so that a drift of the
card's clock shows as a spread and not as a difference.
Prints one line per shape and a JSON line with every reading.  Needs
CUDA; exits non-zero without it.  The port never calls these variants.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import numpy as np
import torch

from .ops import cuda_lib
from .ops.descriptors import hamming_distance_matrix

SOURCE = cuda_lib.CSRC_DIR / "probe" / "hamming_variants.cu"
# probe_hamming's variant numbers (csrc/probe/hamming_variants.cu)
VARIANTS = {"popc": 0, "xor": 1, "and_pop": 2, "s8": 3, "popc_valid": 4, "popc_spread": 5}
# VO stereo/f2f points and lines, Map2KF, loop verification points and lines
SHAPES = ((1200, 1200), (2048, 1200), (256, 256), (160, 160), (24, 24))
LAUNCHES = 100
ROUNDS = 2


def build() -> ctypes.CDLL:
    """Compile the probe (it includes ../hamming.cu) and load it."""
    path, _, log = cuda_lib.build([SOURCE], "libhamming_probe")
    for line in log.splitlines():
        if "Used" in line:
            print(f"  ptxas: {line.strip()}")
    lib = ctypes.CDLL(str(path))
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.plslam_hamming.argtypes = [P, P, P, I, I, I, LL, LL, P]
    lib.probe_hamming.argtypes = [P, P, P, I, I, I, P]
    lib.plslam_hamming.restype = lib.probe_hamming.restype = I
    return lib


def launcher(lib, name: str):
    """launch(d1, d2, out) on the current stream; raises on a CUDA error."""
    def launch(d1, d2, out):
        stream = torch.cuda.current_stream().cuda_stream
        args = (d1.data_ptr(), d2.data_ptr(), out.data_ptr(), d1.shape[0], d2.shape[0])
        err = (lib.plslam_hamming(*args[:3], 1, *args[3:], 0, 0, stream) if name == "shipped"
               else lib.probe_hamming(*args, VARIANTS[name], stream))
        if err:
            raise RuntimeError(f"hamming probe {name}: CUDA error {err}")
    return launch


def graph_us(launch, d1, d2, outs) -> float:
    """Device µs per launch: len(outs) launches, each into its own output,
    captured in one CUDA graph and replayed between CUDA events (median of
    5 replays after a warm one)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        launch(d1, d2, outs[0])
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for out in outs:
            launch(d1, d2, out)
    times = []
    for _ in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(1e3 * start.elapsed_time(end) / len(outs))
    return float(np.median(times[1:]))


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("hamming_probe: no CUDA device")
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    lib = build()
    names = ["shipped", *VARIANTS]
    gen = torch.Generator().manual_seed(0)
    report = {}
    for n1, n2 in SHAPES:
        d1 = torch.randint(-2**31, 2**31, (n1, 8), generator=gen, dtype=torch.int64)
        d2 = torch.randint(-2**31, 2**31, (n2, 8), generator=gen, dtype=torch.int64)
        d1, d2 = d1.to(torch.int32).to(dev), d2.to(torch.int32).to(dev)
        want = hamming_distance_matrix(d1, d2)
        outs = [torch.empty((n1, n2), dtype=torch.int32, device=dev) for _ in range(LAUNCHES)]
        for name in names:
            outs[0].fill_(-1)
            launcher(lib, name)(d1, d2, outs[0])
            if not torch.equal(outs[0], want):
                raise AssertionError(f"hamming probe {name} {n1}x{n2}: not the Hamming matrix")
        times = {name: [] for name in names}
        for r in range(ROUNDS):
            for name in (names if r % 2 == 0 else names[::-1]):
                times[name].append(graph_us(launcher(lib, name), d1, d2, outs))
        report[f"{n1}x{n2}"] = times
        print(f"hamming probe {n1}x{n2}: exact; device us per launch "
              f"{ {k: [round(x, 3) for x in v] for k, v in times.items()} } on {smi}", flush=True)
        del outs
        torch.cuda.empty_cache()
    print(json.dumps({"hamming_probe_us": report, "card": smi}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
