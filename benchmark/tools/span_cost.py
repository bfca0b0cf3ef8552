"""The host cost of the program's spans (``plslam_tpu_torch.utils.profiling``),
and whether a thread started before the profiler reaches the trace.  A
measurement aid: no benchmark run calls it, and nothing of the benchmark
imports it.

    python3 benchmark/tools/span_cost.py > span_cost.json    # needs CUDA

Prints one JSON object: ns per ``span`` and per ``timed`` (and per an
empty context manager, the floor) over 10^5 calls, three times with the
profiler off and once on, without and with ``profile_all_threads``; then
the events named ``*probe*`` of two short traces, in which a thread
started before the profiler opens a span, without and with
``profile_all_threads``.
"""

import json
import os
import sys
import threading
import time

sys.path.insert(0, os.getcwd())

N = 100_000


def cost(cm, n=N):
    t = time.perf_counter_ns()
    for _ in range(n):
        with cm("pipeline.probe"):
            pass
    return (time.perf_counter_ns() - t) / n


class _Empty:
    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def main():
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    from plslam_tpu_torch.utils import profiling as P

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out = {"python": sys.version, "torch": torch.__version__, "cuda": torch.version.cuda,
           "card": torch.cuda.get_device_name(0)}

    def config(all_threads):
        return ({"experimental_config": _ExperimentalConfig(profile_all_threads=True)}
                if all_threads else {})

    x = torch.ones(1 << 20, device="cuda")
    (x * 2).sum().item()
    for rep in range(3):
        out[f"off_rep{rep}"] = {"span_ns": cost(P.span), "timed_ns": cost(P.timed),
                                "empty_cm_ns": cost(_Empty)}
    for all_threads in (False, True):
        with profile(activities=acts, **config(all_threads)):
            on = {"span_ns": cost(P.span), "timed_ns": cost(P.timed)}
        out[f"on_all_threads_{all_threads}"] = on

    go, done = threading.Event(), threading.Event()

    def work():
        go.wait()
        with P.span("mapper.probe_thread"):
            (x * 3).sum()
        torch.cuda.synchronize()
        done.set()

    for all_threads in (False, True):
        go.clear()
        done.clear()
        th = threading.Thread(target=work, name="probe-thread")
        th.start()
        with profile(activities=acts, **config(all_threads)) as prof:
            with P.span("vo.probe"):
                (x * 2).sum()
            torch.cuda.synchronize()
            go.set()
            done.wait(30)
        th.join()
        out[f"probe_events_all_threads_{all_threads}"] = [
            [e.name(), str(e.device_type()), e.start_thread_id()]
            for e in prof.profiler.kineto_results.events() if "probe" in e.name()]
    print(json.dumps(out, indent=1, default=str))


if __name__ == "__main__":
    main()
