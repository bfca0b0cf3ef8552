"""Reduce a ``torch.profiler`` slice to device time: busy time (the union
over streams), time per stream, per kernel name, and the idle gaps, each
labelled by the benchmark span the host was in."""

from __future__ import annotations

from collections import defaultdict

import torch


def _device_events(prof):
    """(name, stream, start_ns, end_ns) of every device activity: kernels,
    copies and fills, not the annotations the profiler mirrors onto the
    device timeline."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda or getattr(e, "is_user_annotation", bool)() or e.name().startswith("bench."):
            continue
        s = e.start_ns()
        out.append((e.name(), e.device_resource_id(), s, s + e.duration_ns()))
    return out


def _spans(prof, prefix: str = "bench."):
    """(name, start_ns, end_ns) of the benchmark's own spans."""
    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name.startswith(prefix):
            s = e.start_ns()
            out.append((name, s, s + e.duration_ns()))
    return out


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce(prof, t0_ns: int, t1_ns: int, vo_kernel: str, kernels=()) -> dict:
    """Device time inside [t0_ns, t1_ns] (the host clock of the slice's
    first call and last return).  The VO stream is the one that runs
    ``vo_kernel`` (only the tracking step detects corners); every other
    stream is the mapping worker's.  ``kernels``: names whose device time
    on the VO stream is summed apart (a substring of the trace's name)."""
    evs = []
    for name, stream, a, b in _device_events(prof):
        a, b = max(a, t0_ns), min(b, t1_ns)
        if b > a:
            evs.append((name, stream, a, b))
    vo_streams = {s for n, s, _, _ in evs if vo_kernel in n}
    by_stream = defaultdict(int)
    by_name = defaultdict(int)
    for name, stream, a, b in evs:
        by_stream[stream] += b - a
        by_name[name] += b - a
    merged = _union([(a, b) for _, _, a, b in evs])
    busy = sum(b - a for a, b in merged)
    gaps = []
    edges = [t0_ns] + [x for iv in merged for x in iv] + [t1_ns]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((a, b))
    spans = _spans(prof)

    def label(a, b):
        mid = (a + b) // 2
        inside = [(e - s, n) for n, s, e in spans if s <= mid <= e]
        return min(inside)[1] if inside else "host"

    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    return {
        "window_s": (t1_ns - t0_ns) / 1e9,
        "busy_s": busy / 1e9,
        "vo_busy_s": sum(v for s, v in by_stream.items() if s in vo_streams) / 1e9,
        "map_busy_s": sum(v for s, v in by_stream.items() if s not in vo_streams) / 1e9,
        "vo_streams": sorted(vo_streams),
        "streams": {str(s): v / 1e9 for s, v in by_stream.items()},
        "kernel_s_on_vo": {k: sum(b - a for n, s, a, b in evs
                                  if s in vo_streams and k in n) / 1e9 for k in kernels},
        "device_ops": sorted(((n, v / 1e9) for n, v in by_name.items()),
                             key=lambda x: x[1], reverse=True)[:10],
        "idle_gaps": [(label(a, b), (b - a) / 1e9) for a, b in gaps[:10]],
        "events": len(evs),
    }
