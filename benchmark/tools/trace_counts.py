"""``trace_cell.py`` with the plain counters' increase over the window
added to its ``formulas`` (``formulas.counts``: ``pipeline.keyframes``,
``vo.gn_trips_used``, ``pipeline.upload.on_card_cast``, ... per thread),
and, with ``--trace 1``, each program span's host time in the traced
slice by thread (``labels.span_ms``: ``{"tracker"|"mapper"|"other":
{span: [ms, count]}}``, a span's own time with the spans inside it).
A measurement aid: no benchmark run calls it, and nothing of the benchmark
imports it.  It takes ``trace_cell.py``'s arguments, and works with
``--trace 0`` as with ``--trace 1`` (the counters are read at the drains
before and after the window either way):

    python3 benchmark/tools/trace_counts.py [trace_cell options]
        --out F.json -- <benchmark.run arguments>

Run it from the root of the checkout under test.  It imports no JAX.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import trace_cell  # noqa: E402

_formulas = trace_cell.formulas


def formulas(c0, c1):
    res = _formulas(c0, c1)
    from plslam_tpu_torch.utils.profiling import added

    res["counts"] = added(c0, c1)
    return res


_gaps_by_span = trace_cell.gaps_by_span


def span_ms(prof, t0, t1):
    """Host ms and count of each program span that starts in [t0, t1], by
    the thread that ran it (the tracker counts ``pipeline.process`` or
    ``bench.process``, the mapper ``mapper.*``)."""
    import torch

    cpu = torch.autograd.DeviceType.CPU
    rows, names = [], {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() != cpu or name.split(".")[0] not in trace_cell.LAYERS + ("bench",):
            continue
        th = e.start_thread_id()
        names.setdefault(th, set()).add(name)
        if t0 <= e.start_ns() <= t1:
            rows.append((th, name, e.duration_ns()))

    def role(th):
        if names[th] & {"pipeline.process", "bench.process"}:
            return "tracker"
        return "mapper" if any(n.startswith("mapper.") for n in names[th]) else "other"

    out = {}
    for th, name, ns in rows:
        ms_n = out.setdefault(role(th), {}).setdefault(name, [0.0, 0])
        ms_n[0] += ns / 1e6
        ms_n[1] += 1
    return out


def gaps_by_span(prof, t0, t1, n=10):
    res = _gaps_by_span(prof, t0, t1, n)
    res["span_ms"] = span_ms(prof, t0, t1)
    return res


trace_cell.formulas = formulas
trace_cell.gaps_by_span = gaps_by_span

if __name__ == "__main__":
    sys.exit(trace_cell.main(sys.argv[1:]))
