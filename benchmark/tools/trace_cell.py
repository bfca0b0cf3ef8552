"""One benchmark cell run through ``benchmark.run.main``, with readings
taken around it that the result line does not carry.  It is a measurement
aid: no benchmark run calls it, and nothing of the benchmark imports it.

    python3 benchmark/tools/trace_cell.py [--all-threads 0|1]
        [--switch-interval S] [--upload cast-first|copy-first]
        --out F.json -- <benchmark.run arguments>

Run it from the root of the checkout under test, with ``--trace 1`` among
the benchmark's arguments.  It writes F.json and prints its summary on
stderr (``EXTRA`` and ``LABELS`` lines):

- ``--all-threads 1`` builds the traced slice's profiler with
  ``_ExperimentalConfig(profile_all_threads=True)``, so the spans of the
  mapping thread, started before the profiler, are in the trace;
- ``--switch-interval S`` sets ``sys.setswitchinterval(S)`` first (the
  interpreter's thread switch interval, 0.005 s by default);
- ``--upload`` times the two parts of ``PLSLAM._image`` apart, as the
  timed blocks ``pipeline.upload.cast`` and ``pipeline.upload.copy``:
  ``cast-first`` is what ``torch.as_tensor(img, dtype=float32,
  device=cuda)`` does with a host image (the cast on the host, then a
  blocking copy of the float image), ``copy-first`` copies the uint8
  image and casts on the card (the same values);
- ``formulas``: the program's counters (``utils/profiling.counters()``,
  where the checkout has them) at the window's start (the drain after the
  warm-up) and end (the drain after the window), read by the formulas of
  the per-layer metrics ``pipeline.host_ms_per_frame``,
  ``pipeline.kf_queue_wait_ms_per_kf``, ``vo.gn_trips_used_pct``,
  ``mapping.host_ms_per_kf`` and ``graphs.capture_ms_in_window``, with
  the ms a call of every timed block of the tracking and mapping threads;
  the tracking thread is the one that counted ``pipeline.process``, the
  mapping thread the one that counted ``mapper.keyframe``;
- ``host_clock_process_mean_ms``: ``run.py``'s own host clock around the
  window's ``process`` calls, for the cross-check with the counters;
- ``labels``: the traced slice's ten longest device-idle gaps, each
  labelled by the innermost program span at its midpoint on the tracking
  thread, then ``|`` and the mapping thread's innermost span where it has
  one (``bench.process`` or ``host`` where no program span covers it).

It imports no JAX, and runs against a checkout without the program's
counters too (``formulas`` then stays out).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())

LAYERS = ("pipeline", "vo", "mapper", "graphs", "host", "io")


def parse(argv):
    sep = argv.index("--")
    opts, bench_args = argv[:sep], argv[sep + 1:]

    def opt(name, default):
        return opts[opts.index(name) + 1] if name in opts else default

    return (opt("--all-threads", "1") == "1", opt("--switch-interval", None),
            opt("--upload", None), opt("--out", None), bench_args)


def split_upload(slam, order):
    """``slam._image`` in two timed parts, in the order named."""
    import torch

    from plslam_tpu_torch.utils.profiling import timed

    def image(img):
        host = torch.as_tensor(img)
        if order == "cast-first":
            with timed("pipeline.upload.cast"):
                host = host.to(torch.float32)
            with timed("pipeline.upload.copy"):
                return host.to(slam.device)
        with timed("pipeline.upload.copy"):
            dev = host.to(slam.device)
        with timed("pipeline.upload.cast"):
            return dev.to(torch.float32)

    slam._image = image


def gaps_by_span(prof, t0, t1, n=10):
    """The ``n`` longest gaps between the union of device events in
    [t0, t1], each ``[label, seconds]``."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    host, by_thread, dev = [], {}, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda:
            if e.is_user_annotation() or name.startswith("bench."):
                continue
            s = e.start_ns()
            a, b = max(s, t0), min(s + e.duration_ns(), t1)
            if b > a:
                dev.append((a, b))
        elif name.split(".")[0] in LAYERS + ("bench",):
            s = e.start_ns()
            host.append((name, s, s + e.duration_ns(), e.start_thread_id()))
            by_thread.setdefault(e.start_thread_id(), set()).add(name)
    tracker = {t for t, names in by_thread.items()
               if "pipeline.process" in names or "bench.process" in names}
    mapper = {t for t, names in by_thread.items()
              if t not in tracker and any(x.startswith("mapper.") for x in names)}
    merged = []
    for a, b in sorted(dev):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    edges = [t0] + [x for iv in merged for x in iv] + [t1]
    gaps = sorted(((a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a),
                  key=lambda g: g[0] - g[1])[:n]

    def inner(mid, threads, program_only):
        inside = [(e - s, name) for name, s, e, th in host if th in threads and s <= mid <= e
                  and not (program_only and name.startswith("bench."))]
        return min(inside)[1] if inside else None

    out = []
    for a, b in gaps:
        mid = (a + b) // 2
        lab = inner(mid, tracker, True) or inner(mid, tracker, False) or "host"
        m = inner(mid, mapper, True)
        out.append([(lab + ("|" + m if m else ""))[:64], (b - a) / 1e9])
    spans = {}
    for name, _, _, _ in host:
        spans[name] = spans.get(name, 0) + 1
    return {"gaps": out, "span_counts": spans}


def formulas(c0, c1):
    """The per-layer metrics' formulas over the counters' difference."""
    from plslam_tpu_torch.utils.profiling import per_call_ms

    def d(th, k):
        return c1.get(th, {}).get(k, 0) - c0.get(th, {}).get(k, 0)

    res = {}
    rows = per_call_ms(c0, c1)
    trk = [t for t in c1 if d(t, "pipeline.process.calls") > 0]
    mp = [t for t in c1 if d(t, "mapper.keyframe.calls") > 0]
    if trk:
        t = trk[0]
        calls = d(t, "pipeline.process.calls")
        kf = d(t, "pipeline.keyframes")
        res.update({
            "pipeline.process.calls": calls,
            "pipeline.process.mean_ms": d(t, "pipeline.process.ns") / calls / 1e6,
            "pipeline.host_ms_per_frame": (
                d(t, "pipeline.process.ns") - d(t, "pipeline.scalars.wait.ns")
                - d(t, "pipeline.kf_queue.wait.ns") - d(t, "graphs.capture.ns")) / calls / 1e6,
            "pipeline.keyframes": kf,
            "pipeline.kf_queue_wait_ms_per_kf": d(t, "pipeline.kf_queue.wait.ns") / max(kf, 1) / 1e6,
            "vo.gn_trips_used": d(t, "vo.gn_trips_used"),
            "vo.gn_trips_unrolled": d(t, "vo.gn_trips_unrolled"),
            "vo.gn_trips_used_pct": (100.0 * d(t, "vo.gn_trips_used")
                                     / max(d(t, "vo.gn_trips_unrolled"), 1)),
            "tracker_ms_calls": rows.get(t, {})})
    if mp:
        m = mp[0]
        calls = d(m, "mapper.keyframe.calls")
        res.update({
            "mapper.keyframe.calls": calls,
            "mapper.keyframe.mean_ms": d(m, "mapper.keyframe.ns") / calls / 1e6,
            "mapping.host_ms_per_kf": (
                d(m, "mapper.keyframe.ns") - d(m, "mapper.fetch.wait.ns")
                - d(m, "graphs.staged.wait.ns") - d(m, "graphs.capture.ns")) / calls / 1e6,
            "mapper_ms_calls": rows.get(m, {})})
    res["graphs.capture_ms_in_window"] = sum(d(t, "graphs.capture.ns") for t in c1) / 1e6
    return res


def main(argv):
    all_threads, switch, upload, out_path, bench_args = parse(argv)
    if upload not in (None, "cast-first", "copy-first"):
        raise SystemExit(f"--upload: cast-first or copy-first, not {upload!r}")
    if switch is not None:
        sys.setswitchinterval(float(switch))

    import torch.profiler as tp

    import benchmark.manifest as manifest
    import benchmark.run as run
    import benchmark.trace as trace

    try:
        from plslam_tpu_torch.utils.profiling import counters
    except ImportError:
        counters = None

    extra = {"all_threads": all_threads, "switch_interval": sys.getswitchinterval(),
             "upload": upload, "package": os.getcwd()}
    snaps, seen = [], {}
    profile = tp.profile

    def all_threads_profile(*a, **k):
        if all_threads:
            from torch._C._profiler import _ExperimentalConfig

            k["experimental_config"] = _ExperimentalConfig(profile_all_threads=True)
        return profile(*a, **k)

    class Watched:
        """The system under test, with a counters snapshot at each drain."""

        def __init__(self, slam):
            self._slam = slam
            if upload:
                split_upload(slam, upload)

        def __getattr__(self, name):
            return getattr(self._slam, name)

        def wait_until_idle(self):
            self._slam.wait_until_idle()
            if counters is not None:
                snaps.append(counters())

    build, reader, reduce = run.build_slam, manifest.reader, trace.reduce

    def watched_reader(name, *a, **k):
        fn = reader(name, *a, **k)

        def read(ctx):
            seen.setdefault("ctx", ctx)
            return fn(ctx)
        return read

    def labelling_reduce(prof, t0, t1, *a, **k):
        red = reduce(prof, t0, t1, *a, **k)
        try:
            extra["labels"] = gaps_by_span(prof, t0, t1)
        except Exception as e:  # noqa: BLE001  (the reading is an aid; the run goes on)
            extra["labels_error"] = repr(e)
        return red

    tp.profile = all_threads_profile
    run.build_slam = lambda cell, device, capture: Watched(build(cell, device, capture))
    manifest.reader = watched_reader
    trace.reduce = labelling_reduce
    t = time.time()
    rc = run.main(bench_args)
    extra["run_s"] = time.time() - t
    if len(snaps) >= 2:
        extra["formulas"] = formulas(snaps[0], snaps[-1])
    ctx = seen.get("ctx")
    if ctx is not None:
        rec = ctx["frames"]
        ms = [1e3 * (r - c) for c, r in zip(rec["t_call"], rec["t_ret"])]
        extra["host_clock_process_mean_ms"] = sum(ms) / len(ms)
        extra["host_clock_frames"] = len(ms)
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(extra, f, indent=1, default=str)
    print("EXTRA " + json.dumps({k: v for k, v in extra.items() if k != "labels"}, default=str),
          file=sys.stderr)
    if "labels" in extra:
        print("LABELS " + json.dumps(extra["labels"]["gaps"]), file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
