"""Run one cell of the benchmark of plslam_tpu_torch on the card and print
its result as the last line of standard output.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the repository's root.  Set-up renders one lap of the cell's route on
the card from the seed, holds it as uint8 pairs in pinned host memory,
builds ``PLSLAM`` from the cell's configuration and feeds it frames until
its programs are captured; then the window runs for ``--seconds``:

- ``offline`` (closed loop): the next pair goes in when ``process``
  returns; at the end of the window ``wait_until_idle`` drains the mapper,
  inside the time;
- ``live`` (open loop): frame i is due at ``t0 + i / rate``; its latency
  runs from the due time to the return of ``process``.

After the window, the answers (the pose, tracking flag and keyframe flag
of every call, the mapper's keyframes and points) are judged against the scene's ground
truth (``reference/check.py``).  ``--trace 1`` profiles a slice of the
window and reports the per-layer metrics instead of the end-to-end ones.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "plslam_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole (``plslam_tpu_torch`` is not
    ``plslam_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def say(msg: str) -> None:
    print(f"# [{time.time() - T_START:7.2f}s] {msg}", file=sys.stderr, flush=True)


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.mem",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


class Shapes:
    """Records the input shapes of the hand-written kernels' launches made
    while a CUDA graph is captured on this thread (the VO step's capture):
    one frame's launches."""

    def __init__(self):
        self.launches = []

    def __call__(self, wrapper, args, kwargs):
        import torch

        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            self.launches.append((wrapper.__name__, tuple(
                tuple(a.shape) if isinstance(a, torch.Tensor) else a for a in args)))
        return wrapper.__wrapped__(*args, **kwargs)


def build_slam(cell, device, capture: bool):
    from plslam_tpu_torch.config import PLSLAMConfig
    from plslam_tpu_torch.core.camera import StereoCamera
    from plslam_tpu_torch.pipeline import PLSLAM

    c = cell.config["camera"]
    cam = StereoCamera.create(c["fx"], c["fy"], c["cx"], c["cy"], c["baseline"],
                              width=c["width"], height=c["height"])
    known = set(PLSLAMConfig.__dataclass_fields__)
    unknown = set(cell.config["plslam"]) - known
    if unknown:
        raise ValueError(f"config keys PLSLAMConfig lacks: {sorted(unknown)}")
    return PLSLAM(cam, PLSLAMConfig(**cell.config["plslam"]), device=device,
                  capture=capture)


def total_captures() -> int:
    """CUDA-graph captures of every program of the process so far."""
    from plslam_tpu_torch import graphs

    return int(graphs.stats()["captures"])


class Feed:
    """The lap's pairs in pinned host memory, by stream index (the lap
    wraps)."""

    def __init__(self, frames_dev):
        import torch

        pin = torch.cuda.is_available() and frames_dev.device.type == "cuda"
        self.host = torch.empty(frames_dev.shape, dtype=torch.uint8, pin_memory=pin)
        self.host.copy_(frames_dev)
        self.n = frames_dev.shape[0]

    def __call__(self, i: int):
        f = self.host[i % self.n]
        return f[0], f[1]


def run_cell(cell, seed: int, seconds: float, trace: bool, device, *, slam_factory=None,
             capture: bool = True) -> dict:
    """Set-up, window, drain and check of one run; returns the result line's
    object.  ``slam_factory(cell, device, capture)`` builds the system
    under test (``build_slam`` unless a test passes another)."""
    import numpy as np
    import torch

    from . import manifest, scene, stats, work
    from .reference import check

    on_card = device.type == "cuda"
    spec = cell.spec
    cam = scene.Camera.from_config(cell.config)
    t = time.time()
    lap = scene.render_lap(cam, cell.traffic, seed, device)
    if on_card:
        torch.cuda.synchronize()
    pts, lines = scene.in_view(lap.poses, lap.marks, cam)
    say(f"rendered {lap.frames.shape[0]} pairs {cam.width}x{cam.height} in "
        f"{time.time() - t:.3f} s; in view: {pts:.1f} points, {lines:.1f} lines a frame")
    feed = Feed(lap.frames)
    truth = {"poses": lap.poses}
    del lap

    slam = (slam_factory or build_slam)(cell, device, capture)
    from plslam_tpu_torch.ops import cuda_lib

    shapes = Shapes()
    results, is_kf, good, t_call, t_ret, due = [], [], [], [], [], []
    stream = 0

    def call(when=None):
        nonlocal stream
        a = time.perf_counter()
        res = slam.process(*feed(stream))
        b = time.perf_counter()
        if res is None:  # the first frame starts the map
            results.append(None)
            is_kf.append(True)
            good.append(True)
        else:
            results.append(res.T_f_w)
            log = slam.logs[-1]
            is_kf.append(log.is_kf)
            good.append(log.good)
        t_call.append(a)
        t_ret.append(b)
        due.append(when)
        stream += 1

    with cuda_lib.observing(shapes):
        call()
    warm = spec["warmup"]
    last_cap, quiet_from = total_captures(), len(is_kf)
    while True:
        call()
        n = len(is_kf)
        if n % 10 == 0:
            cap = total_captures()
            if cap != last_cap:
                last_cap, quiet_from = cap, n
            kfs_quiet = sum(is_kf[quiet_from:])
            if n >= warm["min_frames"] and kfs_quiet >= warm["quiet_keyframes"]:
                break
            if n >= warm["max_frames"]:
                say(f"warm-up stopped at {n} frames with captures still coming")
                break
    slam.wait_until_idle()
    if on_card:
        torch.cuda.synchronize()
    caps_before = total_captures()
    n_warm = len(is_kf)
    say(f"warm-up: {n_warm} frames, {sum(is_kf)} keyframes, {caps_before} captures; "
        f"{len(shapes.launches)} kernel launches in the VO step")
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        with profile(activities=acts):  # the profiler's own start-up, out of the window
            torch.zeros(1, device=device).add_(1)
        prof = profile(activities=acts)
    gc.collect()

    loop = cell.loop
    tr = spec["trace"]
    slice_n = tr["frames"]
    if loop == "live":
        # the last frames: the profiler's stop, which reduces the trace,
        # then stalls no frame of the window
        period = 1.0 / float(cell.traffic["rate_hz"])
        n_due = int(round(seconds / period))
        slice_at = max(0, n_due - slice_n)
    else:
        slice_at = tr["skip_frames"]
    slice_t = [None, None]
    slice_kf = [0, 0]
    t0 = time.perf_counter()
    setup_s = time.time() - T_START
    k = 0

    def traced_call(when=None):
        nonlocal k
        if prof is not None and k == slice_at:
            prof.start()
            slice_kf[0] = len(slam.mapper.map.keyframes)
            slice_t[0] = time.time_ns()
        if prof is not None:
            from torch.profiler import record_function

            with record_function("bench.process"):
                call(when)
        else:
            call(when)
        k += 1
        if prof is not None and k == slice_at + slice_n:
            slice_t[1] = time.time_ns()
            slice_kf[1] = len(slam.mapper.map.keyframes)
            prof.stop()

    if loop == "offline":
        while time.perf_counter() - t0 < seconds:
            traced_call()
        slam.wait_until_idle()
        t_end = time.perf_counter()
    elif loop == "live":
        for i in range(n_due):
            when = t0 + i * period
            wait = when - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            traced_call(when)
        t_end = time.perf_counter()
        slam.wait_until_idle()
    else:
        raise ValueError(f"unknown loop {loop!r}")
    if prof is not None and slice_t[1] is None:
        slice_t[1] = time.time_ns()
        slice_kf[1] = len(slam.mapper.map.keyframes)
        prof.stop()
    window_s = t_end - t0
    caps_window = total_captures() - caps_before
    n_win = len(is_kf) - n_warm
    mem_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    say(f"window: {n_win} frames in {window_s:.3f} s, {sum(is_kf[n_warm:])} keyframes, "
        f"{caps_window} captures; mapper holds {len(slam.mapper.map.keyframes)} keyframes")

    # the answers, then the system is stopped and freed before the check
    mp = slam.mapper.map
    kf_poses = np.stack([kf.T_w_k for kf in mp.keyframes])
    kf_submitted = np.stack([getattr(kf, "T_vo", kf.T_w_k) for kf in mp.keyframes])
    poses = np.stack([np.eye(4) if r is None else r.double().cpu().numpy() for r in results])
    out = {"frames": np.arange(len(is_kf)), "poses": poses, "is_kf": np.asarray(is_kf),
           "good": np.asarray(good), "kf_poses": kf_poses, "kf_submitted": kf_submitted,
           "points_nobs": mp.pt_nobs[mp.pt_valid].copy()}
    no_pose = sum(r is None for r in results[n_warm:])
    graph_kinds = slam.mapper.graph_stats()
    slam.finish(run_gba=False)
    del slam, results, feed
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t = time.time()
    read = check.readings(out, truth, window_from=n_warm)
    correct, checks = check.judge(read, spec["check"]["limits"])
    say("readings: " + ", ".join(f"{k} {v!r}" for k, v in read.items()))
    say(f"check in {time.time() - t:.3f} s over {n_win} frames, "
        f"{len(kf_poses)} keyframes, {len(out['points_nobs'])} map points")

    rec = {"t_call": t_call[n_warm:], "t_ret": t_ret[n_warm:], "due": due[n_warm:],
           "is_kf": is_kf[n_warm:]}
    lateness = [a - d for a, d, prev in zip(rec["t_call"], rec["due"],
                                            [None] + rec["t_ret"][:-1])
                if d is not None and (prev is None or prev <= d)]
    if lateness:
        say(f"generator lateness on idle sends: p50 {1e3 * stats.percentile(lateness, 50):.3f} "
            f"ms, max {1e3 * max(lateness):.3f} ms over {len(lateness)} sends")
    # an operation is one ``process`` call, and it fails where it gives no
    # pose to use: none, or one that is not finite.  A frame the tracker
    # declares lost is an answer (the last pose kept, as upstream PL-SLAM
    # keeps it); ``correct`` holds their share (``frame_fail_pct``)
    answered = np.isfinite(out["poses"][n_warm:]).all(axis=(1, 2))  # None reads eye(4)
    result = {"correct": correct, "attempted": n_win,
              "failed": int(n_win - answered.sum()) + no_pose}
    say(f"frames declared lost (answers, held by frame_fail_pct): "
        f"{int(sum(not g for g in good[n_warm:]))} of {n_win}")
    if not trace:
        values = {"setup_s": setup_s}
        if loop == "offline":
            values["slam_frames_per_s"] = stats.rate(n_win, window_s)
        else:
            lat = stats.latencies_ms(rec["due"], rec["t_ret"])
            values["track_latency_p50_ms"] = stats.percentile(lat, 50)
            values["track_latency_p95_ms"] = stats.percentile(lat, 95)
            say(f"latency over {len(lat)} frames: p50 {values['track_latency_p50_ms']:.3f}, "
                f"p95 {values['track_latency_p95_ms']:.3f}, max {max(lat):.3f} ms")
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in values}
    else:
        red = None
        if prof is not None and on_card:
            from . import trace as trace_mod

            red = trace_mod.reduce(prof, slice_t[0], slice_t[1],
                                   work.KERNELS["fast_score_nms_batch"],
                                   tuple(work.KERNELS.values()))
        frames_in_slice = min(slice_n, max(0, n_win - slice_at))
        ctx = {"loop": loop, "frames": rec, "slice": (slice_at, slice_at + slice_n),
               "slice_frames": frames_in_slice, "slice_keyframes": slice_kf[1] - slice_kf[0],
               "captures_in_window": caps_window, "trace": red,
               "kernel_launches": shapes.launches,
               "card": torch.cuda.get_device_name(device) if on_card else None}
        metrics = {}
        for m in cell.per_layer:
            v = manifest.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        prof = None
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": int(mem_peak)}
    if trace:
        device_info["busy_s"] = red["busy_s"] if red else 0.0
        device_info["window_s"] = red["window_s"] if red else 0.0
        if red:
            result_breakdown = {"device_ops": [list(x) for x in red["device_ops"]],
                                "idle_gaps": [list(x) for x in red["idle_gaps"]]}
            say(f"trace: {red['events']} device events, streams {red['streams']}, "
                f"VO streams {red['vo_streams']}, {ctx['slice_frames']} frames, "
                f"{ctx['slice_keyframes']} keyframes in the slice")
    result["metrics"] = metrics
    result["device"] = device_info
    if trace and red:
        result["breakdown"] = result_breakdown
    say(f"mapper programs: {json.dumps(graph_kinds)}")
    result["readings"] = {k: _finite(v) for k, v in read.items()}
    result["checks"] = {k: {"value": _finite(c["value"]), "limit": c["limit"]}
                        for k, c in checks.items()}
    return result


def _finite(v: float):
    """A reading as JSON can carry it: one that could not be taken (no
    pairs, NaN) is null, and its check has failed."""
    return v if v == v and abs(v) != float("inf") else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one cell of the plslam_tpu_torch benchmark")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from . import manifest

    man = manifest.Manifest(Path.cwd())
    cell = man.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    try:
        import plslam_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the system under test is missing: {e}", file=sys.stderr)
        return 4
    device = torch.device("cuda", 0)
    say(f"card: {card_line()}")
    say(f"cell {cell.name}: {cell.config['name']} x {args.workload}, seed {args.seed}, "
        f"{args.seconds} s, trace {args.trace}")
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), device)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded in this process: {bad}", file=sys.stderr)
        return 5
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
