"""Speed-of-light table of the per-frame programs and the local BA on one
GPU (the twin of ``scripts/roofline.py``).

    python -m plslam_tpu_torch.roofline [--device cuda|cpu] [--n N] [--scale S]

For each of the three per-frame VO programs (point detect+describe, line
detect+LBD, stereo match + f2f + GN track) and ``lm_rounds`` (10 LM trips
at K=8, P=512, L=64, f32), each a ``graphs.Program`` over static buffers,
it prints:

  - ms per call: N replays on distinct inputs (the stack of the frame
    plus 0.01 i, as the JAX script), each after the copy of its input into
    the program's static buffers, between two CUDA events, over N (the
    counterpart of the JAX script's ``forced_time``); beside it the
    device-busy ms and the device kernels per call of the same N calls
    under ``torch.profiler``;
  - the work of one ``capture=False`` call, counted by ``WorkCounter``
    (a ``TorchDispatchMode``): FLOPs of mm/bmm/addmm/baddbmm/convolution by
    ``torch.utils.flop_counter``'s formulas, one per output element of
    every other aten op, and the four hand-written kernels' work by the
    formulas below (the FAST kernel's on its inputs' data, the GN solve's
    with every trip unrolled); bytes
    *unfused* (every op's inputs and outputs: an upper bound on the
    traffic) and *program* (the program's inputs and outputs once: a lower
    bound).  XLA's ``cost_analysis``, which the JAX script reads, counts
    the TPU package's workarounds (one-hot-matmul patches, banded blur),
    which the port does not run;
  - GFLOP/s, GB/s for both byte figures, % of the card's peaks and the
    bound (``bound``: the larger of program bytes over the memory rate and
    the operations over their rates);
then the per-frame total of the three VO programs and its frames/s
ceiling.  Peaks come from ``PEAKS``, keyed by ``torch.cuda.get_device_name``;
an unknown card is an error.  ``--device cpu`` prints the counts and host
times with the plain kernels (no peaks, no profiler).  ``--scale`` scales
the image, the feature widths and the BA's points and lines (the CPU
tests run 0.25).

The published peaks and the kernels' work formulas live here for
chip_smoke.py's phase 3 too (one copy).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, NamedTuple

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from . import graphs
from .backend import ba
from .bench import camera, card, resolve_device, scaled
from .bench_slam import BA_SIZE, LBA_CAM, LM_ITERS, local_ba_problem
from .core.camera import StereoCamera
from .frontend.frame import (FrontendConfig, _detect_describe_lines_batch,
                             _detect_describe_points_batch)
from .frontend.tracker import TrackerConfig
from .io.synthetic import SyntheticScene, circular_trajectory
from .ops import cuda_lib
from .profile_vo import profile_window
from .vo import VisualOdometry, match_and_track

N = 24

# Published peaks of each card this runs on, by ``torch.cuda.get_device_name``
# (NVIDIA's data sheet; the H100 SXM at its 700 W limit): device memory
# bytes/s, float32 operations/s outside the tensor cores (an FMA counts
# two) and dense int8 tensor-core operations/s.
PEAKS = {"NVIDIA H100 80GB HBM3": {"hbm": 3.35e12, "f32": 67e12, "int8": 1979e12}}
H100 = PEAKS["NVIDIA H100 80GB HBM3"]
HBM_BYTES_PER_S = H100["hbm"]
INT8_OPS_PER_S = H100["int8"]
F32_OPS_PER_S = H100["f32"]
# The float32 peak counts an FMA as two operations at 128 per clock per SM;
# an add issues at that rate, min, max and compare at 64 per clock per SM
# (the CUDA C++ guide's throughput table for compute capability 9.0).
F32_ADD_PER_S = F32_OPS_PER_S / 2
F32_MINMAX_PER_S = F32_OPS_PER_S / 4
# FAST + NMS float32 operations (csrc/fast.cu): every pixel pays the
# compass test (4 differences, 8 compares) and the 3x3 NMS (9 max, 2
# compares); a pixel that passes the compass test pays 12 more ring
# differences, 2 x 57 min/max for the bright and dark window folds, bright
# vs dark, and the threshold (compare + select).
FAST_PX_OPS = (4, 8 + 11)
FAST_CANDIDATE_OPS = (12, 2 * 57 + 1 + 2)


def peaks(kind: str) -> dict:
    """The card's peaks as operations/s by type ("f32", "f32_add",
    "f32_minmax", "int8") and "hbm" bytes/s; an unknown card raises."""
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for {kind!r}: add them to roofline.PEAKS")
    p = PEAKS[kind]
    return {"hbm": p["hbm"], "f32": p["f32"], "f32_add": p["f32"] / 2,
            "f32_minmax": p["f32"] / 4, "int8": p["int8"]}


def bound(nbytes: float, *ops: tuple[float, float]) -> tuple[float, str]:
    """Least time (ms) the card could take: the larger of the bytes over the
    memory rate and the operations, (count, peak rate for their type) pairs,
    each over its rate."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * sum(n / rate for n, rate in ops)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fast_op_counts(imgs: torch.Tensor, thr: torch.Tensor) -> tuple[int, int]:
    """FAST + NMS's float32 adds and min/max operations on these images:
    the compass test of csrc/fast.cu's first pass, in plain torch, counts
    the pixels that go on to the window folds (zero outside the image, as
    the kernel pads)."""
    c = torch.nn.functional.pad(imgs, (3, 3, 3, 3))
    H, W = imgs.shape[1:]
    ctr = c[:, 3:3 + H, 3:3 + W]
    e0, e8 = c[:, 0:H, 3:3 + W] - ctr, c[:, 6:6 + H, 3:3 + W] - ctr
    e4, e12 = c[:, 3:3 + H, 6:6 + W] - ctr, c[:, 3:3 + H, 0:W] - ctr
    th = thr[:, None, None]
    bright = ((e0 > th) | (e8 > th)) & ((e4 > th) | (e12 > th))
    dark = ((e0 < -th) | (e8 < -th)) & ((e4 < -th) | (e12 < -th))
    n_px, n_cand = imgs.numel(), int((bright | dark).sum())
    return (FAST_PX_OPS[0] * n_px + FAST_CANDIDATE_OPS[0] * n_cand,
            FAST_PX_OPS[1] * n_px + FAST_CANDIDATE_OPS[1] * n_cand)


def fast_ops(imgs: torch.Tensor, thr: torch.Tensor) -> tuple[tuple[float, float], ...]:
    """``fast_op_counts`` as (count, H100 rate) pairs for ``bound``."""
    adds, minmax = fast_op_counts(imgs, thr)
    return (adds, F32_ADD_PER_S), (minmax, F32_MINMAX_PER_S)


def fast_bytes(imgs: torch.Tensor, thr: torch.Tensor) -> int:
    """FAST + NMS: the f32 images read once, raw and NMS maps written once,
    the thresholds read."""
    return 12 * imgs.numel() + 4 * thr.numel()


def patches_bytes(imgs: torch.Tensor, y0: torch.Tensor, patch: int) -> int:
    """Patch gather: the f32 images and int32 corners read once, the f32
    patches written once."""
    return imgs.numel() * 4 + 2 * y0.numel() * 4 + y0.numel() * patch * patch * 4


def hamming_work(d1: torch.Tensor, d2: torch.Tensor) -> tuple[int, float]:
    """Hamming matrix ([B,] N1, 8) x ([B,] N2, 8): (bytes: the words read
    once, the int32 matrix written once; 1-bit tensor-core operations,
    counted at the int8 rate: 2 per bit pair)."""
    B = d1.shape[0] if d1.dim() == 3 else 1
    n1, n2 = d1.shape[-2], d2.shape[-2]
    return B * ((n1 + n2) * 32 + n1 * n2 * 4), 2.0 * B * n1 * n2 * 256


# The GN solve's float32 operations (csrc/gauss_newton.cu, which contracts
# no multiply-add: a product, a sum, a division and a square root count one
# each), per row and normal-equation build: the residual pass, the MAD
# passes' |r - med| and the Gram pass (residual, Jacobian, weight, the 28
# sums); points, Pluecker lines, endpoint lines; and the one thread's
# Cholesky, solve and exp(-step) @ DT per build.
GN_ROW_OPS = {"point": 30 + 8 + 130, "plucker": 69 + 8 + 275, "endpoint": 60 + 8 + 234}
GN_SOLVE_OPS = 400


def gn_work(n_points: int, n_lines: int, *, batch: int = 1, max_iters: int,
            use_points: bool = True, use_lines: bool = True,
            plucker: bool = True) -> tuple[int, float]:
    """GN solve of ``batch`` problems (``csrc/gauss_newton.cu``): (bytes:
    the inputs read once, every used point's P, obs, sigma2 and masks and
    every line's 21 floats and masks, and the outputs written once;
    float32 operations of every trip unrolled, ``max_iters`` + the final
    build, counted at the add rate: a floor, since a division or square
    root takes several issue slots)."""
    n_p = n_points if use_points else 0
    n_l = n_lines if use_lines else 0
    nbytes = 64 + n_p * (4 * 6 + 2) + n_l * (4 * 22 + 2) + 64 + 144 + 4 + 1 + max_iters
    row = GN_ROW_OPS["point"] * n_p + GN_ROW_OPS["plucker" if plucker else "endpoint"] * n_l
    return batch * nbytes, float(batch * (max_iters + 1) * (row + GN_SOLVE_OPS))


def _kernel_work(name: str, args: tuple) -> tuple[int, dict]:
    """(bytes, operations by type) of one call of a hand-written kernel's
    wrapper, by the formulas above."""
    if name == "gather_patches_batch":
        imgs, y0, _, patch = args
        return patches_bytes(imgs, y0, patch), {}
    if name == "fast_score_nms_batch":
        imgs, thr = args
        adds, minmax = fast_op_counts(imgs, thr)
        return fast_bytes(imgs, thr), {"f32_add": adds, "f32_minmax": minmax}
    if name == "hamming_distance_matrix_cuda":
        nbytes, ops = hamming_work(*args)
        return nbytes, {"int8": ops}
    raise KeyError(f"no work formula for kernel {name}")


def _nbytes(t) -> int:
    """Bytes of a tensor's distinct elements (a broadcast axis, stride 0,
    holds one)."""
    if not isinstance(t, torch.Tensor):
        return 0
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        n *= size if stride != 0 else 1
    return n * t.element_size() if t.numel() else 0


def tree_bytes(tree) -> int:
    return sum(_nbytes(x) for x in pytree.tree_leaves(tree))


# allocations, and ``_unsafe_view`` (a view its schema does not mark as one)
_NO_WORK = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
            "_unsafe_view"}


def _moves_nothing(func) -> bool:
    """A view (its output aliases an input without writing it) or an
    allocation."""
    if func.overloadpacket.__name__ in _NO_WORK:
        return True
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


class WorkCounter(TorchDispatchMode):
    """Counts the work of the aten ops run under it: ``ops`` by type
    ("f32" for the aten ops: FLOPs of the matrix products and convolutions
    by ``torch.utils.flop_counter``, one per output element of any other
    op; the kernels' own types), ``unfused_bytes`` (every op's inputs and
    outputs) and, per hand-written kernel, its calls, bytes and operations.
    The kernels' wrappers are timed by ``cuda_lib.observing``: a call is
    counted by its formula, and the ops it runs inside (the plain twin on
    the CPU) are not.  The ``plslam::`` operators: the Hamming matrix is
    counted through its wrapper, the GN solve (``plslam::gauss_newton``,
    whose wrapper the hook never sees) here by ``gn_work``."""

    def __init__(self):
        super().__init__()
        self.ops: dict[str, float] = {"f32": 0.0}
        self.unfused_bytes = 0
        self.kernels: dict[str, dict] = {}
        self._in_kernel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.overloadpacket is torch.ops.plslam.gauss_newton:
            return self._gauss_newton(func, args, kwargs)
        out = func(*args, **kwargs)
        if self._in_kernel or func.namespace == "plslam" or _moves_nothing(func):
            return out
        ins = pytree.tree_leaves((args, kwargs))
        outs = [x for x in pytree.tree_leaves(out) if isinstance(x, torch.Tensor)]
        packet = func.overloadpacket
        if packet in flop_registry:
            self.ops["f32"] += flop_registry[packet](*args, **kwargs, out_val=out)
        else:
            self.ops["f32"] += sum(t.numel() for t in outs)
        self.unfused_bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        return out

    def _count(self, name: str, nbytes: int, ops: dict) -> None:
        rec = self.kernels.setdefault(name, {"calls": 0, "bytes": 0, "ops": 0.0})
        rec["calls"] += 1
        rec["bytes"] += nbytes
        rec["ops"] += sum(ops.values())
        self.unfused_bytes += nbytes
        for k, n in ops.items():
            self.ops[k] = self.ops.get(k, 0.0) + n

    def _gauss_newton(self, func, args: tuple, kwargs: dict):
        """The GN operator, whose wrapper the ``observing`` hook never
        sees: run it, count its call by ``gn_work``."""
        self._in_kernel += 1
        try:
            out = func(*args, **kwargs)
        finally:
            self._in_kernel -= 1
        a = func._schema.arguments
        kw = dict(zip((x.name for x in a), args), **kwargs)
        DT0, P, sP = kw["DT0"], kw["P"], kw["sP"]
        nbytes, ops = gn_work(P.shape[-2], sP.shape[-2],
                              batch=DT0.shape[0] if DT0.dim() == 3 else 1,
                              max_iters=kw["max_iters"], use_points=kw["use_points"],
                              use_lines=kw["use_lines"], plucker=kw["plucker"])
        self._count("gauss_newton_cuda", nbytes, {"f32_add": ops})
        return out

    def kernel(self, wrapper, args: tuple, kwargs: dict):
        """The ``cuda_lib.observing`` hook: run the wrapper, count its call."""
        self._in_kernel += 1
        try:
            out = wrapper.__wrapped__(*args, **kwargs)
            nbytes, ops = _kernel_work(wrapper.__name__, args)
        finally:
            self._in_kernel -= 1
        self._count(wrapper.__name__, nbytes, ops)
        return out


def count_work(fn: Callable[[], object]):
    """(fn's output, its ``WorkCounter``) of one call of ``fn``."""
    counter = WorkCounter()
    with cuda_lib.observing(counter.kernel), counter:
        out = fn()
    return out, counter


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def seconds_per_call(call: Callable[[int], object], n: int, dev: torch.device) -> float:
    """``call(i)`` for i < n after one warm round: on the card between two
    CUDA events (the device's time for the whole queue), else on the host
    clock; over n."""
    for i in range(n):
        call(i)
    _sync(dev)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for i in range(n):
            call(i)
        return (time.perf_counter() - t0) / n
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n):
        call(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / n


def bits_equal(a, b) -> bool:
    """Two trees of tensors bit for bit (a NaN equals a NaN of the same bits)."""
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))
        for x, y in zip(la, lb) if isinstance(x, torch.Tensor))


class Stage(NamedTuple):
    """One program: ``fn`` reads ``static`` (a tree of buffers) and the
    trees in ``fixed``; ``inputs[i]`` is copied into ``static`` before call
    i (None: nothing to copy)."""

    name: str
    fn: Callable[[], object]
    static: object
    fixed: tuple
    inputs: list

    def load(self, i: int) -> None:
        if self.inputs[i] is not None:
            graphs.tree_copy_(self.static, self.inputs[i])


def time_stage(stage: Stage, dev: torch.device, n: int, eager, profile: bool = False) -> dict:
    """The stage's graphed program (``graphs.Program``; its warm-ups and
    capture on input 0): seconds per call over the n inputs, with
    ``profile`` the device-busy ms and device kernels per call of the same
    n calls under ``torch.profiler``, and whether its output on input 0
    equals ``eager`` (the ``capture=False`` output) bit for bit."""
    stage.load(0)
    prog = graphs.Program(stage.fn, dev)

    def call(i):
        stage.load(i)
        return prog()

    sec = seconds_per_call(call, n, dev)
    prof = profile_window(call, n) if profile and dev.type == "cuda" else {}
    same = bits_equal(call(0), eager)
    _sync(dev)
    return {"stage": stage.name, "ms": 1e3 * sec, "busy_ms": prof.get("busy_ms"),
            "device_kernels": prof.get("kernels"), "graphed": prog.captured, "bits_equal": same}


def measure(stage: Stage, dev: torch.device, n: int) -> dict:
    """One stage's row: the work of one ``capture=False`` call on input 0
    (``count_work``), then ``time_stage`` with the profiler."""
    stage.load(0)
    eager, work = count_work(stage.fn)
    eager = graphs.tree_clone(eager)
    row = time_stage(stage, dev, n, eager, profile=True)
    return {**row, "ops": dict(work.ops), "unfused_bytes": work.unfused_bytes,
            "program_bytes": tree_bytes((stage.static, stage.fixed)) + tree_bytes(eager),
            "kernels": work.kernels}


def stages(dev: torch.device, n: int, scale: float = 1.0) -> list[Stage]:
    """The JAX script's four programs at its sizes (``scale`` 1): the
    bench scene's frame 1 after ``initialize`` on frame 0."""
    scene_kw, widths = scaled(scale)
    scene = SyntheticScene(**scene_kw)
    cam = camera(scene)
    fcfg, tcfg = FrontendConfig(**widths), TrackerConfig()
    vo = VisualOdometry(cam, fcfg, tcfg, device=dev, capture=False)
    poses = circular_trajectory(3, step_t=0.05)

    def pair(T):
        return [torch.from_numpy(x).to(dev) for x in scene.render_stereo(T, noise=1.0)]

    vo.initialize(*pair(poses[0]))
    base = torch.stack(pair(poses[1]))
    stacks = [base + 0.01 * i for i in range(n)]
    st = vo.state
    th = st.fast_th

    img_p, img_l = base.clone(), base.clone()
    points = Stage("point detect+describe",
                   lambda: _detect_describe_points_batch(img_p, fcfg, th), img_p, (th,), stacks)
    lines = Stage("line detect+LBD", lambda: _detect_describe_lines_batch(img_l, fcfg), img_l,
                  (), stacks)
    seg_pair = _detect_describe_lines_batch(base, fcfg)
    kps = [_detect_describe_points_batch(s, fcfg, th) for s in stacks]
    kp_buf = graphs.tree_clone(kps[0])
    track = Stage("match+f2f+GN track",
                  lambda: match_and_track(kp_buf, seg_pair, st, cam, fcfg, tcfg, vo.params),
                  kp_buf, (seg_pair, st), kps)

    K, P, L = BA_SIZE["K"], round(BA_SIZE["P"] * scale), round(BA_SIZE["L"] * scale)
    prob = local_ba_problem(dev, K, P, L)
    cam32 = StereoCamera.create(*LBA_CAM)
    bacfg = ba.BAConfig()
    local_ba = Stage(f"local BA ({LM_ITERS} LM iters, {K}KF/{P}pt/{L}ls)",
                     lambda: ba.lm_rounds(prob, cam32, bacfg, prob.p_valid, prob.l_valid,
                                          LM_ITERS),
                     prob, (), [None] * n)
    return [points, lines, track, local_ba]


def table(rows: list[dict], kind: str | None) -> dict:
    """Rates, % of peak and the bound for each row (``kind`` None: the
    CPU, counts and host times only), and the per-frame total of the
    three VO programs."""
    pk = peaks(kind) if kind is not None else None
    for r in rows:
        sec = r["ms"] / 1e3
        flop = sum(v for k, v in r["ops"].items() if k != "int8")
        r.update(gflop=flop / 1e9, gop_int8=r["ops"].get("int8", 0.0) / 1e9,
                 mb_unfused=r["unfused_bytes"] / 1e6, mb_program=r["program_bytes"] / 1e6,
                 gflop_s=flop / sec / 1e9, gb_s_unfused=r["unfused_bytes"] / sec / 1e9,
                 gb_s_program=r["program_bytes"] / sec / 1e9)
        if pk is not None:
            t_ops = sum(v / pk[k] for k, v in r["ops"].items())
            t_bytes = r["program_bytes"] / pk["hbm"]
            r.update(pct_flop=100 * flop / sec / pk["f32"],
                     pct_bw_unfused=100 * r["unfused_bytes"] / sec / pk["hbm"],
                     pct_bw_program=100 * r["program_bytes"] / sec / pk["hbm"],
                     bound_ms=1e3 * max(t_ops, t_bytes),
                     bound_by="bytes" if t_bytes >= t_ops else "operations")
    total = sum(r["ms"] for r in rows[:3])
    return {"per_frame_ms": total, "frames_per_s_ceiling": 1e3 / total}


def run(device="cuda", n: int = N, scale: float = 1.0, say=None) -> dict:
    """Measure every stage; returns {"card", "rows", "per_frame_ms",
    "frames_per_s_ceiling"}."""
    dev = torch.device(device)
    say = say or (lambda msg: None)
    rows = []
    for st in stages(dev, n, scale):
        rows.append(measure(st, dev, n))
        say(f"{st.name}: {rows[-1]['ms']:.3f} ms")
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else None
    return {"card": card(dev), "kind": kind, "rows": rows, **table(rows, kind)}


def report(out: dict) -> list[str]:
    """The printed table."""
    kind = out["kind"]
    lines = []
    if kind is None:
        lines.append("# device: cpu (host ms, plain kernels; no peaks)")
    else:
        pk = PEAKS[kind]
        lines.append(f"# device: {out['card']}  peaks: {pk['f32'] / 1e12:.0f} TFLOP/s f32, "
                     f"{pk['int8'] / 1e12:.0f} TOP/s int8, {pk['hbm'] / 1e9:.0f} GB/s HBM")
    lines.append(f"{'stage':40s} {'ms':>8s} {'busy ms':>8s} {'kernels':>7s} {'GFLOP':>8s} "
                 f"{'Gop i8':>7s} "
                 f"{'MB unf':>8s} {'MB prog':>8s} {'GFLOP/s':>9s} {'GB/s unf':>9s} "
                 f"{'GB/s prog':>9s} {'%FLOP':>6s} {'%BWunf':>6s} {'%BWprg':>6s} "
                 f"{'bound ms':>9s}")
    for r in out["rows"]:
        busy = (f"{r['busy_ms']:8.3f} {r['device_kernels']:7.0f}" if r["busy_ms"] is not None
                else f"{'-':>8s} {'-':>7s}")
        pct = (f"{r['pct_flop']:6.2f} {r['pct_bw_unfused']:6.1f} {r['pct_bw_program']:6.2f} "
               f"{r['bound_ms']:9.4f}" if kind is not None else
               f"{'-':>6s} {'-':>6s} {'-':>6s} {'-':>9s}")
        lines.append(f"{r['stage']:40s} {r['ms']:8.3f} {busy} {r['gflop']:8.4f} "
                     f"{r['gop_int8']:7.3f} {r['mb_unfused']:8.2f} {r['mb_program']:8.3f} "
                     f"{r['gflop_s']:9.2f} {r['gb_s_unfused']:9.2f} {r['gb_s_program']:9.3f} "
                     f"{pct}")
    lines.append(f"# per-frame device total (3 stages): {out['per_frame_ms']:.3f} ms -> "
                 f"{out['frames_per_s_ceiling']:.1f} frames/s compute ceiling"
                 if kind is not None else
                 f"# per-frame host total (3 stages): {out['per_frame_ms']:.3f} ms -> "
                 f"{out['frames_per_s_ceiling']:.1f} frames/s")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default: card 0) or cpu")
    ap.add_argument("--n", type=int, default=N, help="calls timed per program")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="image, feature widths and BA size (1: the JAX script's)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = run(dev, args.n, args.scale)
    for line in report(out):
        print(line, flush=True)
    slim = [{k: v for k, v in r.items() if k != "kernels"} for r in out["rows"]]
    print(json.dumps({"roofline": slim, "card": out["card"],
                      "per_frame_ms": out["per_frame_ms"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
