"""The robust Gauss-Newton pose solve as one CUDA launch (``csrc/gauss_newton.cu``).

``frontend.tracker.gauss_newton`` sends CUDA tensors here
(``gauss_newton``: one launch runs every trip, the final build and the
covariance, and returns the ``GNResult``) and CPU tensors to its plain
twin ``tracker.gauss_newton_plain``.  The launch goes through the operator
``plslam::gauss_newton``: its vmap rule turns a call under
``torch.func.vmap`` (``batch_vo``) into one launch for the B problems,
one thread block each; an operand shared by every problem is passed at
batch stride 0.

The kernel takes float32 inputs of at most ``MAX_ROWS`` points and lines
together (its shared memory holds each row's residual); ``check_inputs``
raises on anything else before a launch.  The wrapper's launches are
counted (``gauss_newton_cuda.launches``, and the profiling counter
``kernels.gn_launches`` of the launching or replaying thread), but never
reach ``cuda_lib.observing``'s hook: ``roofline.WorkCounter`` counts the
operator's work by ``roofline.gn_work``.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.camera import StereoCamera
from . import cuda_lib

# Points + lines a problem (csrc/gauss_newton.cu MAX_ROWS): every caller
# holds 800-1,200 points and 256-320 line slots.
MAX_ROWS = 8192
COUNTER = "kernels.gn_launches"
_N_IN, _N_OUT = 17, 5
_MASKS = (4, 5, 15, 16)     # the bool inputs, by position (valid, inlier of each)


class GNArgs(ctypes.Structure):
    """``GNArgs`` of csrc/gauss_newton.cu."""

    _fields_ = [("inputs", ctypes.c_void_p * _N_IN), ("bstride", ctypes.c_longlong * _N_IN),
                ("outputs", ctypes.c_void_p * _N_OUT)] + \
               [(k, ctypes.c_int) for k in ("batch", "n_points", "n_lines", "use_points",
                                            "use_lines", "plucker", "early_exit", "max_iters")] + \
               [(k, ctypes.c_float) for k in ("fx", "fy", "cx", "cy", "k20", "k21", "k22",
                                              "min_error", "min_error_change")]


def check_inputs(tensors, batched: bool) -> None:
    """Raise before a launch: float inputs must be float32 and the masks
    bool (TypeError), at most ``MAX_ROWS`` points and lines (ValueError).
    ``tensors`` is DT0 and the fields of TrackedPoints and TrackedLines,
    each with a leading problem axis when ``batched``."""
    if len(tensors) != _N_IN:
        raise ValueError(f"gauss_newton: want {_N_IN} tensors, got {len(tensors)}")
    for i, t in enumerate(tensors):
        want = torch.bool if i in _MASKS else torch.float32
        if t.dtype != want:
            raise TypeError(f"gauss_newton: input {i} is {t.dtype}, the kernel takes {want}")
    lead = 1 if batched else 0
    n = tensors[1].shape[lead] + tensors[6].shape[lead]
    if n > MAX_ROWS:
        raise ValueError(f"gauss_newton: {n} points and lines, the kernel holds {MAX_ROWS}")


@cuda_lib.counted.unobserved(COUNTER)
def gauss_newton_cuda(tensors, cam, use_points, use_lines, plucker, early_exit, max_iters,
                      min_error, min_error_change):
    """B problems in one launch: ``tensors`` is DT0 (B, 4, 4) and the fields
    of TrackedPoints and TrackedLines, each with a leading axis of B
    (stride 0 where the problems share it); ``cam`` is (fx, fy, cx, cy).
    Returns DT (B, 4, 4), cov (B, 6, 6), err (B,), good (B,) and each
    trip's done flag at its entry (B, max_iters)."""
    dev = tensors[0].device
    check_inputs(tensors, batched=True)
    B = tensors[0].shape[0]
    flat = []
    for t in tensors:
        if t.shape[0] != B:
            raise ValueError("gauss_newton: every input needs the same leading problem axis")
        if B and not t[0].is_contiguous():
            t = t.contiguous()
        flat.append(t)
    cuda_lib.require_cuda("gauss_newton", *(t[0] if B else t for t in flat))
    f32 = dict(dtype=torch.float32, device=dev)
    outs = (torch.empty((B, 4, 4), **f32), torch.empty((B, 6, 6), **f32),
            torch.empty((B,), **f32), torch.empty((B,), dtype=torch.bool, device=dev),
            torch.empty((B, max_iters), dtype=torch.bool, device=dev))
    fx, fy, cx, cy = cam
    k20, k21, k22 = StereoCamera(fx, fy, cx, cy, 0.0).plucker_K[2]
    args = GNArgs(batch=B, n_points=flat[1].shape[1], n_lines=flat[6].shape[1],
                  use_points=use_points, use_lines=use_lines, plucker=plucker,
                  early_exit=early_exit, max_iters=max_iters, fx=fx, fy=fy, cx=cx, cy=cy,
                  k20=k20, k21=k21, k22=k22, min_error=min_error,
                  min_error_change=min_error_change)
    for i, t in enumerate(flat):
        args.inputs[i] = t.data_ptr()
        args.bstride[i] = t.stride(0) if B > 1 else 0
    for i, t in enumerate(outs):
        args.outputs[i] = t.data_ptr()
    lib = cuda_lib.load().lib
    with torch.cuda.device(dev):
        err = lib.plslam_gauss_newton(ctypes.addressof(args), cuda_lib.stream_ptr(dev))
    cuda_lib.check(err, "gauss_newton")
    gauss_newton_cuda.count()
    return outs


@torch.library.custom_op("plslam::gauss_newton", mutates_args=())
def gauss_newton_op(DT0: torch.Tensor, P: torch.Tensor, obs: torch.Tensor,
                    p_sigma2: torch.Tensor, p_valid: torch.Tensor, p_inlier: torch.Tensor,
                    sP: torch.Tensor, eP: torch.Tensor, sp: torch.Tensor, ep: torch.Tensor,
                    NDc: torch.Tensor, sobs: torch.Tensor, eobs: torch.Tensor,
                    le_obs: torch.Tensor, l_sigma2: torch.Tensor, l_valid: torch.Tensor,
                    l_inlier: torch.Tensor, cam: list[float], use_points: bool,
                    use_lines: bool, plucker: bool, early_exit: bool, max_iters: int,
                    min_error: float, min_error_change: float
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """The operator form of ``gauss_newton_cuda``: one problem (DT0 (4, 4)),
    or B (DT0 (B, 4, 4), every input with the leading axis)."""
    tensors = (DT0, P, obs, p_sigma2, p_valid, p_inlier, sP, eP, sp, ep, NDc, sobs, eobs,
               le_obs, l_sigma2, l_valid, l_inlier)
    single = DT0.dim() == 2
    if single:
        tensors = tuple(t[None] for t in tensors)
    outs = gauss_newton_cuda(tensors, cam, use_points, use_lines, plucker, early_exit,
                             max_iters, min_error, min_error_change)
    return tuple(o[0] if single else o for o in outs)


@gauss_newton_op.register_vmap
def _(info, in_dims, *args):
    """A vmapped call is one launch for the B problems; an unbatched operand
    is shared by every problem at batch stride 0."""
    B = info.batch_size
    tensors, rest = args[:_N_IN], args[_N_IN:]

    def lead(t, bdim):
        return t.movedim(bdim, 0) if bdim is not None else t.expand((B,) + t.shape)

    out = gauss_newton_op(*(lead(t, d) for t, d in zip(tensors, in_dims[:_N_IN])), *rest)
    return out, (0,) * _N_OUT


def gauss_newton(DT0, pts, ls, cam, cfg, max_iters: int):
    """``tracker.gauss_newton`` on the card: one launch; the same
    ``GNResult`` as the plain twin."""
    from ..frontend.tracker import GNResult

    DT, cov, err, good, done = gauss_newton_op(
        DT0, *pts, *ls, [cam.fx, cam.fy, cam.cx, cam.cy], cfg.use_points, cfg.use_lines,
        cfg.plucker_lines, cfg.early_exit, max_iters, cfg.min_error, cfg.min_error_change)
    return GNResult(DT=DT, cov=cov, err=err, good=good, done_in=tuple(done.unbind(-1)))


def select_test(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, N) float32 and bool -> (B,): the kernel's selection of
    ``robust.masked_median_upper`` on each row (a test entry)."""
    if x.dtype != torch.float32 or mask.dtype != torch.bool or x.dim() != 2 \
            or x.shape != mask.shape or x.shape[1] > MAX_ROWS:
        raise ValueError("select_test: want (B, N <= MAX_ROWS) float32 and bool")
    x, mask = x.contiguous(), mask.contiguous()
    cuda_lib.require_cuda("select_test", x, mask)
    out = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    lib = cuda_lib.load().lib
    with torch.cuda.device(x.device):
        err = lib.plslam_gn_select_test(x.data_ptr(), mask.data_ptr(), x.shape[0], x.shape[1],
                                        out.data_ptr(), cuda_lib.stream_ptr(x.device))
    cuda_lib.check(err, "select_test")
    return out
