"""Stereo visual odometry driver (``plslam_tpu.vo``; reference
``src2/stereoFrameHandler.cpp``: initialize :35, updateFrame with the
adaptive FAST protocol :66-86, optimizePose :307, pose chaining :385-394,
needNewKF :1465, currFrameIsKF :1518).

One ``process`` call runs the whole per-frame step: batched point and line
detection on the stacked (2, H, W) pair, stereo matching, f2f association,
the robust GN pose solve, the keyframe statistics and the adaptive FAST
update.  All sequential state (``VOState``) stays on the device, the FAST
threshold included, which reaches the FAST kernel as a device pointer:
the step makes no host sync.  On the card the step is one CUDA graph
(``graphs.Program``) replayed over static image and state buffers, the
counterpart of the JAX package's jitted ``_step``; ``step`` is the
functional form it captures.
"""

from __future__ import annotations

import math
import time
from typing import NamedTuple, Optional

import torch

from . import graphs
from .core import lie
from .core.camera import StereoCamera
from .device import on_device
from .frontend import f2f
from .frontend.features import StereoFeatures
from .frontend.frame import (FrontendConfig, _detect_describe_lines_batch,
                             _detect_describe_points_batch, _match_stereo_lines,
                             _match_stereo_points)
from .frontend.tracker import TrackerConfig, optimize_pose, trips_used
from .utils.profiling import span


class FrameResult(NamedTuple):
    T_f_w: torch.Tensor         # camera->world pose of this frame
    DT: torch.Tensor            # motion: prev-frame points -> curr frame
    DT_cov: torch.Tensor
    err: torch.Tensor
    n_inliers: torch.Tensor
    good: torch.Tensor
    is_kf: torch.Tensor
    entropy_ratio: torch.Tensor
    gn_trips_used: torch.Tensor  # f32: GN trips that entered not done, both solves


class VOState(NamedTuple):
    features: StereoFeatures
    T_f_w: torch.Tensor
    T_f_w_cov: torch.Tensor
    T_prevKF: torch.Tensor
    cov_prevKF_accum: torch.Tensor
    entropy_first: torch.Tensor
    frames_since_kf: torch.Tensor
    prev_was_kf: torch.Tensor
    fast_th: torch.Tensor       # adaptive FAST threshold, f32 device scalar
    prev_DT: torch.Tensor       # motion-model warm start
    prev_good: torch.Tensor


class VOParams(NamedTuple):
    adaptative_fast: bool = True
    fast_min_th: float = 5.0
    fast_max_th: float = 50.0
    fast_inc_th: float = 5.0
    fast_feat_th: int = 50
    fast_err_th: float = 0.5
    use_motion_model: bool = False


def _entropy(cov: torch.Tensor) -> torch.Tensor:
    """Differential entropy of a 6x6 covariance; NaN when not SPD."""
    eye6 = torch.eye(6, dtype=cov.dtype, device=cov.device)
    L, info = torch.linalg.cholesky_ex(cov + 1e-18 * eye6)
    logdet = 2.0 * torch.sum(torch.log(torch.abs(torch.diagonal(L))))
    ent = 3.0 * (1.0 + math.log(2.0 * math.pi)) + 0.5 * logdet
    return torch.where(info == 0, ent, torch.nan)


def _take(tree, i: int):
    return type(tree)(*(x[i] for x in tree))


def fresh_state(feats: StereoFeatures, fast_th: float, dtype,
                device) -> VOState:
    I = torch.eye(4, dtype=dtype, device=device)
    Z = torch.zeros((6, 6), dtype=dtype, device=device)

    def scalar(v, dt):
        return torch.full((), v, dtype=dt, device=device)

    return VOState(features=feats, T_f_w=I, T_f_w_cov=Z, T_prevKF=I.clone(),
                   cov_prevKF_accum=Z.clone(),
                   entropy_first=scalar(-9.9e8, dtype),
                   frames_since_kf=scalar(0, torch.int32),
                   prev_was_kf=scalar(True, torch.bool),
                   fast_th=scalar(fast_th, torch.float32),
                   prev_DT=I.clone(), prev_good=scalar(False, torch.bool))


def frame_scalars(res: FrameResult) -> torch.Tensor:
    """One (..., 21) f32 buffer of everything ``PLSLAM`` reads per
    frame: is_kf, n_inliers, err, good, entropy_ratio, then T_f_w row-major
    (``plslam_tpu.pipeline.PLSLAM._pack_frame_scalars``); a leading stream
    axis for a batched result."""
    f32 = torch.float32
    lead = res.T_f_w.shape[:-2]
    return torch.cat([
        torch.stack([res.is_kf.to(f32), res.n_inliers.to(f32), res.err.to(f32),
                     res.good.to(f32), res.entropy_ratio.to(f32)], dim=-1),
        res.T_f_w.reshape(lead + (16,)).to(f32)], dim=-1)


def frame_record(res: FrameResult) -> torch.Tensor:
    """One flat f32 buffer, ``frame_scalars`` then the GN trips used, each
    contiguous (22 floats unbatched): the frame's one host copy in
    ``PLSLAM``."""
    return torch.cat([frame_scalars(res).reshape(-1), res.gn_trips_used.reshape(-1)])


class GraphedStep:
    """The sequential state in static buffers, updated in place by one
    captured program per image shape (``graphs.Program``): the port's
    counterpart of the JAX package's jitted step.  A subclass supplies
    ``_image_buffer(hw)`` and ``_advance(imgs, state)``; ``process``
    copies the images in, replays once and copies the packed result out.

    Aliasing: JAX arrays are immutable, static buffers are not.  Nothing
    handed out is a static buffer: a result is a view of the copy of the
    program's packed output, and ``state``, ``current_features`` and
    ``pose`` return copies."""

    device: torch.device
    capture: bool
    _state: Optional[VOState]

    def _init_graphs(self, capture: bool) -> None:
        self.capture = capture
        self._state = None
        self._ready = False           # initialize() or a state assignment happened
        self._programs: dict = {}     # (H, W) -> (image buffer, Program, layout box)
        self.frame_record: Optional[torch.Tensor] = None

    @property
    def state(self) -> Optional[VOState]:
        """A copy of the sequential state (the live buffers change with
        every frame)."""
        return None if self._state is None else graphs.tree_clone(self._state)

    @state.setter
    def state(self, st: VOState) -> None:
        """Copy ``st`` into the static buffers (new buffers, and new
        programs, when its shapes differ)."""
        if self._state is not None and graphs.same_layout(self._state, st):
            graphs.tree_copy_(self._state, st)
        else:
            self._state = graphs.tree_clone(st)
            self._programs.clear()
        self._ready = True

    @property
    def frame_scalars(self) -> Optional[torch.Tensor]:
        """The last frame's ``frame_scalars``: a view of ``frame_record``."""
        if self.frame_record is None:
            return None
        return self.frame_record[:21 * self._lead.numel()].view(self._lead + (21,))

    @property
    def current_features(self) -> StereoFeatures:
        """A copy of the current features, its fields views of one buffer
        (one kernel)."""
        return graphs.tree_pack_clone(self._state.features)

    @property
    def pose(self) -> torch.Tensor:
        return self._state.T_f_w.clone()

    def _program(self, hw: tuple):
        """The captured step for images of shape ``hw`` (captured on first
        use, as a jitted function compiles).  The warm-up runs advance the
        static state; it is put back before the program is handed out."""
        entry = self._programs.get(hw)
        if entry is None:
            imgs, state, box = self._image_buffer(hw), self._state, {}

            def run():
                res, new = self._advance(imgs, state)
                graphs.tree_copy_(state, new)
                out = {**res._asdict(), "record": frame_record(res)}
                del out["gn_trips_used"]  # it is in the record
                buf, box["layout"] = graphs.pack(out)
                return buf

            saved = graphs.tree_clone(state)
            prog = graphs.Program(run, self.device, capture=self.capture)
            graphs.tree_copy_(state, saved)
            entry = self._programs[hw] = (imgs, prog, box)
        return entry

    def _replay(self, hw: tuple, fill) -> FrameResult:
        """Fill the image buffer, replay once, copy the packed output."""
        if not self._ready:
            raise RuntimeError("call initialize() first")
        imgs, prog, box = self._program(hw)
        with span("vo.replay"):
            fill(imgs)
            out = graphs.unpack(prog().clone(), box["layout"])
        rec = self.frame_record = out.pop("record")
        lead = self._lead = out["T_f_w"].shape[:-2]
        return FrameResult(**out, gn_trips_used=rec[21 * lead.numel():].view(lead))

    def programs(self) -> list:
        """The captured programs, one per image shape seen."""
        return [p for _, p, _ in self._programs.values()]


class VisualOdometry(GraphedStep):
    """Host-side driver; all sequential state lives on ``device`` (the
    card unless the caller asks for the CPU).

    ``process`` is one replay of the captured step (``prewarm`` captures it
    ahead of the first frame; without it the first ``process`` does),
    ``capture=False`` runs the same function eagerly.  On the CPU the same
    in-place function runs directly."""

    def __init__(self, cam: StereoCamera, fcfg: FrontendConfig = FrontendConfig(),
                 tcfg: TrackerConfig = TrackerConfig(), *, device="cuda",
                 dtype=torch.float32, adaptative_fast: bool = True,
                 use_motion_model: bool = False, capture: bool = True, **fast_params):
        self.cam = cam
        self.fcfg = fcfg
        self.tcfg = tcfg
        self.device = torch.device(device)
        self.dtype = dtype
        self.params = VOParams(adaptative_fast=adaptative_fast,
                               use_motion_model=use_motion_model, **fast_params)
        self._init_graphs(capture)

    def _check(self, img_l: torch.Tensor, img_r: torch.Tensor) -> tuple:
        if not (on_device(img_l, self.device) and on_device(img_r, self.device)):
            raise ValueError(f"images must be on {self.device}, got "
                             f"{img_l.device}, {img_r.device}")
        if img_l.dim() != 2 or img_r.shape != img_l.shape:
            raise ValueError(f"want two (H, W) images, got {tuple(img_l.shape)}, "
                             f"{tuple(img_r.shape)}")
        return tuple(img_l.shape)

    def _stack(self, img_l: torch.Tensor, img_r: torch.Tensor) -> torch.Tensor:
        self._check(img_l, img_r)
        return torch.stack([img_l, img_r]).to(torch.float32)

    def _extract(self, imgs: torch.Tensor, fast_th) -> StereoFeatures:
        """Detect, describe and stereo-match one stacked (2, H, W) pair."""
        kp_pair = _detect_describe_points_batch(imgs, self.fcfg, fast_th)
        seg_pair = _detect_describe_lines_batch(imgs, self.fcfg)
        return match_stereo(kp_pair, seg_pair, cam=self.cam, fcfg=self.fcfg)

    def initialize(self, img_l: torch.Tensor, img_r: torch.Tensor) -> StereoFeatures:
        """The first frame: its features start a fresh state (every field
        of the static state is set)."""
        feats = self._extract(self._stack(img_l, img_r), self.fcfg.fast_th)
        self.state = fresh_state(feats, self.fcfg.fast_th, self.dtype, self.device)
        return feats

    def prewarm(self, img_shape, img_dtype=torch.float32, progress=None) -> None:
        """Capture the per-frame step for (H, W) images of ``img_dtype``
        before the first frame (``plslam_tpu.vo.VisualOdometry.prewarm``).
        Without a state yet, the static one is allocated from the features
        of a black pair; ``initialize`` then sets every field of it.
        ``progress`` is fed one-line status strings."""
        say = progress or (lambda s: None)
        hw = tuple(img_shape[-2:])
        if self._state is None:
            black = torch.zeros((2,) + hw, dtype=img_dtype, device=self.device)
            feats = self._extract(black.to(torch.float32), self.fcfg.fast_th)
            self._state = fresh_state(feats, self.fcfg.fast_th, self.dtype, self.device)
        t0 = time.perf_counter()
        prog = self._program(hw)[1]
        say(f"{'captured' if prog.captured else 'ready (eager)'}: frame step "
            f"(detect+match+track) for {hw[0]}x{hw[1]} in {time.perf_counter() - t0:.3f} s")

    def _image_buffer(self, hw: tuple) -> torch.Tensor:
        return torch.zeros((2,) + hw, dtype=torch.float32, device=self.device)

    def _advance(self, imgs: torch.Tensor, state: VOState):
        return step(imgs, state, self.cam, self.fcfg, self.tcfg, self.params)

    def process(self, img_l: torch.Tensor, img_r: torch.Tensor) -> FrameResult:
        """Track one new stereo pair: one replay of the captured step, no
        host sync.  Call ``mark_keyframe()`` afterwards if the mapping
        layer accepted the keyframe."""
        hw = self._check(img_l, img_r)

        def fill(imgs):
            imgs[0].copy_(img_l)
            imgs[1].copy_(img_r)

        return self._replay(hw, fill)

    def mark_keyframe(self):
        """Reset the keyframe statistics after the mapper inserts a
        keyframe, in the static state."""
        st = self._state
        st.T_prevKF.copy_(st.T_f_w)
        st.cov_prevKF_accum.zero_()
        st.frames_since_kf.zero_()
        st.prev_was_kf.fill_(True)


def step(imgs: torch.Tensor, state: VOState, cam: StereoCamera,
         fcfg: FrontendConfig, tcfg: TrackerConfig, prm: VOParams):
    """One frame: detect + stereo match + f2f + GN + keyframe statistics +
    adaptive FAST update.  Returns (FrameResult, new VOState)."""
    kp, pdesc = _detect_describe_points_batch(imgs, fcfg, state.fast_th)
    seg, ldesc = _detect_describe_lines_batch(imgs, fcfg)
    return match_and_track((kp, pdesc), (seg, ldesc), state, cam, fcfg, tcfg, prm)


def match_stereo(kp_pair, seg_pair, *, cam: StereoCamera,
                 fcfg: FrontendConfig) -> StereoFeatures:
    """Left-right matching of one pair's detections (index 0 left, 1
    right on the leading axis)."""
    kp, pdesc = kp_pair
    seg, ldesc = seg_pair
    points = _match_stereo_points(_take(kp, 0), pdesc[0], _take(kp, 1), pdesc[1],
                                  cam, fcfg)
    line_set = _match_stereo_lines(_take(seg, 0), ldesc[0], _take(seg, 1), ldesc[1],
                                   cam, fcfg)
    return StereoFeatures(points=points, lines=line_set)


def match_and_track(kp_pair, seg_pair, state: VOState, cam: StereoCamera,
                    fcfg: FrontendConfig, tcfg: TrackerConfig, prm: VOParams):
    """The step after detection (``plslam_tpu.vo._match_and_track``).  It
    also runs under ``torch.func.vmap`` over a leading stream axis
    (``batch_vo``): no host sync, no data-dependent Python branch."""
    feats = match_stereo(kp_pair, seg_pair, cam=cam, fcfg=fcfg)

    pts, ls, _, _ = f2f.track_frame_to_frame(state.features, feats)
    I4 = torch.eye(4, dtype=state.T_f_w.dtype, device=state.T_f_w.device)
    DT_init = (torch.where(state.prev_good, state.prev_DT, I4)
               if prm.use_motion_model else I4)
    est, pts_out, _ = optimize_pose(pts, ls, cam, tcfg, DT_init=DT_init)

    # pose chaining (optimizePose :385-394)
    DT_pose = lie.inv_se3(est.DT)
    T_f_w = torch.where(est.good, lie.se3_chordal_project(state.T_f_w @ DT_pose),
                        state.T_f_w)
    cov = torch.where(est.good, lie.cov_compose(state.T_f_w, state.T_f_w_cov, est.cov),
                      state.T_f_w_cov)

    # needNewKF (:1465)
    ent_now = _entropy(est.cov)
    entropy_first = torch.where(
        state.prev_was_kf,
        torch.where(torch.isfinite(ent_now), ent_now, -9.9e8),
        state.entropy_first)
    adj = lie.adjoint_se3(state.T_prevKF)
    cov_accum = state.cov_prevKF_accum + adj @ lie.cov_Tinv(DT_pose, est.cov) @ adj.T
    entropy_ratio = _entropy(cov_accum) / entropy_first
    dX = lie.log_se3(lie.inv_se3(T_f_w) @ state.T_prevKF)
    t_dist = torch.linalg.norm(dX[:3])
    r_dist = torch.linalg.norm(dX[3:]) * (180.0 / math.pi)
    is_kf = ((entropy_ratio < tcfg.min_entropy_ratio) | ~torch.isfinite(entropy_ratio)
             | ~est.good | (t_dist > tcfg.max_kf_t_dist)
             | (r_dist > tcfg.max_kf_r_dist) | (state.frames_since_kf >= 10))

    # adaptive FAST threshold (updateFrame :66-86) on the device; the
    # reference counts point inliers only
    th = state.fast_th
    if prm.adaptative_fast:
        n = (pts_out.valid & pts_out.inlier).sum(dtype=torch.int32)
        inc = prm.fast_inc_th
        feat = prm.fast_feat_th
        bad = ~est.good | (est.err > prm.fast_err_th)
        th = torch.where(bad | (n < feat), th - 2 * inc,
                         torch.where(n < 2 * feat, th - inc,
                                     torch.where(n > 4 * feat, th + 2 * inc,
                                                 torch.where(n > 3 * feat, th + inc,
                                                             th))))
        th = torch.clamp(th, prm.fast_min_th, prm.fast_max_th)

    res = FrameResult(T_f_w=T_f_w, DT=est.DT, DT_cov=est.cov, err=est.err,
                      n_inliers=est.n_inliers, good=est.good, is_kf=is_kf,
                      entropy_ratio=entropy_ratio, gn_trips_used=trips_used(est.done_in))
    new_state = VOState(
        features=feats, T_f_w=T_f_w, T_f_w_cov=cov, T_prevKF=state.T_prevKF,
        cov_prevKF_accum=cov_accum, entropy_first=entropy_first,
        frames_since_kf=state.frames_since_kf + 1,
        prev_was_kf=torch.zeros_like(state.prev_was_kf),
        fast_th=th, prev_DT=est.DT, prev_good=est.good)
    return res, new_state
