"""Stereo visual odometry driver (``plslam_tpu.vo``; reference
``src2/stereoFrameHandler.cpp``: initialize :35, updateFrame with the
adaptive FAST protocol :66-86, optimizePose :307, pose chaining :385-394,
needNewKF :1465, currFrameIsKF :1518).

One ``process`` call runs the whole per-frame step: batched point and line
detection on the stacked (2, H, W) pair, stereo matching, f2f association,
the robust GN pose solve, the keyframe statistics and the adaptive FAST
update.  All sequential state (``VOState``) stays on the device, the FAST
threshold included, which reaches the FAST kernel as a device pointer:
the step makes no host sync.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .core import lie
from .core.camera import StereoCamera
from .device import on_device
from .frontend import f2f
from .frontend.features import StereoFeatures
from .frontend.frame import (FrontendConfig, _detect_describe_lines_batch,
                             _detect_describe_points_batch, _match_stereo_lines,
                             _match_stereo_points)
from .frontend.tracker import TrackerConfig, optimize_pose


class FrameResult(NamedTuple):
    T_f_w: torch.Tensor         # camera->world pose of this frame
    DT: torch.Tensor            # motion: prev-frame points -> curr frame
    DT_cov: torch.Tensor
    err: torch.Tensor
    n_inliers: torch.Tensor
    good: torch.Tensor
    is_kf: torch.Tensor
    entropy_ratio: torch.Tensor


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


class VisualOdometry:
    """Host-side driver; all sequential state lives on ``device`` (the
    card unless the caller asks for the CPU)."""

    def __init__(self, cam: StereoCamera, fcfg: FrontendConfig = FrontendConfig(),
                 tcfg: TrackerConfig = TrackerConfig(), *, device="cuda",
                 dtype=torch.float32, adaptative_fast: bool = True,
                 use_motion_model: bool = False, **fast_params):
        self.cam = cam
        self.fcfg = fcfg
        self.tcfg = tcfg
        self.device = torch.device(device)
        self.dtype = dtype
        self.params = VOParams(adaptative_fast=adaptative_fast,
                               use_motion_model=use_motion_model, **fast_params)
        self.state: Optional[VOState] = None

    def _stack(self, img_l: torch.Tensor, img_r: torch.Tensor) -> torch.Tensor:
        if not (on_device(img_l, self.device) and on_device(img_r, self.device)):
            raise ValueError(f"images must be on {self.device}, got "
                             f"{img_l.device}, {img_r.device}")
        return torch.stack([img_l, img_r]).to(torch.float32)

    def _extract(self, imgs: torch.Tensor, fast_th) -> StereoFeatures:
        """Detect, describe and stereo-match one stacked (2, H, W) pair."""
        kp_pair = _detect_describe_points_batch(imgs, self.fcfg, fast_th)
        seg_pair = _detect_describe_lines_batch(imgs, self.fcfg)
        return match_stereo(kp_pair, seg_pair, cam=self.cam, fcfg=self.fcfg)

    def initialize(self, img_l: torch.Tensor, img_r: torch.Tensor) -> StereoFeatures:
        feats = self._extract(self._stack(img_l, img_r), self.fcfg.fast_th)
        self.state = fresh_state(feats, self.fcfg.fast_th, self.dtype, self.device)
        return feats

    def process(self, img_l: torch.Tensor, img_r: torch.Tensor) -> FrameResult:
        """Track one new stereo pair.  Call ``mark_keyframe()`` afterwards if
        the mapping layer accepted the keyframe."""
        if self.state is None:
            raise RuntimeError("call initialize() first")
        res, self.state = step(self._stack(img_l, img_r), self.state, self.cam,
                               self.fcfg, self.tcfg, self.params)
        return res

    def mark_keyframe(self):
        """Reset the keyframe statistics after the mapper inserts a keyframe."""
        st = self.state
        self.state = st._replace(
            T_prevKF=st.T_f_w, cov_prevKF_accum=torch.zeros_like(st.cov_prevKF_accum),
            frames_since_kf=torch.zeros_like(st.frames_since_kf),
            prev_was_kf=torch.ones_like(st.prev_was_kf))

    @property
    def current_features(self) -> StereoFeatures:
        return self.state.features

    @property
    def pose(self) -> torch.Tensor:
        return self.state.T_f_w


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
                      entropy_ratio=entropy_ratio)
    new_state = VOState(
        features=feats, T_f_w=T_f_w, T_f_w_cov=cov, T_prevKF=state.T_prevKF,
        cov_prevKF_accum=cov_accum, entropy_first=entropy_first,
        frames_since_kf=state.frames_since_kf + 1,
        prev_was_kf=torch.zeros_like(state.prev_was_kf),
        fast_th=th, prev_DT=est.DT, prev_good=est.good)
    return res, new_state
