"""Batched multi-stream visual odometry (``plslam_tpu.batch_vo``): B
independent stereo streams tracked in lockstep on one device.

Per frame, detection runs once on the flat (2B, H, W) stack of every
stream's pair (stream b's left and right images at 2b and 2b + 1), with
each stream's adaptive FAST threshold repeated for its two images; the
outputs are reshaped to (B, 2, ...).  The step after detection
(``vo.match_and_track``: stereo matching, f2f association, the robust GN,
the keyframe statistics, the FAST update) runs under ``torch.func.vmap``
over the stream axis.  A vmapped Hamming call is one batched launch (the
operator's vmap rule in ``ops/cuda_hamming.py``), so a frame launches each
kernel as often as a single-stream frame does, whatever B is: 4 FAST
(one per pyramid level), 2 patch gathers (ORB, LBD) and 4 Hamming (stereo
and f2f, points and lines).  All state is (B,)-leading on the device; a
step makes no host sync.

With ``sharding`` (a 1-D ``DeviceMesh``, axis "seq") each rank tracks its
contiguous block of B / world streams: ``process`` takes the global (B,
H, W) stacks, runs the rank's (2 B_local, H, W) detection and vmapped step
on its own card, and returns the rank's (B_local,) block;
``gather_result`` rebuilds the (B,) result on every rank.

Semantics per stream are ``VisualOdometry``'s: the same functions, the
same state.  The (2B, H, W) detection equals the per-stream (2, H, W) one
on the CPU; on the card the batched products may round differently, so a
stream is held to its single-stream run within a tolerance, not bit for
bit.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .core.camera import StereoCamera
from .device import on_device
from .frontend.features import StereoFeatures
from .frontend.frame import (FrontendConfig, _detect_describe_lines_batch,
                             _detect_describe_points_batch)
from .frontend.tracker import TrackerConfig
from .vo import (FrameResult, GraphedStep, VOParams, VOState, match_and_track,
                 match_stereo)


def _unflatten(tree, B: int):
    """(2B, ...) leaves of a detector output -> (B, 2, ...)."""
    if isinstance(tree, torch.Tensor):
        return tree.reshape((B, 2) + tree.shape[1:])
    out = [_unflatten(x, B) for x in tree]
    return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)


class BatchedVisualOdometry(GraphedStep):
    """Track ``batch`` stereo streams in lockstep.  ``process`` takes (B, H,
    W) left and right images and returns a ``FrameResult`` whose fields
    carry a leading (B,) axis: this rank's (B / world,) block when
    ``sharding`` is a 1-D ``DeviceMesh`` (its device type that of
    ``device``).  As ``VisualOdometry``, ``process`` is one replay of the
    captured step (detection and the vmapped step) over static buffers,
    one program per image shape; ``capture=False`` runs it eagerly."""

    def __init__(self, batch: int, cam: StereoCamera, fcfg: FrontendConfig = FrontendConfig(),
                 tcfg: TrackerConfig = TrackerConfig(), *, device="cuda",
                 dtype=torch.float32, adaptative_fast: bool = True,
                 use_motion_model: bool = False, sharding: Optional[DeviceMesh] = None,
                 capture: bool = True):
        self.device = torch.device(device)
        self.sharding = sharding
        # batch: the streams of a frame; B, offset: this rank's block of them
        self.batch = batch
        self.B = batch
        self.offset = 0
        if sharding is not None:
            if not isinstance(sharding, DeviceMesh) or sharding.ndim != 1:
                raise TypeError("sharding must be a 1-D DeviceMesh")
            if sharding.device_type != self.device.type:
                raise ValueError(f"a {sharding.device_type} mesh for streams on {self.device}")
            n = sharding.size()
            if batch % n:
                raise ValueError(f"batch {batch} does not divide over {n} ranks")
            self.B = batch // n
            self.offset = sharding.get_local_rank() * self.B
        self.cam = cam
        self.fcfg = fcfg
        self.tcfg = tcfg
        self.dtype = dtype
        self.params = VOParams(adaptative_fast=adaptative_fast,
                               use_motion_model=use_motion_model)
        self._match = torch.func.vmap(functools.partial(match_stereo, cam=cam, fcfg=fcfg))
        self._step = torch.func.vmap(functools.partial(
            match_and_track, cam=cam, fcfg=fcfg, tcfg=tcfg, prm=self.params))
        self._init_graphs(capture)

    def _check(self, img_l: torch.Tensor, img_r: torch.Tensor) -> tuple:
        if not (on_device(img_l, self.device) and on_device(img_r, self.device)):
            raise ValueError(f"images must be on {self.device}, got "
                             f"{img_l.device}, {img_r.device}")
        if img_l.dim() != 3 or img_l.shape[0] != self.batch or img_r.shape != img_l.shape:
            raise ValueError(f"want two ({self.batch}, H, W) stacks, got "
                             f"{tuple(img_l.shape)}, {tuple(img_r.shape)}")
        return tuple(img_l.shape[1:])

    def _fill(self, flat: torch.Tensor, img_l: torch.Tensor, img_r: torch.Tensor) -> None:
        """This rank's streams of the (B, H, W) stacks into the flat (2
        B_local, H, W) f32 buffer, stream b's pair at 2b and 2b + 1."""
        mine = slice(self.offset, self.offset + self.B)
        pairs = flat.view((self.B, 2) + flat.shape[1:])
        pairs[:, 0].copy_(img_l[mine])
        pairs[:, 1].copy_(img_r[mine])

    def _detect(self, flat: torch.Tensor, fast_th: torch.Tensor):
        """One detection call per kind on the flat stack, reshaped to (B, 2, ...)."""
        pts = _detect_describe_points_batch(flat, self.fcfg, fast_th.repeat_interleave(2))
        ls = _detect_describe_lines_batch(flat, self.fcfg)
        return _unflatten(pts, self.B), _unflatten(ls, self.B)

    def initialize(self, img_l: torch.Tensor, img_r: torch.Tensor) -> StereoFeatures:
        """The first frames of every stream; returns their (B,)-leading
        features."""
        B, dev, dt = self.B, self.device, self.dtype
        flat = self._image_buffer(self._check(img_l, img_r))
        self._fill(flat, img_l, img_r)
        th = torch.full((B,), self.fcfg.fast_th, dtype=torch.float32, device=dev)
        feats = self._match(*self._detect(flat, th))
        I = torch.eye(4, dtype=dt, device=dev).expand(B, 4, 4).clone()
        Z = torch.zeros((B, 6, 6), dtype=dt, device=dev)
        self.state = VOState(
            features=feats, T_f_w=I, T_f_w_cov=Z, T_prevKF=I.clone(),
            cov_prevKF_accum=Z.clone(),
            entropy_first=torch.full((B,), -9.9e8, dtype=dt, device=dev),
            frames_since_kf=torch.zeros((B,), dtype=torch.int32, device=dev),
            prev_was_kf=torch.ones((B,), dtype=torch.bool, device=dev),
            fast_th=th.clone(), prev_DT=I.clone(),
            prev_good=torch.zeros((B,), dtype=torch.bool, device=dev))
        return feats

    def _image_buffer(self, hw: tuple) -> torch.Tensor:
        return torch.zeros((2 * self.B,) + hw, dtype=torch.float32, device=self.device)

    def _advance(self, flat: torch.Tensor, state: VOState):
        kp_pair, seg_pair = self._detect(flat, state.fast_th)
        return self._step(kp_pair, seg_pair, state)

    def process(self, img_l: torch.Tensor, img_r: torch.Tensor) -> FrameResult:
        """One tracking step of every stream: one replay."""
        hw = self._check(img_l, img_r)
        return self._replay(hw, lambda flat: self._fill(flat, img_l, img_r))

    def gather_result(self, res: FrameResult) -> FrameResult:
        """The (B,) result of every rank's (B_local,) block, on every rank
        (``res`` itself when unsharded)."""
        if self.sharding is None:
            return res
        group = self.sharding.get_group()

        def gather(x):
            part = x.contiguous()
            if part.dtype == torch.bool:
                return gather(part.view(torch.uint8)).view(torch.bool)
            parts = [torch.empty_like(part) for _ in range(self.sharding.size())]
            dist.all_gather(parts, part, group=group)
            return torch.cat(parts)

        return FrameResult(*(gather(x) for x in res))

    def mark_keyframe(self, mask) -> None:
        """Reset the keyframe statistics of the streams where ``mask`` (B,)
        is true, in the static state."""
        st = self._state
        m = torch.as_tensor(mask, dtype=torch.bool, device=self.device)
        if m.shape != (self.batch,):
            raise ValueError(f"mark_keyframe: want a ({self.batch},) mask, got {tuple(m.shape)}")
        m = m[self.offset:self.offset + self.B]

        def sel(new, old):
            return torch.where(m.reshape((-1,) + (1,) * (old.dim() - 1)), new, old)

        st.T_prevKF.copy_(sel(st.T_f_w, st.T_prevKF))
        st.cov_prevKF_accum.copy_(sel(torch.zeros_like(st.cov_prevKF_accum),
                                      st.cov_prevKF_accum))
        st.frames_since_kf.copy_(sel(torch.zeros_like(st.frames_since_kf), st.frames_since_kf))
        st.prev_was_kf.copy_(sel(torch.ones_like(st.prev_was_kf), st.prev_was_kf))
