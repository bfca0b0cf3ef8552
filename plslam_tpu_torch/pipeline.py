"""Full SLAM pipeline: tracking front end + mapping worker thread + local
BA + global BA (``plslam_tpu.pipeline``; reference
``app/plslam_dataset.cpp`` main loop :43-194: per frame track, on a
keyframe MapHandler::addKeyFrame, at the end globalBundleAdjustment
:169-176 and SaveKeyFrameTrajectoryTUM).

With loop closure (endpoint-line mode only, as in the reference) a third
thread, ``plslam-loopcloser``, encodes every keyframe and closes loops off
the mapping thread.  On the card each worker issues its device work on a
stream of its own, so a keyframe's association and local BA run beside
the tracker's frames rather than ahead of them in one queue; a job waits
for the submitting stream's work on its features first.  Checkpoints save and restore the map and the loop
closer's state in the JAX package's layout.  ``viz_every_kf`` rewrites a
live scene HTML from the mapping thread under the map lock, and
``overlay_every`` renders a diagnosis overlay and a residual record of every
N-th frame (``viz_scene``, ``viz_frame``); a failure of either is logged and
never stops mapping or tracking.  ``finish(mesh=)`` and
``global_bundle_adjustment(mesh=)`` run the kf-block sharded GBA
(``parallel/dist_gba.py``) over a ``DeviceMesh`` of more than one rank.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import queue
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from . import config as C
from .backend.loop import LoopCloser
from .backend.mapping import MapConfig, MapHandler
from .config import PLSLAMConfig
from .core.camera import StereoCamera
from .io.checkpoint import load_map, save_map
from .io.trajectory import save_tum
from .parallel.dist_gba import distributed_global_bundle_adjustment
from .utils.profiling import add, span, timed
from .vo import VisualOdometry

log = logging.getLogger(__name__)


@dataclass
class FrameLog:
    """Per-frame metrics."""

    frame: int
    t_total: float      # seconds in ``process`` (perf_counter)
    n_inliers: int
    err: float
    good: bool
    is_kf: bool
    entropy_ratio: float


class PLSLAM:
    """Stereo point+line SLAM on ``device`` (the card unless the caller
    asks for the CPU).  With
    ``config.multithread_slam`` (the default) mapping runs on a worker
    thread fed by a bounded keyframe queue, and loop closure on a second
    worker fed by an unbounded keyframe-id queue."""

    def __init__(self, cam: StereoCamera, config: PLSLAMConfig | None = None,
                 map_cfg: MapConfig | None = None, *, device="cuda", capture: bool = True):
        self.config = cfg = config or PLSLAMConfig()
        if cfg.use_line_plucker and cfg.use_loop_closure:
            raise ValueError(
                "loop closure cannot be enabled in Pluecker line mode "
                "(reference constraint, README.md:12); set "
                "use_line_plucker=False for the loop-closure baseline")
        self.cam = cam
        self.device = torch.device(device)
        self.vo = VisualOdometry(cam, C.frontend(cfg, max(int(cam.width), int(cam.height))),
                                 C.tracker(cfg), device=self.device, capture=capture)
        mcfg = map_cfg or MapConfig(
            use_lines=cfg.has_lines, plucker_lines=cfg.use_line_plucker,
            min_lm_obs=cfg.min_lm_obs, min_lm_cov_graph=cfg.min_lm_cov_graph,
            min_kf_local_map=cfg.min_kf_local_map, has_refinement=cfg.has_refinement,
            min_pt_matches=cfg.min_pt_matches)
        self.mapper = MapHandler(cam, mcfg, C.ba(cfg), tracker_cfg=C.tracker(cfg),
                                 device=self.device, capture=capture)
        self.loop_closer = (LoopCloser(cam, self.mapper, C.loop_cfg(cfg))
                            if cfg.use_loop_closure else None)
        self.loop_reports: list[dict] = []
        self.logs: list[FrameLog] = []
        self.kf_timestamps: list[float] = []
        self._frame_idx = 0
        self._initialized = False
        self._T_anchor = np.eye(4)   # world pose of a resumed VO chain

        self._kf_queue: queue.Queue | None = None
        self._map_thread: threading.Thread | None = None
        self._map_errors: list[BaseException] = []
        self._lc_queue: queue.Queue | None = None
        self._lc_thread: threading.Thread | None = None
        if cfg.multithread_slam:
            # bounded: an unbounded tracker run-ahead makes every mapping
            # copy wait behind the queued work of all the frames between
            self._kf_queue = queue.Queue(maxsize=2)
            self._map_thread = threading.Thread(target=self._mapping_worker,
                                                name="plslam-mapper", daemon=True)
            self._map_thread.start()
            if self.loop_closer is not None:
                # the loop-closure thread (mapHandler.cpp:1302-1386): BoW
                # encoding and verification must not hold up the bounded
                # keyframe queue
                self._lc_queue = queue.Queue()
                self._lc_thread = threading.Thread(target=self._lc_worker,
                                                   name="plslam-loopcloser", daemon=True)
                self._lc_thread.start()

    # -- worker threads ----------------------------------------------------

    def _worker_stream(self):
        """The calling worker thread's own stream on the card (PyTorch's
        current stream is per thread)."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        return torch.cuda.stream(torch.cuda.Stream(self.device))

    def _mapping_worker(self):
        """Pop (pose, features, ready event) jobs until the None sentinel
        (mapHandler.cpp:1229-1248)."""
        with self._worker_stream():
            while True:
                with span("mapper.queue.idle"):
                    job = self._kf_queue.get()
                try:
                    if job is None:
                        return
                    pose, feats, ready = job
                    if ready is not None:
                        torch.cuda.current_stream(self.device).wait_event(ready)
                    self._insert_keyframe(pose, feats)
                except BaseException as e:  # surfaced at finish()
                    self._map_errors.append(e)
                finally:
                    self._kf_queue.task_done()

    def _lc_worker(self):
        """Pop keyframe ids until the None sentinel; a closure's correction
        is the only step that takes the map lock (``LoopCloser``).  It
        reads host copies only, so its stream waits for no other."""
        with self._worker_stream():
            while True:
                kf_id = self._lc_queue.get()
                try:
                    if kf_id is None:
                        return
                    self._close_loops(kf_id)
                except BaseException as e:  # surfaced at finish()
                    self._map_errors.append(e)
                finally:
                    self._lc_queue.task_done()

    def _close_loops(self, kf_id: int):
        report = self.loop_closer.on_new_keyframe(kf_id)
        if report:
            self.loop_reports.append(report)

    def _to_loop_closer(self, kf_id: int):
        if self._lc_queue is not None:
            self._lc_queue.put(kf_id)
        else:
            self._close_loops(kf_id)

    def _insert_keyframe(self, pose, feats):
        with timed("mapper.keyframe"):
            # the local BA's copy and write-back overlap the next keyframe's
            # association (mapHandler.cpp:1251-1300)
            self.mapper.add_keyframe(pose, feats, defer_ba=True)
            every = self.config.viz_every_kf
            if every > 0 and len(self.mapper.map.keyframes) % every == 0:
                self._export_scene()
            if self.loop_closer is not None:
                self._to_loop_closer(len(self.mapper.map.keyframes) - 1)

    def _export_scene(self):
        """Rewrite the live scene HTML (slamScene updateSceneSafe analog).
        The map lock keeps it from reading a half-applied loop-closure
        correction; a failure never kills the mapping worker."""
        from .viz_scene import export_scene_html

        try:
            with self.mapper._map_lock:
                export_scene_html(self.mapper, self.config.viz_path)
        except Exception:
            log.exception("live scene export failed")

    def _submit(self, pose, feats):
        add("pipeline.keyframes")
        if self._kf_queue is not None:
            ready = None
            if self.device.type == "cuda":
                # the features' producing work on this thread's stream
                ready = torch.cuda.Event()
                ready.record()
            with timed("pipeline.kf_queue.wait"):
                self._kf_queue.put((pose, feats, ready))
        else:
            self._insert_keyframe(pose, feats)

    def insert_keyframe_features(self, pose: np.ndarray, feats, timestamp: float = 0.0):
        """Feature-level keyframe insertion (replay and simulation): the
        same queues and workers as live tracking, without image extraction."""
        self.kf_timestamps.append(timestamp)
        if len(self.mapper.map.keyframes) == 0:
            self.mapper.initialize(np.asarray(pose, np.float64), feats)
            if self.loop_closer is not None:
                self._to_loop_closer(0)
            return
        self._submit(np.asarray(pose, np.float64), feats)

    def wait_until_idle(self):
        """Block until the keyframe and loop-closure queues have drained,
        then apply any deferred local-BA result."""
        with span("pipeline.drain.wait"):
            if self._kf_queue is not None:
                self._kf_queue.join()
            if self._lc_queue is not None:
                self._lc_queue.join()
            self.mapper.flush_ba()

    # -- per-frame ---------------------------------------------------------

    def _image(self, img) -> torch.Tensor:
        """One image on ``self.device``, in the dtype it was handed (a raw
        camera frame's uint8 crosses as a quarter of its float32 bytes).
        It becomes float32 on the device, in the VO step's fill copy or
        ``initialize``'s stack, with the values a host cast gives; from
        pinned host memory the copy is asynchronous on this thread's
        stream."""
        t = torch.as_tensor(img)
        if t.dtype != torch.float32:
            add("pipeline.upload.on_card_cast")
        pinned = self.device.type == "cuda" and t.device.type == "cpu" and t.is_pinned()
        if pinned:
            add("pipeline.upload.async")
        return t.to(self.device, non_blocking=pinned)

    def process(self, img_l, img_r, timestamp: float = 0.0):
        """Track one stereo pair; a keyframe goes to the mapping worker."""
        with timed("pipeline.process"):
            return self._process(img_l, img_r, timestamp)

    def _process(self, img_l, img_r, timestamp: float):
        t0 = time.perf_counter()
        with timed("pipeline.upload"):
            il, ir = self._image(img_l), self._image(img_r)
        if not self._initialized:
            copied = None
            if self.device.type == "cuda":
                # the caller may reuse a pinned source once this returns
                copied = torch.cuda.Event()
                copied.record(torch.cuda.current_stream(self.device))
            self.vo.prewarm(il.shape)
            feats = self.vo.initialize(il, ir)
            if len(self.mapper.map.keyframes) == 0:
                self.mapper.initialize(np.eye(4), feats)
                if self.loop_closer is not None:
                    self._to_loop_closer(0)
            else:
                # resume from a checkpoint: the fresh VO chain starts at the
                # last restored keyframe, and this frame extends the map
                self._T_anchor = self.mapper.map.keyframes[-1].T_w_k.copy()
                self._submit(self._T_anchor.copy(), feats)
            self.kf_timestamps.append(timestamp)
            self._initialized = True
            self._frame_idx += 1
            if copied is not None:
                copied.synchronize()
            return None
        every = self.config.overlay_every
        # copies, taken on this thread's stream before the next replay
        # changes the static features
        prev_feats = self.vo.current_features if every > 0 else None
        res = self.vo.process(il, ir)
        # the frame's one host copy: its scalars and the GN trips used (it
        # also waits for the images' copies from a pinned source)
        with timed("pipeline.scalars.wait"):
            rec = self.vo.frame_record.cpu().numpy()
        sc = rec[:21]
        tcfg = self.vo.tcfg
        add("vo.gn_trips_used", int(rec[21]))
        add("vo.gn_trips_unrolled", tcfg.max_iters + tcfg.max_iters_ref)
        is_kf = bool(sc[0] > 0.5)
        if every > 0 and self._frame_idx % every == 0:
            self._render_overlay(il, prev_feats, res)
        if is_kf:
            pose = self._T_anchor @ sc[5:21].reshape(4, 4).astype(np.float64)
            feats = self.vo.current_features
            self.vo.mark_keyframe()
            self.kf_timestamps.append(timestamp)
            self._submit(pose, feats)
            if self.config.checkpoint_every_kf > 0:
                self.maybe_autocheckpoint()
        self.logs.append(FrameLog(frame=self._frame_idx, t_total=time.perf_counter() - t0,
                                  n_inliers=int(sc[1]), err=float(sc[2]),
                                  good=bool(sc[3] > 0.5), is_kf=is_kf,
                                  entropy_ratio=float(sc[4])))
        self._frame_idx += 1
        return res

    def _render_overlay(self, il, prev_feats, res):
        """Diagnosis overlay and residual record of this frame (viz_frame);
        a failure is logged and never stops tracking."""
        from . import viz_frame

        try:
            diag = viz_frame.compute_frame_diagnostics(
                prev_feats, self.vo.current_features, res.DT, self.cam, C.tracker(self.config))
            d = self.config.overlay_dir
            viz_frame.render_frame_overlay(
                il.cpu().numpy(), diag, os.path.join(d, f"overlay_{self._frame_idx:06d}.png"),
                frame_id=self._frame_idx)
            viz_frame.dump_residuals_jsonl(diag, os.path.join(d, "residuals.jsonl"),
                                           self._frame_idx)
        except Exception:
            log.exception("overlay render failed")

    # -- end of run --------------------------------------------------------

    def finish(self, run_gba: bool = True, mesh=None):
        """finishSLAM + globalBundleAdjustment (app:169-176): drain and
        join the mapping and loop-closure threads, raise the first error
        either met, then run the global BA (on ``mesh`` when one is passed:
        see ``global_bundle_adjustment``)."""
        if self._map_thread is not None:
            self._kf_queue.put(None)
            self._map_thread.join()
            self._map_thread = None
            self._kf_queue = None
        if self._lc_thread is not None:
            self._lc_queue.put(None)
            self._lc_thread.join()
            self._lc_thread = None
            self._lc_queue = None
        if self._map_errors:
            raise self._map_errors[0]
        if run_gba and len(self.mapper.map.keyframes) >= 3:
            self.global_bundle_adjustment(mesh=mesh)
        return self.keyframe_trajectory()

    def global_bundle_adjustment(self, mesh=None):
        """GBA over every keyframe and landmark (mapHandler.cpp
        globalBundleAdjustment :3022): the chunked single-device solve, or,
        with a ``DeviceMesh`` of more than one rank, the same solve with its
        chunks sharded over the mesh (``parallel/dist_gba.py``; every rank
        calls it with the same map)."""
        if mesh is not None:
            if not isinstance(mesh, DeviceMesh):
                raise TypeError(f"mesh must be a DeviceMesh, got {type(mesh).__name__}")
            if mesh.size() > 1:
                return distributed_global_bundle_adjustment(self.mapper, mesh)
        return self.mapper.global_bundle_adjustment()

    def keyframe_trajectory(self):
        return self.mapper.keyframe_trajectory()

    def save_trajectory_tum(self, path: str):
        """TUM t x y z qx qy qz qw per keyframe (SaveKeyFrameTrajectoryTUM
        :5818)."""
        save_tum(path, self.kf_timestamps, self.keyframe_trajectory())

    def save_logs_jsonl(self, path: str):
        """Per-frame metrics as JSON lines."""
        with open(path, "w") as f:
            for log in self.logs:
                f.write(json.dumps(vars(log)) + "\n")

    # -- checkpoint / resume ----------------------------------------------

    def save_checkpoint(self, path: str):
        """Save the map and loop-closer state; safe mid-run (drains the
        queues first)."""
        self.wait_until_idle()
        save_map(path, self.mapper, loop_closer=self.loop_closer)

    def load_checkpoint(self, path: str):
        """Restore a saved map (of either package) into this pipeline; the
        next processed frame re-initializes the VO anchored at the last
        restored keyframe, and GBA and trajectory queries work at once."""
        self.wait_until_idle()
        load_map(path, self.mapper, loop_closer=self.loop_closer)
        self._initialized = False

    def maybe_autocheckpoint(self):
        """Every ``checkpoint_every_kf`` keyframes of the front end, save
        ``map_kfNNNNN.npz`` (named after the drained map's keyframe count)
        into ``checkpoint_dir``."""
        n = len(self.kf_timestamps)
        every = self.config.checkpoint_every_kf
        if every > 0 and n > 0 and n % every == 0:
            os.makedirs(self.config.checkpoint_dir, exist_ok=True)
            self.wait_until_idle()
            self.save_checkpoint(os.path.join(
                self.config.checkpoint_dir, f"map_kf{len(self.mapper.map.keyframes):05d}.npz"))
