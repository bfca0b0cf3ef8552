"""Full SLAM pipeline: tracking front end + mapping worker thread + local
BA + global BA (``plslam_tpu.pipeline``; reference
``app/plslam_dataset.cpp`` main loop :43-194: per frame track, on a
keyframe MapHandler::addKeyFrame, at the end globalBundleAdjustment
:169-176 and SaveKeyFrameTrajectoryTUM).

Not ported yet (ROADMAP queue 1), each raising ``NotImplementedError``:
endpoint-line mapping, ``has_refinement``, loop closure, the distributed
GBA (``mesh=``), overlays, the live scene export and checkpoints.  As in
the reference, loop closure is refused outright in Pluecker mode.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from plslam_tpu.io.trajectory import save_tum

from . import config as C
from .backend.mapping import MapConfig, MapHandler
from .config import PLSLAMConfig
from .core.camera import StereoCamera
from .vo import VisualOdometry


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to plslam_tpu_torch yet "
                               f"(ROADMAP queue 1: {item})")


@dataclass
class FrameLog:
    """Per-frame metrics."""

    frame: int
    t_total: float
    n_inliers: int
    err: float
    good: bool
    is_kf: bool
    entropy_ratio: float


class PLSLAM:
    """Stereo point+line SLAM on ``device``.  With
    ``config.multithread_slam`` (the default) mapping runs on a worker
    thread fed by a bounded keyframe queue."""

    def __init__(self, cam: StereoCamera, config: PLSLAMConfig | None = None,
                 map_cfg: MapConfig | None = None, *, device):
        self.config = cfg = config or PLSLAMConfig()
        if cfg.use_line_plucker and cfg.use_loop_closure:
            raise ValueError(
                "loop closure cannot be enabled in Pluecker line mode "
                "(reference constraint, README.md:12); set "
                "use_line_plucker=False for the loop-closure baseline")
        if cfg.use_loop_closure:
            raise _not_ported("loop closure", "loop closure")
        if cfg.overlay_every > 0:
            raise _not_ported("overlay_every", "overlays")
        if cfg.viz_every_kf > 0:
            raise _not_ported("viz_every_kf", "viz")
        if cfg.checkpoint_every_kf > 0:
            raise _not_ported("checkpoint_every_kf", "checkpoints")
        self.cam = cam
        self.device = torch.device(device)
        self.vo = VisualOdometry(cam, C.frontend(cfg, max(int(cam.width), int(cam.height))),
                                 C.tracker(cfg), device=self.device)
        mcfg = map_cfg or MapConfig(
            use_lines=cfg.has_lines, plucker_lines=cfg.use_line_plucker,
            min_lm_obs=cfg.min_lm_obs, min_lm_cov_graph=cfg.min_lm_cov_graph,
            min_kf_local_map=cfg.min_kf_local_map, has_refinement=cfg.has_refinement,
            min_pt_matches=cfg.min_pt_matches)
        self.mapper = MapHandler(cam, mcfg, C.ba(cfg), tracker_cfg=C.tracker(cfg),
                                 device=self.device)
        self.logs: list[FrameLog] = []
        self.kf_timestamps: list[float] = []
        self._frame_idx = 0
        self._initialized = False

        self._kf_queue: queue.Queue | None = None
        self._map_thread: threading.Thread | None = None
        self._map_errors: list[BaseException] = []
        if cfg.multithread_slam:
            # bounded: an unbounded tracker run-ahead makes every mapping
            # copy wait behind the queued work of all the frames between
            self._kf_queue = queue.Queue(maxsize=2)
            self._map_thread = threading.Thread(target=self._mapping_worker,
                                                name="plslam-mapper", daemon=True)
            self._map_thread.start()

    # -- mapping thread ----------------------------------------------------

    def _mapping_worker(self):
        """Pop (pose, features) jobs until the None sentinel
        (mapHandler.cpp:1229-1248)."""
        while True:
            job = self._kf_queue.get()
            try:
                if job is None:
                    return
                self._insert_keyframe(*job)
            except BaseException as e:  # surfaced at finish()
                self._map_errors.append(e)
            finally:
                self._kf_queue.task_done()

    def _insert_keyframe(self, pose, feats):
        # the local BA's copy and write-back overlap the next keyframe's
        # association (mapHandler.cpp:1251-1300)
        self.mapper.add_keyframe(pose, feats, defer_ba=True)

    def _submit(self, pose, feats):
        if self._kf_queue is not None:
            self._kf_queue.put((pose, feats))
        else:
            self._insert_keyframe(pose, feats)

    def insert_keyframe_features(self, pose: np.ndarray, feats, timestamp: float = 0.0):
        """Feature-level keyframe insertion (replay and simulation): the
        same queue and worker as live tracking, without image extraction."""
        self.kf_timestamps.append(timestamp)
        if len(self.mapper.map.keyframes) == 0:
            self.mapper.initialize(np.asarray(pose, np.float64), feats)
            return
        self._submit(np.asarray(pose, np.float64), feats)

    def wait_until_idle(self):
        """Block until the keyframe queue has drained, then apply any
        deferred local-BA result."""
        if self._kf_queue is not None:
            self._kf_queue.join()
        self.mapper.flush_ba()

    # -- per-frame ---------------------------------------------------------

    @staticmethod
    def _pack_frame_scalars(res) -> torch.Tensor:
        """One (21,) f32 buffer of everything the host needs per frame."""
        f32 = torch.float32
        return torch.cat([
            torch.stack([res.is_kf.to(f32), res.n_inliers.to(f32), res.err.to(f32),
                         res.good.to(f32), res.entropy_ratio.to(f32)]),
            res.T_f_w.reshape(-1).to(f32)])

    def _image(self, img) -> torch.Tensor:
        return torch.as_tensor(img, dtype=torch.float32, device=self.device)

    def process(self, img_l, img_r, timestamp: float = 0.0):
        """Track one stereo pair; a keyframe goes to the mapping worker."""
        t0 = time.time()
        il, ir = self._image(img_l), self._image(img_r)
        if not self._initialized:
            self.mapper.initialize(np.eye(4), self.vo.initialize(il, ir))
            self.kf_timestamps.append(timestamp)
            self._initialized = True
            self._frame_idx += 1
            return None
        res = self.vo.process(il, ir)
        sc = self._pack_frame_scalars(res).cpu().numpy()
        is_kf = bool(sc[0] > 0.5)
        if is_kf:
            pose = sc[5:21].reshape(4, 4).astype(np.float64)
            feats = self.vo.current_features
            self.vo.mark_keyframe()
            self.kf_timestamps.append(timestamp)
            self._submit(pose, feats)
        self.logs.append(FrameLog(frame=self._frame_idx, t_total=time.time() - t0,
                                  n_inliers=int(sc[1]), err=float(sc[2]),
                                  good=bool(sc[3] > 0.5), is_kf=is_kf,
                                  entropy_ratio=float(sc[4])))
        self._frame_idx += 1
        return res

    # -- end of run --------------------------------------------------------

    def finish(self, run_gba: bool = True, mesh=None):
        """finishSLAM + globalBundleAdjustment (app:169-176): drain and
        join the mapping thread, raise the first error it met, then run
        the global BA."""
        if mesh is not None:
            raise _not_ported("the distributed GBA (mesh=)", "distribution")
        if self._map_thread is not None:
            self._kf_queue.put(None)
            self._map_thread.join()
            self._map_thread = None
            self._kf_queue = None
        if self._map_errors:
            raise self._map_errors[0]
        if run_gba and len(self.mapper.map.keyframes) >= 3:
            self.global_bundle_adjustment()
        return self.keyframe_trajectory()

    def global_bundle_adjustment(self, mesh=None):
        """Chunked single-device GBA over every keyframe and landmark
        (mapHandler.cpp globalBundleAdjustment :3022)."""
        if mesh is not None:
            raise _not_ported("the distributed GBA (mesh=)", "distribution")
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

    def save_checkpoint(self, path: str):
        raise _not_ported("checkpoints", "checkpoints")

    def load_checkpoint(self, path: str):
        raise _not_ported("checkpoints", "checkpoints")
