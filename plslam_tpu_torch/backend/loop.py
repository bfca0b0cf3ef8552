"""Loop closing: BoW retrieval, relative-pose verification, pose-graph
correction, landmark fusion (``plslam_tpu.backend.loop``; reference
``src/mapHandler.cpp`` insertKFBowVectorP/L/PL :4118-4239,
lookForLoopCandidates :4241-4301, isLoopClosure :4303-4411,
computeRelativePoseRobustGN :4677-5068 and its gates :4988-5023,
loopClosureOptimizationCovGraphG2O :5301-5531, loopClosureFuseLandmarks
:5533-5807).

Used only in the endpoint-line configuration (the Pluecker mode refuses
loop closure, README.md:12; enforced in ``pipeline.py``).  BoW encoding,
brute-force matching (through the Hamming kernel), the relative-pose GN
and the float64 PGO run on the mapper's device; the BoW scores, candidate
gating and landmark fusion are host numpy.  Every tensor is built from the
host copies of ``KeyframeRecord``, never from ``rec.dev``, which the
mapping thread drops for old keyframes.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import graphs
from ..core import lie
from ..core.camera import StereoCamera
from ..frontend.features import TrackedLines, TrackedPoints
from ..frontend.tracker import TrackerConfig, optimize_pose
from ..ops import matching as M
from . import pgo as pgo_mod
from . import vocab as vocab_mod
from .mapping import (GRAPH_BUCKETS, KeyframeRecord, MapHandler, _np_normalize_plucker,
                      _np_transform_plucker, _upload)


@dataclass
class LoopConfig:
    lc_kf_dist: int = 50        # min KFs back for a candidate (:4260)
    lc_nkf_closest: int = 4     # temporally-near support count (:4297)
    lc_support_ratio: float = 0.8
    lc_res: float = 1.0         # max residual of the relative pose
    lc_unc: float = 0.01        # max covariance entry
    lc_trs: float = 1.5         # max translation (m)
    lc_rot: float = 35.0        # max rotation (degrees)
    lc_inlier_ratio: float = 30.0  # % match ratio gate (slamConfig.cpp:83)
    min_pt_matches: int = 12
    min_ls_matches: int = 6     # SlamConfig::minLineMatches (slamConfig:86)
    vocab_k: int = 8
    vocab_depth: int = 3
    # retrain the online vocabulary every N keyframes (0 = train once);
    # ignored with a pretrained vocabulary_file
    vocab_refresh_kfs: int = 50
    vocabulary_file: str = ""   # pretrained DBoW2 yml(.gz); "" = online
    vocabulary_file_l: str = "" # line-descriptor vocabulary (dbow_voc_l)
    use_line_bow: bool = True   # combined P+L scoring (insertKFBowVectorPL)
    pgo_graph: str = "covisibility"  # or "essential" (:5070 vs :5301)
    min_lm_ess_graph: int = 150      # essential-graph edge threshold
    pgo_iters: int = 15
    # 3D fusion gates of loopClosureFuseLandmarks (slamConfig.cpp:54,
    # :129-131), widened with depth as max(gate, fuse_sigma_px z^2/(fx b))
    fuse_dist: float = 0.1      # point-point (m)
    fuse_dist_pl: float = 0.1   # midpoint-to-line (m)
    fuse_dist_dir: float = 0.1  # sin(angle of directions)
    fuse_sigma_px: float = 1.0
    lc_kf_max_dist: int = 50    # temporal support window radius (:4286)


def build_pgo_edges(covis: np.ndarray, T_old: np.ndarray, covis_th: int,
                    kf_id: int, cand_id: int, T_rel: np.ndarray):
    """Pose-graph edges of a loop closure: consecutive odometry edges,
    covisibility edges between non-adjacent KFs sharing >= covis_th
    landmarks (mapHandler.cpp:5380), and the loop edge measured by the
    verified relative pose; identity information on every edge (:5375-5417)."""
    K = len(T_old)
    e_i, e_j, e_T, e_w = [], [], [], []
    for i in range(K - 1):
        e_i.append(i)
        e_j.append(i + 1)
        e_T.append(np.linalg.inv(T_old[i]) @ T_old[i + 1])
        e_w.append(1.0)
    ii, jj = np.where(np.triu(covis, 2) >= covis_th)
    for i, j in zip(ii.tolist(), jj.tolist()):
        e_i.append(i)
        e_j.append(j)
        e_T.append(np.linalg.inv(T_old[i]) @ T_old[j])
        e_w.append(1.0)
    # T_rel maps cand-frame points into the kf frame: Z = T_cand^-1 T_kf
    e_i.append(cand_id)
    e_j.append(kf_id)
    e_T.append(np.linalg.inv(T_rel))
    e_w.append(1.0)
    return e_i, e_j, e_T, e_w


def _empty_lines(n: int, device) -> TrackedLines:
    z = functools.partial(torch.zeros, dtype=torch.float32, device=device)
    f = torch.zeros(n, dtype=torch.bool, device=device)
    return TrackedLines(sP=z((n, 3)), eP=z((n, 3)), sp=z((n, 2)), ep=z((n, 2)),
                        NDc=z((n, 6)), sobs=z((n, 2)), eobs=z((n, 2)), le_obs=z((n, 3)),
                        sigma2=torch.ones(n, device=device), valid=f, inlier=f)


class LoopCloser:
    """Host orchestrator of loop detection, verification and correction."""

    def __init__(self, cam: StereoCamera, mapper: MapHandler,
                 cfg: LoopConfig = LoopConfig()):
        self.cam = cam
        self.mapper = mapper
        self.cfg = cfg
        self.device = mapper.device
        self.voc: vocab_mod.Vocabulary | None = None    # on self.device
        self.voc_l: vocab_mod.Vocabulary | None = None
        self.bow: list[dict] = []             # per-KF BoW records
        self.conf: np.ndarray = np.zeros((0, 0), np.float32)
        self.closed_at: int = -10 ** 9
        # the BoW transform's programs, one per (vocabulary, N), built on
        # the current vocabularies, and the verification's pose solve, one
        # per bucket (all dropped when the vocabularies change); captured as
        # the mapper's programs are
        self.programs = graphs.ProgramCache(GRAPH_BUCKETS)
        self.verify_ms: list[float] = []   # wall ms of each candidate's verification
        # the pose solve's programs: captures, and calls that replayed one
        self.solve_counts = {"solves": 0, "captures": 0, "replays": 0}

    # -- BoW bookkeeping ---------------------------------------------------

    def _ensure_vocab(self, kf_id: int | None = None) -> bool:
        """Load the pretrained DBoW2 vocabulary when configured
        (mapHandler.cpp:41-44), else train one online from the keyframes up
        to ``kf_id`` (the map may already hold newer ones).  Back-fills the
        BoW records and conf rows of the keyframes before ``kf_id``."""
        if self.voc is not None:
            return True
        if kf_id is None:
            kf_id = len(self.mapper.map.keyframes) - 1
        kfs = self.mapper.map.keyframes[: kf_id + 1]
        if self.cfg.vocabulary_file:
            voc = vocab_mod.load_dbow2_vocabulary(self.cfg.vocabulary_file)
        else:
            corpus = np.concatenate([kf.pt_desc[kf.pt_valid] for kf in kfs]) if kfs \
                else np.zeros((0, 8), np.int32)
            if len(corpus) < 500:
                return False
            voc = vocab_mod.train_vocabulary(corpus, k=self.cfg.vocab_k,
                                             depth=self.cfg.vocab_depth, iters=4)
        self.programs.clear()   # their graphs read the old vocabularies
        self.voc = voc.to(self.device)
        if self.cfg.use_line_bow:
            voc_l = None
            if self.cfg.vocabulary_file_l:
                voc_l = vocab_mod.load_dbow2_vocabulary(self.cfg.vocabulary_file_l)
            else:
                lcorpus = np.concatenate([kf.ls_desc[kf.ls_valid] for kf in kfs]) if kfs \
                    else np.zeros((0, 8), np.int32)
                if len(lcorpus) >= 100:
                    voc_l = vocab_mod.train_vocabulary(
                        lcorpus, k=self.cfg.vocab_k,
                        depth=max(self.cfg.vocab_depth - 1, 2), iters=4)
            self.voc_l = None if voc_l is None else voc_l.to(self.device)
        # back-fill every previous keyframe (the caller appends the newest)
        self.bow = [self._bow_of(kf) for kf in kfs[:-1]]
        k = len(self.bow)
        self.conf = np.zeros((k, k), np.float32)
        for i in range(k):
            row = self._score_against(self.bow[i], self.bow[:i])
            self.conf[i, :i] = row
            self.conf[:i, i] = row
        return True

    def _bow_of(self, kf: KeyframeRecord) -> dict:
        """BoW record with the feature-count and spatial-dispersion weights
        of insertKFBowVectorPL (:4182-4213); one copy to the host."""
        vecs = [self._transform("p", kf.pt_desc, kf.pt_valid)]
        if self.voc_l is not None:
            vecs.append(self._transform("l", kf.ls_desc, kf.ls_valid))
        flat = torch.cat(vecs).cpu().numpy()
        uv = kf.pt_uv[kf.pt_valid]
        rec = {"p": flat[: self.voc.num_words], "n_pt": int(len(uv)),
               "std_pt": float(uv[:, 0].std() + uv[:, 1].std()) if len(uv) else 0.0}
        if self.voc_l is not None:
            mid = 0.5 * (kf.ls_sp + kf.ls_ep)[kf.ls_valid]
            rec.update(l=flat[self.voc.num_words:], n_ls=int(len(mid)),
                       std_ls=float(mid[:, 0].std() + mid[:, 1].std()) if len(mid) else 0.0)
        else:
            rec.update(l=None, n_ls=0, std_ls=0.0)
        return rec

    def _transform(self, which: str, desc: np.ndarray, valid: np.ndarray) -> torch.Tensor:
        """``vocab.transform`` of the point ("p") or line ("l") vocabulary
        as one program per (vocabulary, N) over staged descriptors and
        validity: a copy of the BoW vector.  Its ``index_add_`` sums 0/1
        floats, which are exact in any order, so the vector does not move
        with the order of the adds."""
        voc = self.voc if which == "p" else self.voc_l
        arrays = {"desc": np.asarray(desc, np.int32), "valid": np.asarray(valid, bool)}
        # a held program keeps its vocabulary alive, so id(voc) names it
        prog = self.programs.get(
            (which, id(voc), graphs.StagedProgram.key(arrays)),
            lambda: graphs.StagedProgram(lambda x: vocab_mod.transform(voc, x["desc"], x["valid"]),
                                         arrays, self.device, capture=self.mapper.capture))
        return prog(arrays)

    def _score_against(self, a: dict, db: list[dict]) -> np.ndarray:
        """Combined scores of record ``a`` against a list of records, the two
        summed strategies of insertKFBowVectorPL (:4221-4228)."""
        if not db:
            return np.zeros(0, np.float32)
        P = np.stack([b["p"] for b in db])
        sp = 1.0 - 0.5 * np.abs(P - a["p"][None]).sum(-1)
        if a["l"] is None or any(b["l"] is None for b in db):
            return (2.0 * sp).astype(np.float32)
        L = np.stack([b["l"] for b in db])
        sl = 1.0 - 0.5 * np.abs(L - a["l"][None]).sum(-1)
        n_pt, n_ls = a["n_pt"], a["n_ls"]
        n_pl = max(n_pt + n_ls, 1)
        std_pt, std_ls = a["std_pt"], a["std_ls"]
        std_pl = max(std_pt + std_ls, 1e-9)
        return ((sp * n_pt + sl * n_ls) / n_pl
                + (sp * std_pt + sl * std_ls) / std_pl).astype(np.float32)

    def _append_row(self, v: dict):
        self.bow.append(v)
        k = len(self.bow)
        conf = np.zeros((k, k), np.float32)
        conf[: k - 1, : k - 1] = self.conf
        row = self._score_against(v, self.bow[: k - 1])
        conf[k - 1, : k - 1] = row
        conf[: k - 1, k - 1] = row
        self.conf = conf

    def _retrain_vocabulary(self, kf_id: int):
        """Online-vocabulary refresh: retrain on the map's descriptors up to
        ``kf_id``, re-encode every keyframe, rebuild the conf matrix."""
        self.voc = self.voc_l = None
        self.bow = []
        if self._ensure_vocab(kf_id):
            self._append_row(self._bow_of(self.mapper.map.keyframes[kf_id]))

    def on_new_keyframe(self, kf_id: int | None = None) -> dict | None:
        """Encode keyframe ``kf_id``, extend the conf matrix and try one loop
        closure (loopClosure :4053-4116); a report dict when one closed.

        Detection and verification read only the keyframes' immutable host
        features and this object's own state (the covis row is snapshot
        under the map lock), so they run without the lock while the
        mapping thread inserts keyframes; only the correction takes it."""
        mp = self.mapper.map
        if kf_id is None:
            kf_id = len(mp.keyframes) - 1
        if not self._ensure_vocab(kf_id):
            return None
        self._append_row(self._bow_of(mp.keyframes[kf_id]))
        if (self.cfg.vocab_refresh_kfs and not self.cfg.vocabulary_file
                and len(self.bow) % self.cfg.vocab_refresh_kfs == 0):
            self._retrain_vocabulary(kf_id)
        cand = self._look_for_candidates(kf_id)
        if cand is None:
            return None
        t0 = time.perf_counter()
        ok, T_rel, pt_pairs, ls_pairs = self._verify_candidate(kf_id, cand)
        verify_ms = 1e3 * (time.perf_counter() - t0)
        self.verify_ms.append(verify_ms)
        if not ok:
            return None
        with self.mapper._map_lock:
            report = self._close(kf_id, cand, T_rel, pt_pairs, ls_pairs)
        self.closed_at = kf_id
        return {**report, "verify_ms": verify_ms}

    # -- candidate gating (:4241-4301) ------------------------------------

    def _look_for_candidates(self, kf_id: int):
        cfg = self.cfg
        if kf_id - self.closed_at < cfg.lc_kf_dist // 2:
            return None
        old = kf_id - cfg.lc_kf_dist
        if old < 1:
            return None
        scores = self.conf[kf_id, :old]
        if scores.size == 0:
            return None
        best = int(scores.argmax())
        best_score = scores[best]
        # must beat the least covisible keyframe's score (:4260-4279); the
        # mapping thread mutates covis in place, so snapshot the row
        with self.mapper._map_lock:
            covis = self.mapper.map.covis[kf_id][: kf_id + 1].copy()
        cov_ids = np.where(covis > 0)[0]
        if len(cov_ids) and best_score <= float(self.conf[kf_id, cov_ids].min()):
            return None
        # temporal support (:4283-4297)
        w = max(cfg.lc_kf_max_dist, 1)
        near = scores[max(0, best - w): best + w + 1]
        support = int((near >= cfg.lc_support_ratio * best_score).sum())
        if support < min(cfg.lc_nkf_closest, len(near)):
            return None
        return best

    # -- geometric verification (:4303-4411, :4677-5068) -------------------

    def _verify_candidate(self, kf_id: int, cand_id: int):
        """isLoopClosure: brute-force mutual NNR of both modalities (one
        copy of both index vectors), the inlier-ratio gates (:4384-4402),
        then the robust GN relative pose and its acceptance gates
        (:4988-5023).  Returns (ok, DT, pt_pairs, ls_pairs)."""
        mp = self.mapper.map
        kf, old = mp.keyframes[kf_id], mp.keyframes[cand_id]
        fail = (False, None, None, None)
        up = functools.partial(_upload, device=self.device)
        n = len(old.pt_valid)
        idx = [M.match_descriptors(up(old.pt_desc), up(kf.pt_desc),
                                   up(old.pt_valid[:, None] & kf.pt_valid[None, :]), 0.9).idx]
        # the line matches count only with lines on (:4388-4392)
        with_lines = (self.mapper.cfg.use_lines and old.ls_valid.any()
                      and kf.ls_valid.any())
        if with_lines:
            idx.append(M.match_descriptors(
                up(old.ls_desc), up(kf.ls_desc),
                up(old.ls_valid[:, None] & kf.ls_valid[None, :]), 0.9).idx)
        idx = torch.cat(idx).cpu().numpy().astype(np.int64)
        i1 = np.where(idx[:n] >= 0)[0]
        pt_pairs = np.stack([i1, idx[i1]], axis=1)
        if len(pt_pairs) < self.cfg.min_pt_matches:
            return fail
        # inlier-ratio gate: share of either keyframe's features matched
        n0 = max(int(old.pt_valid.sum()), 1)
        n1 = max(int(kf.pt_valid.sum()), 1)
        if max(100.0 * len(pt_pairs) / n0, 100.0 * len(pt_pairs) / n1) \
                <= self.cfg.lc_inlier_ratio:
            return fail

        # robust GN relative pose: old-KF 3D points vs new-KF observations
        P = np.zeros((n, 3), np.float32)
        obs = np.zeros((n, 2), np.float32)
        valid = np.zeros(n, bool)
        P[i1] = old.pt_P[i1]
        obs[i1] = kf.pt_uv[pt_pairs[:, 1]]
        valid[i1] = True
        arrays, ls_pairs = (self._lines_for_verification(old, kf, idx[n:]) if with_lines
                            else (None, None))
        if self.mapper.cfg.use_lines:
            # with both modalities on, both ratios must pass (:4388-4392)
            n_ls = len(ls_pairs) if ls_pairs is not None else 0
            n0 = max(int(old.ls_valid.sum()), 1)
            n1 = max(int(kf.ls_valid.sum()), 1)
            if (max(100.0 * n_ls / n0, 100.0 * n_ls / n1) <= self.cfg.lc_inlier_ratio
                    or n_ls < self.cfg.min_ls_matches):
                return fail
        if arrays is None:
            arrays, ls_pairs = {}, np.zeros((0, 2), np.int64)
        buf = self._solve_pose(dict(P=P, obs=obs, valid=valid, **arrays)).cpu().numpy() \
            .astype(np.float64)
        if not buf[-1] > 0.5:
            return fail
        DT, cov, err = buf[:16].reshape(4, 4), buf[16:52], float(buf[52])
        xi = lie.log_se3(torch.from_numpy(DT)).numpy()
        t_norm = float(np.linalg.norm(xi[:3]))
        r_deg = float(np.degrees(np.linalg.norm(xi[3:])))
        if (err > self.cfg.lc_res or float(np.abs(cov).max()) > self.cfg.lc_unc
                or t_norm > self.cfg.lc_trs or r_deg > self.cfg.lc_rot):
            return fail
        return True, DT, pt_pairs, ls_pairs

    def _solve_pose(self, arrays: dict) -> torch.Tensor:
        """The verification's ``optimize_pose`` as one program per bucket
        (the shapes, and lines or none) over the staged ``TrackedPoints``
        fields P, obs, valid and, with lines, the ``TrackedLines`` fields of
        ``_lines_for_verification``: a copy of the 54 floats DT, cov, err
        and good."""
        cfgT = TrackerConfig(use_lines="lvalid" in arrays, plucker_lines=False)
        cam, dev = self.cam, self.device

        def fn(x):
            n = x["P"].shape[0]
            pts = TrackedPoints(P=x["P"], obs=x["obs"],
                                sigma2=torch.ones(n, device=x["P"].device),
                                valid=x["valid"], inlier=x["valid"])
            if cfgT.use_lines:
                ls = TrackedLines(sP=x["sP"], eP=x["eP"], sp=x["sp"], ep=x["ep"],
                                  NDc=x["NDc"], sobs=x["sobs"], eobs=x["eobs"],
                                  le_obs=x["le"], sigma2=x["ls_sigma2"], valid=x["lvalid"],
                                  inlier=x["lvalid"])
            else:
                ls = _empty_lines(8, x["P"].device)
            est, _, _ = optimize_pose(pts, ls, cam, cfgT)
            return torch.cat([est.DT.reshape(-1), est.cov.reshape(-1), est.err[None],
                              est.good.to(est.DT.dtype)[None]])

        built = []

        def build():
            built.append(graphs.StagedProgram(fn, arrays, dev, capture=self.mapper.capture))
            return built[0]

        prog = self.programs.get(("verify", cfgT, graphs.StagedProgram.key(arrays)), build)
        out = prog(arrays)
        c = self.solve_counts
        c["solves"] += 1
        c["captures"] += bool(built) and prog.program.captured
        c["replays"] += prog.program.captured
        return out

    def _lines_for_verification(self, old: KeyframeRecord, kf: KeyframeRecord,
                                idx: np.ndarray):
        """Line modality of isLoopClosure: the mutual-NNR matches ``idx``
        (old line -> new line or -1) as endpoint correspondences for the GN.
        Returns (the staged ``TrackedLines`` fields of ``_solve_pose``, (M,
        2) pairs), or (None, None) under 3 matches."""
        if (idx >= 0).sum() < 3:
            return None, None
        nl = len(old.ls_valid)
        i1 = np.where(idx >= 0)[0]
        i2 = idx[i1]
        sp, ep = kf.ls_sp[i2].astype(np.float64), kf.ls_ep[i2].astype(np.float64)
        one = np.ones((len(i1), 1))
        lo = np.cross(np.concatenate([sp, one], 1), np.concatenate([ep, one], 1))
        nrm = np.hypot(lo[:, 0], lo[:, 1])
        ok = nrm >= 1e-9
        i1, i2, lo, nrm = i1[ok], i2[ok], lo[ok], nrm[ok]
        sobs = np.zeros((nl, 2), np.float32)
        eobs = np.zeros((nl, 2), np.float32)
        le = np.zeros((nl, 3), np.float32)
        lval = np.zeros(nl, bool)
        sobs[i1], eobs[i1], le[i1] = kf.ls_sp[i2], kf.ls_ep[i2], lo / nrm[:, None]
        lval[i1] = True
        f32 = functools.partial(np.asarray, dtype=np.float32)
        arrays = dict(sP=f32(old.ls_sP), eP=f32(old.ls_eP), sp=f32(old.ls_sp), ep=f32(old.ls_ep),
                      NDc=f32(old.ls_NDc), sobs=sobs, eobs=eobs, le=le,
                      ls_sigma2=f32(old.ls_sigma2), lvalid=lval)
        return arrays, np.stack([i1, i2], axis=1)

    # -- pose-graph correction + fusion (:5301-5531, :5533-5807) -----------

    def _close(self, kf_id: int, cand_id: int, T_rel: np.ndarray,
               pt_pairs: np.ndarray, ls_pairs: np.ndarray) -> dict:
        # a deferred local BA would write stale poses over the correction
        self.mapper.flush_ba()
        t0 = time.perf_counter()
        mp = self.mapper.map
        K = len(mp.keyframes)
        T_old = np.stack([k.T_w_k for k in mp.keyframes])
        essential = self.cfg.pgo_graph == "essential"
        th = self.cfg.min_lm_ess_graph if essential else self.mapper.cfg.min_lm_cov_graph
        e_i, e_j, e_T, e_w = build_pgo_edges(mp.covis, T_old, th, kf_id, cand_id, T_rel)
        dev, f64 = self.device, torch.float64
        ar = torch.arange(K, device=dev)
        To = torch.from_numpy(T_old).to(dev)
        g = pgo_mod.PoseGraph(
            T_w_k=To, fixed=(ar == 0) | (ar == cand_id) if essential else ar == 0,
            valid=torch.ones(K, dtype=torch.bool, device=dev),
            e_i=torch.tensor(e_i, device=dev), e_j=torch.tensor(e_j, device=dev),
            e_T=torch.from_numpy(np.stack(e_T)).to(dev),
            e_info=torch.tensor(e_w, dtype=f64, device=dev),
            e_valid=torch.ones(len(e_i), dtype=torch.bool, device=dev))
        trips = {}
        Tn = pgo_mod.optimize(g, self.cfg.pgo_iters, capture=self.mapper.capture,
                              report=trips).T_w_k
        # rigid landmark correction by owner = first observing keyframe
        # (:5219-5287); one copy back with the poses
        pts = pgo_mod.correct_landmarks(To, Tn, _upload(mp.pt_first_kf, dev),
                                        _upload(mp.pt_w, dev))
        lws = pgo_mod.correct_plucker_landmarks(To, Tn, _upload(mp.ls_first_kf, dev),
                                                _upload(mp.ls_w, dev))
        out = torch.cat([Tn.reshape(-1), pts.reshape(-1), lws.reshape(-1)]).cpu().numpy()
        T_new = out[: K * 16].reshape(K, 4, 4)
        mp.pt_w = out[K * 16: K * 16 + mp.n_pt * 3].reshape(-1, 3)
        mp.ls_w = out[K * 16 + mp.n_pt * 3:].reshape(-1, 6)
        if mp.n_ls:
            # endpoints move rigidly with their owner keyframe too
            D = np.einsum("kij,kjl->kil", T_new, np.linalg.inv(T_old))[mp.ls_first_kf]
            mp.ls_epw = (np.einsum("nij,nej->nei", D[:, :3, :3], mp.ls_epw)
                         + D[:, None, :3, 3])
        for i, kf in enumerate(mp.keyframes):
            kf.T_w_k = T_new[i]
        t1 = time.perf_counter()
        fused = self._fuse_landmarks(kf_id, cand_id, pt_pairs, ls_pairs)
        t2 = time.perf_counter()
        drift = float(np.linalg.norm(T_new[kf_id][:3, 3] - T_old[kf_id][:3, 3]))
        return {"kf": kf_id, "candidate": cand_id, "map_keyframes": K, "fused": fused,
                "correction": drift, "pgo_ms": 1e3 * (t1 - t0), "fuse_ms": 1e3 * (t2 - t1),
                "pgo_trips": trips}

    def _fuse_landmarks(self, kf_id: int, cand_id: int,
                        pt_pairs: np.ndarray, ls_pairs: np.ndarray) -> dict:
        """loopClosureFuseLandmarks (:5533-5807): per matched feature pair
        (i1 in the old KF, i2 in the new KF) and modality, extend a landmark
        to the other side, create one from both observations, or fuse two
        duplicates (the old KF's survives), with covisibility bookkeeping.
        Every case is gated by world-frame distance after the correction;
        the covis bump credits the KF that gains the observation."""
        mp = self.mapper.map
        kf = mp.keyframes[kf_id]
        old = mp.keyframes[cand_id]
        cfg = self.cfg
        stats = {"ext_old": 0, "ext_new": 0, "created": 0, "fused": 0, "gated": 0}
        Ro, to = old.T_w_k[:3, :3], old.T_w_k[:3, 3]
        Rn, tn = kf.T_w_k[:3, :3], kf.T_w_k[:3, 3]

        def run(pairs, f_lm_old, f_lm_new, add_obs, merge, spawn, table,
                lm_attr, lm_valid, ent_old, ent_new, ent_lm, gate):
            # sequential: a pair's case depends on the links the previous
            # pairs rewrote (two pairs may reach one landmark via a merge)
            for i1, i2 in np.asarray(pairs, np.int64).reshape(-1, 2):
                lm0, lm1 = int(f_lm_old[i1]), int(f_lm_new[i2])
                # a feature may still link a culled landmark: unassociated
                if lm0 >= 0 and not lm_valid[lm0]:
                    lm0 = -1
                if lm1 >= 0 and not lm_valid[lm1]:
                    lm1 = -1
                if lm0 < 0 and lm1 >= 0:
                    if not gate(ent_old(i1), ent_lm(lm1)):
                        stats["gated"] += 1
                        continue
                    add_obs([lm1], cand_id, [i1])
                    f_lm_old[i1] = lm1
                    stats["ext_old"] += 1
                elif lm0 >= 0 and lm1 < 0:
                    if not gate(ent_lm(lm0), ent_new(i2)):
                        stats["gated"] += 1
                        continue
                    add_obs([lm0], kf_id, [i2])
                    f_lm_new[i2] = lm0
                    stats["ext_new"] += 1
                elif lm0 < 0 and lm1 < 0:
                    if not gate(ent_old(i1), ent_new(i2)):
                        stats["gated"] += 1
                        continue
                    spawn(i1, i2)
                    stats["created"] += 1
                elif lm0 != lm1:
                    if not gate(ent_lm(lm0), ent_lm(lm1)):
                        stats["gated"] += 1
                        continue
                    moved = merge(lm0, lm1)
                    # re-point every feature of the fused-away landmark
                    for r in moved.tolist():
                        getattr(mp.keyframes[int(table.kf[r])], lm_attr)[int(table.fi[r])] = lm0
                    stats["fused"] += 1

        fx_b = float(self.cam.fx) * float(self.cam.b)

        def _depth_tol(floor, a, b):
            z = max(float(np.linalg.norm(a - to)), float(np.linalg.norm(b - tn)))
            return max(floor, cfg.fuse_sigma_px * z * z / fx_b)

        def pt_gate(a, b):
            return float(np.linalg.norm(a - b)) <= _depth_tol(cfg.fuse_dist, a, b)

        def _line_ent(s, e):
            d = e - s
            return 0.5 * (s + e), d / max(float(np.linalg.norm(d)), 1e-12)

        def ls_gate(a, b):
            (ma, da), (mb, db) = a, b
            d_pl = max(float(np.linalg.norm(np.cross(ma - mb, db))),
                       float(np.linalg.norm(np.cross(mb - ma, da))))
            d_dir = float(np.linalg.norm(np.cross(da, db)))
            return (d_pl <= _depth_tol(cfg.fuse_dist_pl, ma, mb)
                    and d_dir <= cfg.fuse_dist_dir)

        def spawn_pt(i1, i2):
            Pw = (Ro @ old.pt_P[i1] + to)[None]
            ids = mp.new_points(Pw, old.pt_desc[i1][None], cand_id, np.asarray([i1]))
            old.pt_lm[i1] = ids[0]
            mp.add_point_obs(ids, kf_id, np.asarray([i2]))
            kf.pt_lm[i2] = ids[0]

        def merge_pt(lm0, lm1):
            if not mp.pt_valid[lm1] or not mp.pt_valid[lm0]:
                return np.zeros(0, np.int64)
            return mp.merge_point_landmarks(lm0, lm1)

        run(pt_pairs, old.pt_lm, kf.pt_lm, mp.add_point_obs, merge_pt, spawn_pt, mp.pobs,
            "pt_lm", mp.pt_valid,
            ent_old=lambda i1: Ro @ old.pt_P[i1] + to,
            ent_new=lambda i2: Rn @ kf.pt_P[i2] + tn,
            ent_lm=lambda lm: mp.pt_w[lm], gate=pt_gate)

        if ls_pairs is not None and len(ls_pairs):
            def spawn_ls(i1, i2):
                Lw = _np_normalize_plucker(_np_transform_plucker(old.T_w_k,
                                                                 old.ls_NDc[i1][None]))
                ep_w = np.stack([Ro @ old.ls_sP[i1] + to, Ro @ old.ls_eP[i1] + to])[None]
                ids = mp.new_lines(Lw, old.ls_desc[i1][None], cand_id, np.asarray([i1]),
                                   ep_w)
                old.ls_lm[i1] = ids[0]
                mp.add_line_obs(ids, kf_id, np.asarray([i2]))
                kf.ls_lm[i2] = ids[0]

            def merge_ls(lm0, lm1):
                if not mp.ls_valid[lm1] or not mp.ls_valid[lm0]:
                    return np.zeros(0, np.int64)
                return mp.merge_line_landmarks(lm0, lm1)

            run(ls_pairs, old.ls_lm, kf.ls_lm, mp.add_line_obs, merge_ls, spawn_ls, mp.lobs,
                "ls_lm", mp.ls_valid,
                ent_old=lambda i1: _line_ent(Ro @ old.ls_sP[i1] + to, Ro @ old.ls_eP[i1] + to),
                ent_new=lambda i2: _line_ent(Rn @ kf.ls_sP[i2] + tn, Rn @ kf.ls_eP[i2] + tn),
                ent_lm=lambda lm: _line_ent(mp.ls_epw[lm, 0], mp.ls_epw[lm, 1]),
                gate=ls_gate)
        return stats
