"""Unified configuration tree, YAML-compatible with the reference, and
builders from it to the port's config types.

``PLSLAMConfig`` is the port's own copy of the JAX package's dataclass
(``plslam_tpu/config.py``; reference ``src2/config.cpp`` and
``src/slamConfig.cpp``): the same fields, defaults and ``from_yaml``
(``tests/test_torch_io.py`` holds them equal), except that ``from_yaml``
reads a float field written without a dot (``1e-7``) as the float the
reference's yaml-cpp gives, where PyYAML's YAML 1.1 leaves a string.  The builders are module
functions that read its fields and return the port's types; they take any
object with those fields.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

try:
    import yaml
except Exception:  # pragma: no cover - yaml is in the base image
    yaml = None

from .backend.ba import BAConfig
from .backend.loop import LoopConfig
from .backend.mapping import MapConfig
from .frontend.frame import FrontendConfig
from .frontend.tracker import TrackerConfig


@dataclass
class PLSLAMConfig:
    # kf decision (config.cpp:38-41)
    min_entropy_ratio: float = 0.85
    max_kf_t_dist: float = 5.0
    max_kf_r_dist: float = 15.0
    # StVO options (:44-52)
    has_points: bool = True
    has_lines: bool = True
    use_fld_lines: bool = False
    lr_in_parallel: bool = True
    pl_in_parallel: bool = True
    best_lr_matches: bool = True
    adaptative_fast: bool = True
    use_motion_model: bool = False
    # point tracking (:56-59)
    max_dist_epip: float = 1.0
    min_disp: float = 1.0
    min_ratio_12_p: float = 0.9
    # line tracking (:61-68)
    line_sim_th: float = 0.75
    stereo_overlap_th: float = 0.75
    f2f_overlap_th: float = 0.75
    min_line_length: float = 0.025
    line_horiz_th: float = 0.1
    min_ratio_12_l: float = 0.9
    ls_min_disp_ratio: float = 0.7
    # adaptative FAST (:71-75)
    fast_min_th: int = 5
    fast_max_th: int = 50
    fast_inc_th: int = 5
    fast_feat_th: int = 50
    fast_err_th: float = 0.5
    # optimization (:79-86)
    homog_th: float = 1e-7
    min_features: int = 10
    max_iters: int = 5
    max_iters_ref: int = 10
    min_error: float = 1e-7
    min_error_change: float = 1e-7
    inlier_k: float = 4.0
    # matching (:90-92).  matching_strategy (0 = pure descriptor, 1 =
    # window + descriptor) is parsed by the reference (config.cpp:90,:184)
    # but never read by any of its code paths — dead upstream, parsed here
    # for YAML compatibility only.  This build always uses windowed +
    # descriptor matching with a global fallback (ops/matching.py).
    matching_strategy: int = 0
    matching_s_ws: int = 10
    matching_f2f_ws: int = 3
    # ORB (:95-102).  orb_wta_k is parsed by the reference
    # (config.cpp:99,:192) but never forwarded to cv::ORB::create — dead
    # upstream; the descriptor here is fixed 2-point steered BRIEF
    # (ops/orb.py), matching OpenCV's WTA_K=2 default.
    orb_nfeatures: int = 1200
    orb_scale_factor: float = 1.2
    orb_nlevels: int = 4
    orb_edge_th: int = 19
    orb_wta_k: int = 2
    orb_score: int = 1
    orb_patch_size: int = 31
    orb_fast_th: int = 20
    # LSD (:104-113)
    # lsd_nfeatures/min_line_length/lsd_ang_th map onto the tile-parallel
    # detector (ops/lines.py).  lsd_refine / lsd_scale / lsd_sigma_scale /
    # lsd_quant / lsd_log_eps / lsd_density_th / lsd_n_bins parameterize
    # the reference LSD's NFA region grower (LSDDetector_custom.cpp) and
    # have NO analog in the reformulated detector — parsed for YAML
    # compatibility, intentionally unused (the detector's own knobs live
    # in ops/lines.LineDetectorConfig).
    lsd_nfeatures: int = 300
    lsd_refine: int = 0
    lsd_scale: float = 1.2
    lsd_sigma_scale: float = 0.6
    lsd_quant: float = 2.0
    lsd_ang_th: float = 22.5
    lsd_log_eps: float = 1.0
    lsd_density_th: float = 0.6
    lsd_n_bins: int = 1024
    # ---- SLAM tier (slamConfig.cpp:43-86) ----
    fast_matching: bool = False
    has_refinement: bool = False
    multithread_slam: bool = True
    min_lm_obs: int = 5
    max_common_fts_kf: float = 0.9
    max_kf_epip_p: float = 1.0
    max_kf_epip_l: float = 1.0
    max_point_point_error: float = 0.1
    max_point_line_error: float = 0.1
    max_dir_line_error: float = 0.1
    min_lm_ess_graph: int = 150
    min_lm_cov_graph: int = 75
    min_kf_local_map: int = 3
    lambda_lba_lm: float = 1e-5
    lambda_lba_k: float = 10.0
    max_iters_lba: int = 15
    vocabulary_p: str = ""
    vocabulary_l: str = ""
    vocab_refresh_kfs: int = 50  # retrain online vocab every N KFs (0 = once)
    # checkpointing (not in the reference; SURVEY.md §5 restartability)
    checkpoint_every_kf: int = 0   # 0 = off
    checkpoint_dir: str = "checkpoints"
    # live scene export: rewrite a self-contained WebGL HTML of the map
    # every N keyframes (slamScene updateSceneSafe per-KF cadence,
    # src/slamScene.cpp — a growing file the user can reload mid-run,
    # the batch-environment analog of the MRPT live window).  0 = off.
    viz_every_kf: int = 0
    viz_path: str = "scene.html"
    # per-frame diagnosis overlays (plotStereoFrame /
    # plotStereoFrameProjerr analogs, stereoFrame.cpp:655,
    # stereoFrameHandler.cpp:1615): every N frames, render the tracked
    # features + f2f match segments + per-feature residual ramp onto the
    # left frame (PNG) and append a per-feature residual JSONL record.
    # 0 = off (the overlay recomputes the association for that frame and
    # costs one small fetch — a debug feature).
    overlay_every: int = 0
    overlay_dir: str = "overlays"

    lc_res: float = 1.0
    lc_unc: float = 0.01
    lc_inl: float = 0.3
    lc_trs: float = 1.5
    lc_rot: float = 35.0
    max_iters_pgo: int = 100
    lc_kf_dist: int = 50
    lc_kf_max_dist: int = 50
    lc_nkf_closest: int = 4
    lc_inlier_ratio: float = 30.0
    min_pt_matches: int = 10
    min_ls_matches: int = 6
    kf_inlier_ratio: float = 30.0
    # Pluecker mode toggle (USE_LINE_PLUKER compile flag in the reference;
    # a runtime switch here).  NOTE: loop closure must stay disabled in
    # Pluecker mode (README.md:12) — enforced in pipeline construction.
    use_line_plucker: bool = True
    use_loop_closure: bool = False

    @classmethod
    def from_yaml(cls, path: str) -> "PLSLAMConfig":
        cfg = cls()
        if yaml is None:
            return cfg
        with open(path) as f:
            # yaml-cpp (the reference's loader) tolerates literal TABs as
            # whitespace — config/config/config.yaml ships with one — but
            # strict YAML forbids them; normalize for interchange
            data = yaml.safe_load(f.read().replace("\t", " ")) or {}
        floats = {f.name for f in dataclasses.fields(cls) if isinstance(f.default, float)}
        names = {f.name for f in dataclasses.fields(cls)}
        for k, v in data.items():
            if k in names:
                setattr(cfg, k, float(v) if k in floats and isinstance(v, str) else v)
        return cfg


__all__ = ["PLSLAMConfig", "frontend", "tracker", "map_cfg", "loop_cfg", "ba"]


def frontend(cfg: PLSLAMConfig, image_max_dim: int = 752) -> FrontendConfig:
    cell = image_max_dim / 64.0  # GRID_COLS (stereoFrame.h:52)
    return FrontendConfig(
        n_points=cfg.orb_nfeatures,
        n_lines=max(64, (cfg.lsd_nfeatures + 63) // 64 * 64),
        n_levels=cfg.orb_nlevels,
        scale_factor=cfg.orb_scale_factor,
        fast_th=float(cfg.orb_fast_th),
        edge_th=cfg.orb_edge_th,
        max_dist_epip=cfg.max_dist_epip,
        min_disp=cfg.min_disp,
        nnr=cfg.min_ratio_12_p,
        stereo_window=cfg.matching_s_ws * cell,
        stereo_row_tol=max(cfg.max_dist_epip, cell * 0.85),
        line_sim_th=cfg.line_sim_th,
        line_horiz_th=cfg.line_horiz_th,
        ls_min_disp_ratio=cfg.ls_min_disp_ratio,
        stereo_overlap_th=cfg.stereo_overlap_th,
        min_line_length_frac=cfg.min_line_length,
        line_window=cfg.matching_s_ws * cell,
        line_orient_bins=min(32, max(8, round(360.0 / max(cfg.lsd_ang_th, 1e-6)))),
    )


def tracker(cfg: PLSLAMConfig) -> TrackerConfig:
    return TrackerConfig(
        max_iters=cfg.max_iters,
        max_iters_ref=cfg.max_iters_ref,
        min_error=cfg.min_error,
        min_error_change=cfg.min_error_change,
        inlier_k=cfg.inlier_k,
        min_features=cfg.min_features,
        use_lines=cfg.has_lines,
        use_points=cfg.has_points,
        plucker_lines=cfg.use_line_plucker,
        min_entropy_ratio=cfg.min_entropy_ratio,
        max_kf_t_dist=cfg.max_kf_t_dist,
        max_kf_r_dist=cfg.max_kf_r_dist,
    )


def map_cfg(cfg: PLSLAMConfig) -> MapConfig:
    return MapConfig(
        min_lm_obs=cfg.min_lm_obs,
        min_lm_cov_graph=cfg.min_lm_cov_graph,
        min_kf_local_map=cfg.min_kf_local_map,
        max_kf_epip_p=cfg.max_kf_epip_p,
        max_kf_epip_l=cfg.max_kf_epip_l,
        nnr=cfg.min_ratio_12_p,
        use_lines=cfg.has_lines,
        plucker_lines=cfg.use_line_plucker,
        min_pt_matches=cfg.min_pt_matches,
        max_common_fts_kf=cfg.max_common_fts_kf,
        has_refinement=cfg.has_refinement,
        kf_inlier_ratio=cfg.kf_inlier_ratio,
        min_features=cfg.min_features,
    )


def loop_cfg(cfg: PLSLAMConfig) -> LoopConfig:
    return LoopConfig(
        lc_kf_dist=cfg.lc_kf_dist,
        lc_nkf_closest=cfg.lc_nkf_closest,
        lc_res=cfg.lc_res,
        lc_unc=cfg.lc_unc,
        lc_trs=cfg.lc_trs,
        lc_rot=cfg.lc_rot,
        min_pt_matches=cfg.min_pt_matches,
        min_ls_matches=cfg.min_ls_matches,
        lc_inlier_ratio=cfg.lc_inlier_ratio,
        lc_kf_max_dist=cfg.lc_kf_max_dist,
        vocabulary_file=cfg.vocabulary_p,
        vocabulary_file_l=cfg.vocabulary_l,
        vocab_refresh_kfs=cfg.vocab_refresh_kfs,
        pgo_iters=min(cfg.max_iters_pgo, 25),
        fuse_dist=cfg.max_point_point_error,
        fuse_dist_pl=cfg.max_point_line_error,
        fuse_dist_dir=cfg.max_dir_line_error,
    )


def ba(cfg: PLSLAMConfig) -> BAConfig:
    return BAConfig(
        iters1=5,
        iters2=cfg.max_iters_lba - 5,
        lambda_init=cfg.lambda_lba_lm,
        lambda_factor=cfg.lambda_lba_k,
    )
