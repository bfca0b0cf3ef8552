"""Builders from the shared configuration tree to the port's config types.

``plslam_tpu.config.PLSLAMConfig`` (the YAML-compatible dataclass) imports
no jax, so the port reads it as is; its own builder methods return the
JAX package's types, so these functions read the same fields
(``plslam_tpu/config.py:180-274``) and return the port's.
"""

from __future__ import annotations

from plslam_tpu.config import PLSLAMConfig

from .backend.ba import BAConfig
from .backend.loop import LoopConfig
from .backend.mapping import MapConfig
from .frontend.frame import FrontendConfig
from .frontend.tracker import TrackerConfig

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
