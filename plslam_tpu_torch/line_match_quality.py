"""Line-matching quality harness: the wrong-match rate of LBD f2f matching
on rendered synthetic scenes with known 3D line ground truth (the port of
``scripts/line_match_quality.py``).

For each of several scenes and motions: detect and describe lines in two
views, match them with the production f2f gating, then associate every
detected segment with its ground-truth 3D line (projected angle + midpoint
distance).  A match is correct when both segments map to the same
ground-truth line.  Detection and the Hamming matrix run on ``--device``
(the patch-gather and Hamming kernels on the card); the association is
host numpy.

    python -m plslam_tpu_torch.line_match_quality [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .frontend.frame import FrontendConfig, _detect_describe_lines
from .io.synthetic import SyntheticScene, circular_trajectory
from .ops import matching as M

# the harness's eight labelled runs: (label, keyword arguments of run)
CONFIGS = (
    ("baseline (full-segment)", {}),
    ("PRODUCTION (+twoway 25px)", dict(twoway_px=25.0)),
    ("baseline oneside", dict(mask_mode="oneside")),
    ("baseline midpoint", dict(mask_mode="midpoint")),
    ("long-lines full-segment", dict(long_lines=True)),
    ("long-lines +twoway 25px", dict(long_lines=True, twoway_px=25.0)),
    ("long-lines oneside", dict(long_lines=True, mask_mode="oneside")),
    ("long-lines midpoint", dict(long_lines=True, mask_mode="midpoint")),
)


def _gt_assoc(scene, T_w_c, sp, ep, valid, ang_tol=0.12, dist_tol=3.5):
    """Greedy association of detected segments to GT lines in one view.
    Returns (K,) GT index or -1."""
    T_c_w = np.linalg.inv(T_w_c)
    ua, va, za = scene.project(T_c_w, scene.LA)
    ub, vb, zb = scene.project(T_c_w, scene.LB)
    front = (za > 0.3) & (zb > 0.3)
    ga = np.stack([ua, va], -1)
    gb = np.stack([ub, vb], -1)
    gd = gb - ga
    gn = np.linalg.norm(gd, axis=-1)
    gdir = gd / np.maximum(gn[:, None], 1e-9)

    out = np.full(len(sp), -1, np.int64)
    mid = 0.5 * (np.asarray(sp) + np.asarray(ep))
    ddet = np.asarray(ep) - np.asarray(sp)
    ddet = ddet / np.maximum(np.linalg.norm(ddet, axis=-1, keepdims=True),
                             1e-9)
    for i in range(len(sp)):
        if not valid[i]:
            continue
        cosang = np.abs(ddet[i] @ gdir.T)
        rel = mid[i] - ga
        # distance of detected midpoint to the GT infinite line
        dist = np.abs(rel[:, 0] * (-gdir[:, 1]) + rel[:, 1] * gdir[:, 0])
        # and the midpoint must project inside the GT span (+ margin)
        t = rel[:, 0] * gdir[:, 0] + rel[:, 1] * gdir[:, 1]
        inside = (t > -10) & (t < gn + 10)
        cand = front & inside & (cosang > np.cos(ang_tol)) & (dist < dist_tol)
        if cand.any():
            out[i] = int(np.argmin(np.where(cand, dist, 1e9)))
    return out


def _left_view(scene, T_w_c, noise):
    """``scene.render_stereo(T_w_c, noise=noise)[0]`` without splatting the
    right view, which the harness never reads: its noise draw still
    advances the scene's random stream, so every later view is the one
    the serial stereo render gives."""
    img = scene._render(np.linalg.inv(T_w_c), noise)
    scene.rng.normal(0, noise, img.shape)
    return img


def _make_mask(mode, cfg, sa, sb):
    """Candidate-window variants: 'full' = symmetric point-to-segment
    (production), 'oneside' = endpoints of set 1 vs segment 2 only,
    'midpoint' = midpoint rectangle windows."""
    if mode == "full":
        return M.line_pair_mask(sa.sp, sa.ep, sb.sp, sb.ep, sa.valid, sb.valid,
                                radius=cfg.line_window, min_dir_cos=cfg.line_sim_th)
    v1 = sa.ep - sa.sp
    v2 = sb.ep - sb.sp
    n1 = torch.clamp(torch.linalg.norm(v1, dim=-1, keepdim=True), min=1e-12)
    n2 = torch.clamp(torch.linalg.norm(v2, dim=-1, keepdim=True), min=1e-12)
    cos = torch.abs((v1 / n1) @ (v2 / n2).T)
    if mode == "oneside":
        r2 = cfg.line_window ** 2
        near = ((M._point_segment_dist2(sa.sp, sb.sp, sb.ep) <= r2)
                | (M._point_segment_dist2(sa.ep, sb.sp, sb.ep) <= r2))
    else:  # midpoint
        near = M.window_pair_mask(0.5 * (sa.sp + sa.ep), 0.5 * (sb.sp + sb.ep),
                                  sa.valid, sb.valid, cfg.line_window, cfg.line_window)
    return near & (cos >= cfg.line_sim_th) & sa.valid[:, None] & sb.valid[None, :]


def run(cfg: FrontendConfig, n_scenes=6, n_steps=3, label="", long_lines=False,
        mask_mode="full", twoway_px=0.0, device="cuda") -> dict:
    """One labelled configuration over ``n_scenes`` scenes of ``n_steps``
    view pairs; prints the harness's row and returns its counts."""
    dev = torch.device(device)
    tot_m, tot_ok, tot_det = 0, 0, 0
    for seed in range(n_scenes):
        scene = SyntheticScene(n_points=250, n_lines=48, seed=seed)
        if long_lines:
            # stretch every 3D segment 3x about its midpoint: long image
            # segments are where midpoint/one-sided windows lose candidates
            mid = 0.5 * (scene.LA + scene.LB)
            scene.LA = mid + 3.0 * (scene.LA - mid)
            scene.LB = mid + 3.0 * (scene.LB - mid)
        poses = circular_trajectory(n_steps + 1, step_t=0.07, step_r=0.012)
        views = []
        for T in poses:
            il = _left_view(scene, T, 1.5)
            seg, desc = _detect_describe_lines(torch.from_numpy(il).to(dev), cfg)
            sp, ep, valid = (x.cpu().numpy() for x in (seg.sp, seg.ep, seg.valid))
            views.append((seg, desc, _gt_assoc(scene, T, sp, ep, valid)))
        for (sa, da, ga), (sb, db, gb) in zip(views, views[1:]):
            mask = _make_mask(mask_mode, cfg, sa, sb)
            idx = M.match_descriptors(da, db, mask, 0.9).idx
            if twoway_px > 0:
                idx = M.line_twoway_gate(sa.sp, sa.ep, sb.sp, sb.ep, idx, twoway_px)
            idx = idx.cpu().numpy()
            for i, j in enumerate(idx):
                if j < 0 or ga[i] < 0:
                    continue
                tot_m += 1
                tot_ok += int(ga[i] == gb[j])
            tot_det += int((ga >= 0).sum())
    wrong = tot_m - tot_ok
    print(f"{label:30s} matches={tot_m:4d} correct={tot_ok:4d} "
          f"wrong={wrong:3d} ({100.0 * wrong / max(tot_m, 1):.1f}%) "
          f"gt-visible detections={tot_det}", flush=True)
    return dict(label=label, matches=tot_m, correct=tot_ok, wrong=wrong, detections=tot_det)


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return [run(FrontendConfig(), label=label, device=args.device, **kw)
            for label, kw in CONFIGS]


if __name__ == "__main__":
    main()
