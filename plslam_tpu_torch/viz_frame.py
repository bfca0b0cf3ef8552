"""Per-frame diagnosis overlays (``plslam_tpu.viz_frame``; the reference's
plotStereoFrame / plotStereoFrameProjerr, src2/stereoFrame.cpp:655 and
src2/stereoFrameHandler.cpp:1615-1872).

The tracking step keeps its tracked sets on the device, so the overlay
recomputes the frame-to-frame association and the residuals at the final
pose for the frames it renders, on the device, and copies them to the host
once per rendered frame.  It draws:

- point features: green = tracked inlier, red = rejected, with the f2f
  motion segment from the previous frame and a per-feature
  reprojection-residual colour ramp;
- line features: the same classes for segments, residual = the endpoint
  distances to the projected line;
- a JSONL residual dump per rendered frame (the optimizePoseDebug analog)
  for offline triage of a bad sequence.

Driven by ``PLSLAMConfig.overlay_every`` / ``run_euroc --overlay-every N``;
rendering needs matplotlib, imported only there.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .frontend import f2f
from .frontend import tracker as trk

_BOOL_KEYS = ("p_valid", "p_inlier", "l_valid", "l_inlier")


def compute_frame_diagnostics(prev_feats, curr_feats, DT, cam, tcfg) -> dict:
    """Tracked sets and per-feature residuals at the final pose ``DT``, as a
    dict of numpy arrays: point uv/prev-uv/valid/inlier/residual and line
    sp/ep/prev sp/prev ep/valid/inlier/residual."""
    dev = curr_feats.points.uv.device
    DT = torch.as_tensor(DT, dtype=torch.float32, device=dev)
    pts, ls, pidx, lidx = f2f.track_frame_to_frame(prev_feats, curr_feats)
    r_p, _ = trk.point_residuals(DT, pts, cam)
    if tcfg.plucker_lines:
        r_l = trk.line_residuals_plucker(DT, ls, cam)[0]
    else:
        r_l = trk.line_residuals_endpoint(DT, ls, cam)[0]
    pts2, ls2 = trk.remove_outliers(DT, pts, ls, cam, tcfg)
    pj = torch.clamp(pidx, 0, curr_feats.points.capacity - 1).long()
    lj = torch.clamp(lidx, 0, curr_feats.lines.capacity - 1).long()
    out = dict(
        p_prev=prev_feats.points.uv, p_uv=curr_feats.points.uv[pj],
        p_valid=pts.valid, p_inlier=pts2.inlier & pts.valid,
        p_res=torch.where(pts.valid, r_p, 0.0),
        l_sp=curr_feats.lines.sp[lj], l_ep=curr_feats.lines.ep[lj],
        l_prev_sp=prev_feats.lines.sp, l_prev_ep=prev_feats.lines.ep,
        l_valid=ls.valid, l_inlier=ls2.inlier & ls.valid,
        l_res=torch.where(ls.valid, r_l, 0.0))
    # one host copy: every field as float32 (bools exactly) in one buffer
    flat = torch.cat([v.reshape(-1).to(torch.float32) for v in out.values()]).cpu().numpy()
    host, pos = {}, 0
    for k, v in out.items():
        a = flat[pos:pos + v.numel()].reshape(tuple(v.shape))
        pos += v.numel()
        host[k] = a > 0.5 if k in _BOOL_KEYS else a
    return host


def render_frame_overlay(img, diag: dict, path: str, frame_id: int = 0,
                         res_cap: float = 4.0, title: str | None = None):
    """Draw the overlay onto the (H, W) grayscale frame and save a PNG."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    img = np.asarray(img)
    H, W = img.shape
    fig, ax = plt.subplots(figsize=(W / 96, H / 96), dpi=96)
    ax.imshow(img, cmap="gray", vmin=0, vmax=255)
    ramp = matplotlib.colormaps["plasma"]

    pv, pi = diag["p_valid"], diag["p_inlier"]
    uv, prev = diag["p_uv"], diag["p_prev"]
    res = diag["p_res"]
    for i in np.where(pv)[0]:
        color = ramp(min(res[i] / res_cap, 1.0)) if pi[i] else (1.0, 0.15, 0.15, 0.9)
        ax.plot([prev[i, 0], uv[i, 0]], [prev[i, 1], uv[i, 1]], "-", lw=0.6, color=color,
                alpha=0.6)
        ax.plot(uv[i, 0], uv[i, 1], "o", ms=2.4, mec="none", mfc=color)

    lv, li = diag["l_valid"], diag["l_inlier"]
    sp, ep = diag["l_sp"], diag["l_ep"]
    lres = diag["l_res"]
    for i in np.where(lv)[0]:
        color = ramp(min(lres[i] / res_cap, 1.0)) if li[i] else (1.0, 0.15, 0.15, 0.9)
        ax.plot([sp[i, 0], ep[i, 0]], [sp[i, 1], ep[i, 1]], "-", lw=1.6, color=color)

    n_in = int(pi.sum()) + int(li.sum())
    n_tr = int(pv.sum()) + int(lv.sum())
    ax.set_title(title or f"frame {frame_id}: {n_in}/{n_tr} inliers  "
                          f"(res ramp 0..{res_cap:.0f} px, red = rejected)", fontsize=9)
    ax.set_xlim(0, W)
    ax.set_ylim(H, 0)
    ax.axis("off")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, bbox_inches="tight", pad_inches=0.02)
    plt.close(fig)


def dump_residuals_jsonl(diag: dict, path: str, frame_id: int):
    """Append one JSON line of per-feature residuals (optimizePoseDebug
    analog, stereoFrameHandler.cpp:1699-1872) for offline triage."""
    pv = diag["p_valid"]
    lv = diag["l_valid"]
    rec = {
        "frame": frame_id,
        "pt": [[int(i), round(float(diag["p_res"][i]), 3), bool(diag["p_inlier"][i])]
               for i in np.where(pv)[0]],
        "ls": [[int(i), round(float(diag["l_res"][i]), 3), bool(diag["l_inlier"][i])]
               for i in np.where(lv)[0]],
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")
