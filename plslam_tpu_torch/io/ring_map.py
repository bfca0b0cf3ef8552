"""A ring-corridor map written straight into a ``MapHandler``'s tables (no
association programs): the distributed solvers' map at realistic size.

The world lies on a cylinder around a circular trajectory; each keyframe
observes the points and lines of its viewing sector, and the landmark and
pose states start perturbed from the truth.  The same draws, in the same
order, as the JAX package's multichip dry run (``_build_ring_map`` of the
repository's ``__graft_entry__.py``), so the two packages' maps hold the
same tables.
"""

from __future__ import annotations

import numpy as np

from ..backend import ba as ba_mod
from ..backend.mapping import KeyframeRecord, MapConfig, MapHandler
from ..convert import stereo_features_from_numpy
from ..core.camera import StereoCamera

CAP_P, CAP_L = 512, 64
W, H = 752, 480


def _project(X, T_c_w, fx, fy, cx, cy):
    Xc = X @ T_c_w[:3, :3].T + T_c_w[:3, 3]
    return Xc, np.stack([cx + fx * Xc[:, 0] / np.maximum(Xc[:, 2], 1e-9),
                         cy + fy * Xc[:, 1] / np.maximum(Xc[:, 2], 1e-9)], -1)


def _inside(uv):
    return (uv[:, 0] > 8) & (uv[:, 0] < W - 8) & (uv[:, 1] > 8) & (uv[:, 1] < H - 8)


def _features(uv, Pc, sel, uva, uvb, Ac, Bc, lsel) -> dict:
    """One keyframe's fixed-capacity feature tables; slot i <-> sel[i]."""
    n_s, n_l = len(sel), len(lsel)

    def pad(a, cap, cols):
        out = np.zeros((cap, cols), np.float32)
        out[: len(a)] = a
        return out

    points = dict(uv=pad(uv[sel], CAP_P, 2), disp=np.ones(CAP_P, np.float32),
                  P=pad(Pc[sel], CAP_P, 3), desc=np.zeros((CAP_P, 8), np.int32),
                  sigma2=np.ones(CAP_P, np.float32), valid=np.arange(CAP_P) < n_s)
    lines = dict(sp=pad(uva[lsel], CAP_L, 2), ep=pad(uvb[lsel], CAP_L, 2),
                 sdisp=np.ones(CAP_L, np.float32), edisp=np.ones(CAP_L, np.float32),
                 sP=pad(Ac[lsel], CAP_L, 3), eP=pad(Bc[lsel], CAP_L, 3),
                 le=np.zeros((CAP_L, 3), np.float32), angle=np.zeros(CAP_L, np.float32),
                 NDc=np.zeros((CAP_L, 6), np.float32), desc=np.zeros((CAP_L, 8), np.int32),
                 sigma2=np.ones(CAP_L, np.float32), valid=np.arange(CAP_L) < n_l)
    return dict(points=points, lines=lines)


def build_ring_map(rng_seed: int, n_kf: int, n_pts: int, n_ls: int, pose_noise: float,
                   lm_noise: float, device="cuda"):
    """(mapper, (T_true (K, 4, 4), pt_true (n_pt, 3))): a ``MapHandler`` on
    ``device`` whose keyframes observe a ring world, BA config iters 3 + 3."""
    rng = np.random.default_rng(rng_seed)
    cam = StereoCamera.create(458.0, 457.0, 376.0, 240.0, 0.11, width=W, height=H)
    fx, fy, cx, cy = 458.0, 457.0, 376.0, 240.0
    radius = 8.0

    phi = rng.uniform(0, 2 * np.pi, n_pts)
    rp = radius + rng.uniform(3.0, 8.0, n_pts)
    pts_w = np.stack([rp * np.cos(phi), rng.uniform(-2.5, 2.5, n_pts), rp * np.sin(phi)], -1)
    phi_l = rng.uniform(0, 2 * np.pi, n_ls)
    rl = radius + rng.uniform(3.0, 8.0, n_ls)
    A = np.stack([rl * np.cos(phi_l), rng.uniform(-2.5, 2.5, n_ls), rl * np.sin(phi_l)], -1)
    tang = np.stack([-np.sin(phi_l), np.zeros(n_ls), np.cos(phi_l)], -1)
    B = A + tang * rng.uniform(0.8, 2.0, n_ls)[:, None]

    def pose_at(theta):
        p = radius * np.array([np.cos(theta), 0.0, np.sin(theta)])
        z = np.array([np.cos(theta), 0.0, np.sin(theta)])
        y = np.array([0.0, 1.0, 0.0])
        T = np.eye(4)
        T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = np.cross(y, z), y, z, p
        return T

    T_true = np.stack([pose_at(th) for th in np.linspace(0, 2 * np.pi, n_kf, endpoint=False)])

    # obs capacities grow with the keyframe count, so no chunk is truncated
    mcfg = MapConfig(ba_points=2048, ba_lines=256, ba_pobs=max(16384, 192 * n_kf),
                     ba_lobs=max(2048, 24 * n_kf), local_ba_kf=n_kf)
    mapper = MapHandler(cam, mcfg, ba_mod.BAConfig(iters1=3, iters2=3), device=device)
    mp = mapper.map

    wid2lm = np.full(n_pts, -1, np.int64)
    lid2lm = np.full(n_ls, -1, np.int64)
    pt_noisy = pts_w + rng.normal(0, lm_noise, pts_w.shape)
    A_noisy = A + rng.normal(0, lm_noise, A.shape)
    B_noisy = B + rng.normal(0, lm_noise, B.shape)

    for k in range(n_kf):
        T_c_w = np.linalg.inv(T_true[k])
        Pc, uv = _project(pts_w, T_c_w, fx, fy, cx, cy)
        sel = np.where((Pc[:, 2] > 0.5) & _inside(uv))[0][:CAP_P]
        Ac, uva = _project(A, T_c_w, fx, fy, cx, cy)
        Bc, uvb = _project(B, T_c_w, fx, fy, cx, cy)
        lsel = np.where((Ac[:, 2] > 0.5) & (Bc[:, 2] > 0.5) & _inside(uva)
                        & _inside(uvb))[0][:CAP_L]
        feats = stereo_features_from_numpy(_features(uv, Pc, sel, uva, uvb, Ac, Bc, lsel), "cpu")
        T_noisy = T_true[k].copy()
        if k > 0:
            T_noisy[:3, 3] += rng.normal(0, pose_noise, 3)
        rec = KeyframeRecord(k, T_noisy, feats)
        mp.keyframes.append(rec)
        mp.expand_graphs()

        new = sel[wid2lm[sel] < 0]
        wid2lm[new] = mp.new_points(pt_noisy[new], np.zeros((len(new), 8), np.int32), k,
                                    np.searchsorted(sel, new))
        old = sel[wid2lm[sel] >= 0]
        old = old[~np.isin(old, new)]
        if len(old):
            mp.add_point_obs(wid2lm[old], k, np.searchsorted(sel, old))
        rec.pt_lm[: len(sel)] = wid2lm[sel]

        newl = lsel[lid2lm[lsel] < 0]
        d = B_noisy[newl] - A_noisy[newl]
        nd = np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-9)
        Lw = np.concatenate([np.cross(A_noisy[newl], B_noisy[newl]), d], -1) / nd
        ep_w = np.stack([A_noisy[newl], B_noisy[newl]], 1)
        lid2lm[newl] = mp.new_lines(Lw, np.zeros((len(newl), 8), np.int32), k,
                                    np.searchsorted(lsel, newl), ep_w)
        oldl = lsel[lid2lm[lsel] >= 0]
        oldl = oldl[~np.isin(oldl, newl)]
        if len(oldl):
            mp.add_line_obs(lid2lm[oldl], k, np.searchsorted(lsel, oldl))
        rec.ls_lm[: len(lsel)] = lid2lm[lsel]

    truth = np.zeros((mp.n_pt, 3))
    seen = wid2lm >= 0
    truth[wid2lm[seen]] = pts_w[seen]
    return mapper, (T_true, truth)
