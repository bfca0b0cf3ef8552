"""Endpoint-GBA convergence A/B oracle (the port of
``scripts/endpoint_gba_ab.py``).

Question: the endpoint-mode GBA converges about 10x looser than the
Pluecker mode on the ring oracle.  Is that inherent to the endpoint
parameterization with point-to-line-only constraints (the reference's
primary GBA, mapHandler.cpp:3128-3731), or a defect in the solver?

One ring problem (``io/ring_map.build_ring_map``: seed 3, 16 keyframes,
1024 points, 128 lines, pose noise 0.01, landmark noise 0.03) is solved
three ways:
  a) the Pluecker-mode chunked GBA (``mapper.global_bundle_adjustment``),
  b) the endpoint-mode chunked GBA (the same, ``plucker_lines=False``),
  c) a reference-faithful endpoint LM oracle: float64, dense normal
     equations over [poses | points | line endpoints], the reference's
     residuals (2D point reprojection, and the signed distance of each
     projected 3D line endpoint to the observed image line), Cauchy IRLS
     weights w = 1/(1+r^2), lambda*diag(H) damping with x10
     accept/reject, pose 0 fixed (gauge).  The Jacobians of each
     observation come from ``torch.func.jacfwd`` under ``torch.func.vmap``
     in float64, so no derivative is derived by hand; the normal equations
     are summed in an order fixed by their indices (``core/segment.py``)
     and solved by ``torch.linalg.solve``.

If (c) lands near (a), the endpoint path has a bug; if near (b), the
parameterization owns the gap.

    python -m plslam_tpu_torch.endpoint_gba_ab [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from .core import lie
from .core.segment import segment_plan, segment_sum
from .io.ring_map import build_ring_map

N_KF, N_PTS, N_LS = 16, 1024, 128
SEED = 3


def build(plucker: bool, device="cuda", n_kf=N_KF, n_pts=N_PTS, n_ls=N_LS):
    mapper, truth = build_ring_map(rng_seed=SEED, n_kf=n_kf, n_pts=n_pts, n_ls=n_ls,
                                   pose_noise=0.01, lm_noise=0.03, device=device)
    mapper.cfg = dataclasses.replace(mapper.cfg, plucker_lines=plucker)
    return mapper, truth


def pt_err(mapper, pt_true):
    mp = mapper.map
    el = np.where(mp.pt_valid & (mp.pt_nobs >= 2))[0]
    return float(np.median(np.linalg.norm(mp.pt_w[el] - pt_true[el], axis=1)))


def pose_err(mapper, T_true):
    T = np.stack([k.T_w_k[:3, 3] for k in mapper.map.keyframes])
    return float(np.linalg.norm(T - T_true[:, :3, 3], axis=1).mean())


# ---------------------------------------------------------------------------
# (c) reference-faithful dense endpoint LM
# ---------------------------------------------------------------------------


def extract_problem(mapper):
    """Pull the obs tables into flat arrays (f64)."""
    mp = mapper.map
    kfs = mp.keyframes
    T0 = np.stack([np.linalg.inv(k.T_w_k) for k in kfs])  # T_c_w
    # live point landmarks with >= 2 obs
    pt_ids = np.where(mp.pt_valid & (mp.pt_nobs >= 2))[0]
    pslot = np.full(mp.n_pt, -1, np.int64)
    pslot[pt_ids] = np.arange(len(pt_ids))
    X0 = mp.pt_w[pt_ids].astype(np.float64)
    tb = mp.pobs
    rows = np.where(tb.valid[: tb.n] & (pslot[tb.lm[: tb.n]] >= 0))[0]
    p_cam = tb.kf[rows]
    p_lm = pslot[tb.lm[rows]]
    p_uv = np.stack([kfs[k].pt_uv[f] for k, f in
                     zip(p_cam, tb.fi[rows])]).astype(np.float64)
    # line landmarks as endpoint pairs
    ls_ids = np.where(mp.ls_valid & (mp.ls_nobs >= 2))[0]
    lslot = np.full(mp.n_ls, -1, np.int64)
    lslot[ls_ids] = np.arange(len(ls_ids))
    E0 = mp.ls_epw[ls_ids].astype(np.float64)            # (L, 2, 3)
    tb = mp.lobs
    rows = np.where(tb.valid[: tb.n] & (lslot[tb.lm[: tb.n]] >= 0))[0]
    l_cam = tb.kf[rows]
    l_lm = lslot[tb.lm[rows]]
    lo = []
    for k, f in zip(l_cam, tb.fi[rows]):
        sp, ep = kfs[k].ls_sp[f], kfs[k].ls_ep[f]
        l = np.cross([*sp, 1.0], [*ep, 1.0])
        lo.append(l / max(np.hypot(l[0], l[1]), 1e-12))
    lo = np.asarray(lo, np.float64)
    return (T0, X0, E0, p_cam, p_lm, p_uv, l_cam, l_lm, lo, pt_ids, ls_ids)


class _Normal:
    """The dense normal equations' index structure, built once: every
    Jacobian product's flat position in H (n_par x n_par) and in g, and the
    fixed-order sum plans over them."""

    def __init__(self, p_cam, p_lm, l_cam, l_lm, K, P, L, dev):
        NP6 = 6 * (K - 1)
        self.n = n = NP6 + 3 * P + 6 * L
        self.pm = p_cam > 0          # observations whose pose is free
        self.lm = l_cam > 0
        r6, r3 = torch.arange(6, device=dev), torch.arange(3, device=dev)
        pp = 6 * (p_cam[self.pm] - 1)
        px, pxm = NP6 + 3 * p_lm, NP6 + 3 * p_lm[self.pm]
        lp = 6 * (l_cam[self.lm] - 1)
        le, lem = NP6 + 3 * P + 6 * l_lm, NP6 + 3 * P + 6 * l_lm[self.lm]

        def block(r0, c0, nr, nc):
            ri = r0[:, None, None] + torch.arange(nr, device=dev)[None, :, None]
            ci = c0[:, None, None] + torch.arange(nc, device=dev)[None, None, :]
            return (ri * n + ci).reshape(-1)

        # the order of the products in ``values``
        h_idx = torch.cat([block(pp, pp, 6, 6), block(px, px, 3, 3), block(pp, pxm, 6, 3),
                           block(pxm, pp, 3, 6), block(le, le, 6, 6), block(lp, lem, 6, 6),
                           block(lem, lp, 6, 6), block(lp, lp, 6, 6)])
        g_idx = torch.cat([(pp[:, None] + r6).reshape(-1), (px[:, None] + r3).reshape(-1),
                           (le[:, None] + r6).reshape(-1), (lp[:, None] + r6).reshape(-1)])
        self.h_pos, h_inv = torch.unique(h_idx, return_inverse=True)
        self.h_plan = segment_plan(h_inv, len(self.h_pos))
        self.g_plan = segment_plan(g_idx, n)

    def assemble(self, rp, Jp_pose, Jp_X, rl, Jl_pose, Jl_E):
        """(H, g) of the Cauchy-weighted Gauss-Newton system."""
        w_p = 1.0 / (1.0 + (rp * rp).sum(-1))            # Cauchy IRLS
        w_l = 1.0 / (1.0 + (rl * rl).sum(-1))
        Jl_E = Jl_E.reshape(len(rl), 2, 6)
        pm, lm = self.pm, self.lm

        def jtj(w, A, B):
            return torch.einsum("n,nia,nib->nab", w, A, B)

        def jtr(w, A, r):
            return torch.einsum("n,nia,ni->na", w, A, r)

        cross_p = jtj(w_p[pm], Jp_pose[pm], Jp_X[pm])
        cross_l = jtj(w_l[lm], Jl_pose[lm], Jl_E[lm])
        h_val = torch.cat([
            jtj(w_p[pm], Jp_pose[pm], Jp_pose[pm]).reshape(-1),
            jtj(w_p, Jp_X, Jp_X).reshape(-1),
            cross_p.reshape(-1), cross_p.transpose(1, 2).reshape(-1),
            jtj(w_l, Jl_E, Jl_E).reshape(-1),
            cross_l.reshape(-1), cross_l.transpose(1, 2).reshape(-1),
            jtj(w_l[lm], Jl_pose[lm], Jl_pose[lm]).reshape(-1)])
        g = segment_sum(torch.cat([
            jtr(w_p[pm], Jp_pose[pm], rp[pm]).reshape(-1), jtr(w_p, Jp_X, rp).reshape(-1),
            jtr(w_l, Jl_E, rl).reshape(-1),
            jtr(w_l[lm], Jl_pose[lm], rl[lm]).reshape(-1)]), self.g_plan)
        H = torch.zeros(self.n * self.n, dtype=rp.dtype, device=rp.device)
        H[self.h_pos] = segment_sum(h_val, self.h_plan)
        return H.reshape(self.n, self.n), g


def faithful_endpoint_lm(mapper, iters: int = 40, timings=None):
    """The f64 dense endpoint LM on the mapper's device: (xi, X, E, pt_ids,
    cost history).  ``timings``, a dict, receives the first Jacobian
    call's seconds ("first_call_s")."""
    (T0, X0, E0, p_cam, p_lm, p_uv, l_cam, l_lm, lo,
     pt_ids, ls_ids) = extract_problem(mapper)
    dev = mapper.device
    f64 = torch.float64
    cam = mapper.cam
    fx, fy = float(cam.fx), float(cam.fy)
    cx, cy = float(cam.cx), float(cam.cy)
    K, P, L = len(T0), len(X0), len(E0)
    NP6 = 6 * (K - 1)  # pose 0 fixed (gauge)

    def t(a, dtype=f64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    T0j = t(T0)

    def proj(Pc):
        z = torch.clamp(Pc[2], min=1e-9)
        return torch.stack([cx + fx * Pc[0] / z, cy + fy * Pc[1] / z])

    # per-obs residuals of the involved parameters only; chart:
    # T_c_w(k) = exp(xi_k) @ T0_c_w(k), k = 0 fixed
    def pt_res_local(xi_k, Xp, T0k, uv, fixed):
        T = torch.where(fixed, T0k, lie.exp_se3(xi_k) @ T0k)
        return proj(lie.transform_point(T, Xp)) - uv

    def ls_res_local(xi_k, Eq, T0k, lobs, fixed):
        T = torch.where(fixed, T0k, lie.exp_se3(xi_k) @ T0k)
        e = []
        for q in range(2):
            u = proj(lie.transform_point(T, Eq[q]))
            e.append(lobs[0] * u[0] + lobs[1] * u[1] + lobs[2])
        return torch.stack(e)

    vmap, jacfwd = torch.func.vmap, torch.func.jacfwd
    pt_val_jac = vmap(lambda *a: (pt_res_local(*a), jacfwd(pt_res_local, argnums=(0, 1))(*a)))
    ls_val_jac = vmap(lambda *a: (ls_res_local(*a), jacfwd(ls_res_local, argnums=(0, 1))(*a)))

    pc, pl, lc, ll = (t(a, torch.int64) for a in (p_cam, p_lm, l_cam, l_lm))
    p_uv_t, lo_t = t(p_uv), t(lo)
    pc_x, lc_x = torch.clamp(pc - 1, min=0), torch.clamp(lc - 1, min=0)
    normal = _Normal(pc, pl, lc, ll, K, P, L, dev)

    def eval_all(xi, X, E):
        rp, (Jp_pose, Jp_X) = pt_val_jac(xi[pc_x], X[pl], T0j[pc], p_uv_t, pc == 0)
        rl, (Jl_pose, Jl_E) = ls_val_jac(xi[lc_x], E[ll], T0j[lc], lo_t, lc == 0)
        return rp, Jp_pose, Jp_X, rl, Jl_pose, Jl_E

    def cost_of(rp, rl):
        return float(torch.log1p((rp * rp).sum(-1)).sum() + torch.log1p((rl * rl).sum(-1)).sum())

    n_par = normal.n
    xi = torch.zeros((K - 1, 6), dtype=f64, device=dev)
    X = t(X0)
    E = t(E0)
    t0 = time.perf_counter()
    ev = eval_all(xi, X, E)
    cost = cost_of(ev[0], ev[3])
    if timings is not None:
        timings["first_call_s"] = time.perf_counter() - t0
    lam = 1e-4
    cost_hist = [cost]
    eye = torch.eye(n_par, dtype=f64, device=dev)
    for _ in range(iters):
        Hd, g = normal.assemble(*ev)
        Hdamp = Hd + lam * torch.diag(torch.diag(Hd)) + 1e-12 * eye
        try:
            delta = torch.linalg.solve(Hdamp, g)
        except torch.linalg.LinAlgError:
            lam *= 10.0
            continue
        xi_c = xi - delta[:NP6].reshape(K - 1, 6)
        X_c = X - delta[NP6:NP6 + 3 * P].reshape(P, 3)
        E_c = E - delta[NP6 + 3 * P:].reshape(L, 2, 3)
        ev_c = eval_all(xi_c, X_c, E_c)
        c_new = cost_of(ev_c[0], ev_c[3])
        if np.isfinite(c_new) and c_new < cost:
            xi, X, E, ev, cost = xi_c, X_c, E_c, ev_c, c_new
            lam = max(lam / 10.0, 1e-9)
        else:
            lam = min(lam * 10.0, 1e6)
        cost_hist.append(cost)
    return (xi.cpu().numpy(), X.cpu().numpy(), E.cpu().numpy(), pt_ids, cost_hist)


def main(argv=None) -> dict:
    """Prints the JAX script's JSON line (rounded as there) and returns the
    unrounded values, the oracle's whole cost history among them."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    raw = {"n_kf": N_KF, "n_pts": N_PTS, "n_ls": N_LS}
    # (a) the Pluecker GBA
    mapper, (T_true, pt_true) = build(plucker=True, device=dev)
    raw["pre"] = {"pt": pt_err(mapper, pt_true), "pose": pose_err(mapper, T_true)}
    for name, plucker in (("ours_plucker", True), ("ours_endpoint", False)):
        if not plucker:   # (b) the endpoint GBA
            mapper, _ = build(plucker=False, device=dev)
        sync()
        t0 = time.time()
        mapper.global_bundle_adjustment()
        sync()
        raw[name] = {"pt": pt_err(mapper, pt_true), "pose": pose_err(mapper, T_true),
                     "wall_s": time.time() - t0}
    # (c) the reference-faithful dense f64 endpoint LM on the same problem
    mapper, _ = build(plucker=False, device=dev)
    timings = {}
    t0 = time.time()
    xi, X, E, pt_ids, hist = faithful_endpoint_lm(mapper, timings=timings)
    wall = time.time() - t0 - timings["first_call_s"]
    errs = np.linalg.norm(X - pt_true[pt_ids], axis=1)
    raw["oracle_endpoint_f64"] = {"pt": float(np.median(errs)), "wall_s": wall,
                                  "first_call_s": timings["first_call_s"],
                                  "cost_hist": hist, "iters_used": len(hist) - 1}
    print(f"# oracle: first Jacobian evaluation {timings['first_call_s']:.1f} s (one-time "
          f"cost of torch.func), then {wall:.1f} s for {len(hist) - 1} iterations",
          file=sys.stderr, flush=True)
    out = {k: raw[k] for k in ("n_kf", "n_pts", "n_ls")}
    out["pre"] = {k: round(v, 5) for k, v in raw["pre"].items()}
    for name in ("ours_plucker", "ours_endpoint"):
        r = raw[name]
        out[name] = {"pt": round(r["pt"], 5), "pose": round(r["pose"], 5),
                     "wall_s": round(r["wall_s"], 1)}
    o = raw["oracle_endpoint_f64"]
    out["oracle_endpoint_f64"] = {
        "pt": round(o["pt"], 5), "wall_s": round(o["wall_s"], 1),
        "cost_first_last": [round(hist[0], 2), round(hist[-1], 2)],
        "iters_used": o["iters_used"]}
    print(json.dumps(out), flush=True)
    return raw


if __name__ == "__main__":
    main()
