"""Seeded inputs of the mapper's and the loop closer's programs
(tests/test_torch_graphs_mapping.py, test_torch_graphs_loop.py and
test_torch_graphs_gba.py on the CPU, tests/test_torch_gpu_graphs.py on the
card): two keyframes of the ring world
(``plslam_tpu_torch/io/ring_world.py``), local-map candidates staged as the
mapper stages them, landmark links, the refinement's correspondences, a
corpus of descriptors, a stacked chunked-GBA problem and a loop closure's
pose graph, all numpy from a seed.  It imports no jax, so the card's tests
can use it."""

from __future__ import annotations

import numpy as np

from plslam_tpu_torch.io.ring_world import (  # noqa: F401  (ring_pose_graph: re-exported)
    RingWorld, render_ring_features, ring_pose_graph)

CAM_K = (458.0, 457.0, 376.0, 240.0, 0.11)
WIDTH, HEIGHT = 752, 480


def port_camera():
    from plslam_tpu_torch.core.camera import StereoCamera

    return StereoCamera.create(*CAM_K, width=WIDTH, height=HEIGHT)


def keyframe_pair(seed: int = 0, theta: float = 0.3, step: float = 0.04):
    """The ring world, the two keyframes' camera -> world poses and their
    features ({"points": {...}, "lines": {...}}, uint32 words)."""
    world = RingWorld(n_pts=1500, n_ls=150, seed=5)
    rng = np.random.default_rng(seed)
    T0, T1 = world.pose_at(theta), world.pose_at(theta + step)
    return (world, T0, T1, render_ring_features(world, T0, CAM_K, rng),
            render_ring_features(world, T1, CAM_K, rng))


def _visible(Pw: np.ndarray, T_w_c: np.ndarray) -> np.ndarray:
    T_c_w = np.linalg.inv(T_w_c)
    Pc = Pw @ T_c_w[:3, :3].T + T_c_w[:3, 3]
    z = np.maximum(Pc[:, 2], 1e-9)
    u = CAM_K[2] + CAM_K[0] * Pc[:, 0] / z
    v = CAM_K[3] + CAM_K[1] * Pc[:, 1] / z
    return (Pc[:, 2] > 0) & (u >= 0) & (u < WIDTH) & (v >= 0) & (v < HEIGHT)


def _flip_bits(desc: np.ndarray, rng, n_bits: int = 4) -> np.ndarray:
    out = desc.copy()
    for _ in range(n_bits):
        w = rng.integers(0, 8, len(out))
        b = rng.integers(0, 32, len(out)).astype(np.uint32)
        out[np.arange(len(out)), w] ^= np.uint32(1) << b
    return out


def candidates(world, T1, seed: int, n_cand: int, n_cand_l: int, nb: int, nbl: int):
    """Local-map candidates staged as ``MapHandler._stage_candidates``
    does: (cpack (nb + 2 nbl, 3) f32, dpack (nb + nbl, 8) int32, cval
    (nb + nbl,) bool); mostly landmarks in view of T1, with noisy
    positions and a few descriptor bits flipped."""
    rng = np.random.default_rng(seed)
    vis = np.where(_visible(world.pts, T1))[0]
    hid = np.where(~_visible(world.pts, T1))[0]
    k = min(len(vis), n_cand - n_cand // 8)
    pid = np.concatenate([rng.choice(vis, k, replace=False),
                          rng.choice(hid, n_cand - k, replace=False)])
    vis_l = np.where(_visible(world.ls_A, T1) & _visible(world.ls_B, T1))[0]
    lid = rng.choice(vis_l, min(len(vis_l), n_cand_l), replace=False)
    cpack = np.zeros((nb + 2 * nbl, 3), np.float32)
    cpack[:len(pid)] = world.pts[pid] + rng.normal(0, 0.01, (len(pid), 3))
    cpack[nb:nb + len(lid)] = world.ls_A[lid]
    cpack[nb + nbl:nb + nbl + len(lid)] = world.ls_B[lid]
    dpack = np.zeros((nb + nbl, 8), np.uint32)
    dpack[:len(pid)] = _flip_bits(world.pt_desc[pid], rng)
    dpack[nb:nb + len(lid)] = _flip_bits(world.ls_desc[lid], rng)
    cval = np.zeros(nb + nbl, bool)
    cval[:len(pid)] = True
    cval[nb:nb + len(lid)] = True
    return cpack, dpack.view(np.int32), cval


def links(seed: int, n: int, nl: int, nb: int, nbl: int, n_lm: int = 4000):
    """The previous keyframe's landmark links (int64, -1 unlinked) and the
    candidate -> previous-feature table ``pf`` (int64)."""
    rng = np.random.default_rng(seed)
    pt_lm = np.where(rng.uniform(size=n) < 0.5, rng.integers(0, n_lm, n), -1)
    ls_lm = np.where(rng.uniform(size=nl) < 0.5, rng.integers(0, n_lm, nl), -1)
    pf = np.where(rng.uniform(size=nb + nbl) < 0.3,
                  np.concatenate([rng.integers(0, n, nb), rng.integers(0, nl, nbl)]), -1)
    return pt_lm.astype(np.int64), ls_lm.astype(np.int64), pf.astype(np.int64)


def assoc_inputs(pair, seed: int, nb: int = 256, nbl: int = 64, n_cand: int = 150,
                 n_cand_l: int = 20):
    """The fused association's host inputs for ``keyframe_pair``'s output:
    Tm (prev-cam -> new-cam, new T_c_w, prev T_w_c), the staged
    candidates, the previous keyframe's links and ``pf``."""
    world, T0, T1, f0, _ = pair
    T_c_w = np.linalg.inv(T1)
    Tm = np.stack([T_c_w @ T0, T_c_w, T0]).astype(np.float32)
    cpack, dpack, cval = candidates(world, T1, seed, n_cand, n_cand_l, nb, nbl)
    pt_lm, ls_lm, pf = links(seed, len(f0["points"]["valid"]), len(f0["lines"]["valid"]),
                             nb, nbl)
    return Tm, cpack, dpack, cval, pt_lm, ls_lm, pf


def free_mask(seed: int, f1) -> np.ndarray:
    """Map2KF's ``vpack`` tail: the new keyframe's features not yet
    linked (valid and unlinked with probability 0.7)."""
    rng = np.random.default_rng(seed)
    kp = f1["points"]["valid"] & (rng.uniform(size=len(f1["points"]["valid"])) < 0.7)
    kl = f1["lines"]["valid"] & (rng.uniform(size=len(f1["lines"]["valid"])) < 0.7)
    return np.concatenate([kp, kl])


def refine_arrays(seed: int, f0, T0, T1) -> dict:
    """The refinement's staged fields (``MapHandler._refine``): the
    previous keyframe's 3D features against their projections into the new
    camera (noise 0.5 px), 80% of the valid ones linked, the line
    observations with their normalized image lines."""
    rng = np.random.default_rng(seed)
    DT = np.linalg.inv(T1) @ T0
    fx, fy, cx, cy, _ = CAM_K

    def proj(P):
        Pc = P @ DT[:3, :3].T + DT[:3, 3]
        z = np.maximum(Pc[:, 2], 1e-9)
        return np.stack([cx + fx * Pc[:, 0] / z, cy + fy * Pc[:, 1] / z], -1)

    p, l = f0["points"], f0["lines"]
    n, nl = len(p["valid"]), len(l["valid"])
    val = p["valid"] & (rng.uniform(size=n) < 0.8)
    obs = np.where(val[:, None], proj(p["P"]) + rng.normal(0, 0.5, (n, 2)), 0)
    lval = l["valid"] & (rng.uniform(size=nl) < 0.8)
    sobs = np.where(lval[:, None], proj(l["sP"]) + rng.normal(0, 0.5, (nl, 2)), 0)
    eobs = np.where(lval[:, None], proj(l["eP"]) + rng.normal(0, 0.5, (nl, 2)), 0)
    one = np.ones((nl, 1))
    le = np.cross(np.concatenate([sobs, one], 1), np.concatenate([eobs, one], 1))
    le = np.where(lval[:, None], le / np.maximum(np.hypot(le[:, 0], le[:, 1]), 1e-9)[:, None], 0)
    f32 = np.float32
    return dict(P=p["P"].astype(f32), obs=obs.astype(f32), sigma2=p["sigma2"].astype(f32),
                valid=val, sP=l["sP"].astype(f32), eP=l["eP"].astype(f32),
                sp=l["sp"].astype(f32), ep=l["ep"].astype(f32), NDc=l["NDc"].astype(f32),
                sobs=sobs.astype(f32), eobs=eobs.astype(f32), le=le.astype(f32),
                ls_sigma2=l["sigma2"].astype(f32), lvalid=lval)


def descriptors(seed: int, n: int, n_valid: int):
    """(n, 8) int32 descriptor words and a validity mask with n_valid set."""
    rng = np.random.default_rng(seed)
    desc = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32).view(np.int32)
    valid = np.zeros(n, bool)
    valid[rng.choice(n, n_valid, replace=False)] = True
    return desc, valid


# intrinsics whose line-projection products are exact in float32
# (tests/test_torch_ba.py), so the port's f32-rounded camera equals JAX's f64 one
GBA_INTR = (435.25, 435.25, 367.5, 252.25, 0.110074)


def chunked_problem(seed: int = 0, C: int = 2, K: int = 8, P: int = 24, L: int = 6,
                    endpoint: bool = False, noise: float = 0.3, pert: float = 0.03,
                    dtype=np.float64) -> dict:
    """A stacked chunked-GBA problem (``ba.bundle_adjust_chunked``'s input)
    as numpy fields by name: C landmark-disjoint chunks of P points and L
    lines, each seen by every one of K cameras (observations with
    ``noise`` px), pose 0 fixed, a start perturbed by ``pert``.  Plücker
    lines in their own table, or (``endpoint``) two endpoint slots per
    line after the chunk's points, observed as point rows against the
    normalized image line.  Index fields int64."""
    import torch

    from plslam_tpu_torch.core import lie
    from plslam_tpu_torch.core.plucker import plucker_from_two_points, plucker_to_orth

    rng = np.random.default_rng(seed)
    fx, fy, cx, cy, _ = GBA_INTR
    xi = np.concatenate([rng.uniform(-0.5, 0.5, (K, 2)), rng.uniform(-0.1, 0.1, (K, 1)),
                         rng.uniform(-0.05, 0.05, (K, 3))], axis=1)
    T_c_w = lie.inv_se3(lie.exp_se3(torch.from_numpy(xi))).numpy()
    dxi = rng.normal(size=(K, 6)) * pert
    dxi[0] = 0.0
    T0 = lie.exp_se3(torch.from_numpy(dxi)).numpy() @ T_c_w

    def proj(X):   # (K, n, 3) world points -> (K * n, 2) pixels in each camera
        Pc = np.einsum("kij,nj->kni", T_c_w[:, :3, :3], X) + T_c_w[:, None, :3, 3]
        uv = np.stack([fx * Pc[..., 0] / Pc[..., 2] + cx, fy * Pc[..., 1] / Pc[..., 2] + cy],
                      -1)
        return uv.reshape(-1, 2) + rng.normal(size=(K * len(X), 2)) * noise

    cam_of = lambda n: np.repeat(np.arange(K), n)   # noqa: E731
    chunks = []
    for _ in range(C):
        Pw = np.stack([rng.uniform(-3, 3, P), rng.uniform(-2, 2, P), rng.uniform(4, 10, P)], -1)
        A = np.stack([rng.uniform(-3, 3, L), rng.uniform(-2, 2, L), rng.uniform(4, 10, L)], -1)
        B = A + np.stack([rng.uniform(-1.5, 1.5, L), rng.uniform(-1.5, 1.5, L),
                          rng.uniform(-0.5, 0.5, L)], -1)
        uv, s_uv, e_uv = proj(Pw), proj(A), proj(B)
        ch = dict(p_cam=cam_of(P), p_lm=np.tile(np.arange(P), K), p_uv=uv)
        if endpoint:
            one = np.ones((K * L, 1))
            lo = np.cross(np.concatenate([s_uv, one], 1), np.concatenate([e_uv, one], 1))
            lo /= np.hypot(lo[:, 0], lo[:, 1])[:, None]
            slots = np.stack([A, B], 1).reshape(2 * L, 3)
            n_obs = K * (P + 2 * L)
            ch = dict(
                points=np.concatenate([Pw, slots]) + rng.normal(size=(P + 2 * L, 3)) * pert,
                point_valid=np.ones(P + 2 * L, bool),
                lines_orth=np.zeros((1, 4)), lines_scale=np.ones(1), line_valid=np.zeros(1, bool),
                p_cam=np.concatenate([ch["p_cam"], cam_of(2 * L)]),
                p_lm=np.concatenate([ch["p_lm"], np.tile(P + np.arange(2 * L), K)]),
                p_uv=np.concatenate([uv, np.zeros((2 * K * L, 2))]),
                p_sigma2=np.ones(n_obs), p_valid=np.ones(n_obs, bool),
                p_lo=np.concatenate([np.zeros((K * P, 3)), np.repeat(lo, 2, axis=0)]),
                p_is_line=np.arange(n_obs) >= K * P,
                l_cam=np.zeros(1, np.int64), l_lm=np.zeros(1, np.int64),
                l_sobs=np.zeros((1, 2)), l_eobs=np.zeros((1, 2)), l_sigma2=np.ones(1),
                l_valid=np.zeros(1, bool))
        else:
            Lw = plucker_from_two_points(torch.from_numpy(A), torch.from_numpy(B))
            scale = torch.linalg.norm(Lw, dim=-1)
            orth = plucker_to_orth(Lw / scale[:, None]).numpy()
            ch.update(points=Pw + rng.normal(size=(P, 3)) * pert, point_valid=np.ones(P, bool),
                      lines_orth=orth + rng.normal(size=(L, 4)) * pert * 0.5,
                      lines_scale=scale.numpy(), line_valid=np.ones(L, bool),
                      p_sigma2=np.ones(K * P), p_valid=np.ones(K * P, bool),
                      l_cam=cam_of(L), l_lm=np.tile(np.arange(L), K), l_sobs=s_uv, l_eobs=e_uv,
                      l_sigma2=np.ones(K * L), l_valid=np.ones(K * L, bool))
        chunks.append(ch)
    out = {k: np.stack([c[k] for c in chunks]) for k in chunks[0]}
    out.update(T_c_w=T0, pose_fixed=np.arange(K) == 0, pose_valid=np.ones(K, bool))
    return {k: v.astype(np.int64) if v.dtype.kind in "iu"
            else v.astype(dtype) if v.dtype.kind == "f" else v for k, v in out.items()}
