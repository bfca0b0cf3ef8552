"""Seeded inputs of the mapper's and the loop closer's per-keyframe programs
(tests/test_torch_graphs_mapping.py and test_torch_graphs_loop.py on the
CPU, tests/test_torch_gpu_graphs.py on the card): two keyframes of the
ring world (``plslam_tpu_torch/io/ring_world.py``), local-map candidates
staged as the mapper stages them, landmark links, the refinement's
correspondences and a corpus of descriptors, all numpy from a seed.  It
imports no jax, so the card's tests can use it."""

from __future__ import annotations

import numpy as np

from plslam_tpu_torch.io.ring_world import RingWorld, render_ring_features

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
