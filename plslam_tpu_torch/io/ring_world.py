"""A ring-corridor world rendered straight into keyframe features (no
images): the loop-closure replays' input.

numpy twin of ``tests/_map_fixtures.RingWorld`` and
``render_ring_features`` (same draws, same order; ``tests/
test_torch_chip_smoke.py`` holds them equal): points and wall-tangent or
vertical segments on a cylindrical corridor wall, each with a random
256-bit descriptor, projected into a camera on the ring looking outward.
"""

from __future__ import annotations

import functools

import numpy as np


class RingWorld:
    """Points and wall-tangent segments on a cylindrical corridor wall."""

    def __init__(self, n_pts=3000, n_ls=300, seed=5, radius=8.0, depth=(3.0, 8.0),
                 height=2.5):
        rng = np.random.default_rng(seed)
        self.radius = radius
        phi = rng.uniform(0, 2 * np.pi, n_pts)
        rp = radius + rng.uniform(depth[0], depth[1], n_pts)
        self.pts = np.stack([rp * np.cos(phi), rng.uniform(-height, height, n_pts),
                             rp * np.sin(phi)], axis=-1)
        self.pt_desc = rng.integers(0, 2 ** 32, (n_pts, 8), dtype=np.uint32)
        phi = rng.uniform(0, 2 * np.pi, n_ls)
        rl = radius + rng.uniform(depth[0], depth[1], n_ls)
        A = np.stack([rl * np.cos(phi), rng.uniform(-height, height, n_ls),
                      rl * np.sin(phi)], axis=-1)
        tang = np.stack([-np.sin(phi), np.zeros(n_ls), np.cos(phi)], -1)
        vert = np.stack([np.zeros(n_ls), np.ones(n_ls), np.zeros(n_ls)], -1)
        is_v = rng.uniform(size=n_ls) < 0.4
        B = A + np.where(is_v[:, None], vert, tang) * rng.uniform(0.8, 2.0, n_ls)[:, None]
        self.ls_A, self.ls_B = A, B
        self.ls_desc = rng.integers(0, 2 ** 32, (n_ls, 8), dtype=np.uint32)

    def pose_at(self, theta: float) -> np.ndarray:
        """Camera->world pose on the ring at angle theta, looking outward."""
        z = np.array([np.cos(theta), 0.0, np.sin(theta)])
        y = np.array([0.0, 1.0, 0.0])
        T = np.eye(4)
        T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = np.cross(y, z), y, z, self.radius * z
        return T


def _desc_noise(desc, n_bits, rng):
    """Flip n_bits random bits per descriptor (a few bits differ between
    sightings of one feature)."""
    if n_bits <= 0 or not len(desc):
        return desc
    out = desc.copy()
    words = rng.integers(0, 8, (len(desc), n_bits))
    bits = rng.integers(0, 32, (len(desc), n_bits))
    for j in range(n_bits):
        out[np.arange(len(desc)), words[:, j]] ^= np.uint32(1) << bits[:, j].astype(np.uint32)
    return out


def render_ring_features(world, T_w_c, cam, rng, cap_pt=160, cap_ls=24, desc_noise_bits=6,
                         width=752, height=480):
    """The cap_pt points and cap_ls segments nearest the image centre,
    padded, as {"points": {...}, "lines": {...}} of numpy arrays (uint32
    words); ``cam`` is (fx, fy, cx, cy, b) as floats, ``rng`` draws the
    descriptor noise."""
    fx, fy, cx, cy, bl = cam
    T_c_w = np.linalg.inv(T_w_c)
    R, t = T_c_w[:3, :3], T_c_w[:3, 3]

    def proj(Pw):
        Pc = Pw @ R.T + t
        z = np.maximum(Pc[:, 2], 1e-9)
        uv = np.stack([cx + fx * Pc[:, 0] / z, cy + fy * Pc[:, 1] / z], -1)
        ok = ((Pc[:, 2] > 0.5) & (uv[:, 0] >= 8) & (uv[:, 0] < width - 8)
              & (uv[:, 1] >= 8) & (uv[:, 1] < height - 8))
        return Pc, uv, ok

    Pc, uv, ok = proj(world.pts)
    d2 = (uv[:, 0] - cx) ** 2 + (uv[:, 1] - cy) ** 2
    d2[~ok] = np.inf
    sel = np.argsort(d2)[:cap_pt]
    sel = sel[np.isfinite(d2[sel])]
    n = len(sel)
    f32 = functools.partial(np.zeros, dtype=np.float32)
    points = dict(uv=f32((cap_pt, 2)), disp=np.ones(cap_pt, np.float32), P=f32((cap_pt, 3)),
                  desc=np.zeros((cap_pt, 8), np.uint32), sigma2=np.ones(cap_pt, np.float32),
                  valid=np.arange(cap_pt) < n)
    points["uv"][:n] = uv[sel]
    points["P"][:n] = Pc[sel]
    points["desc"][:n] = _desc_noise(world.pt_desc[sel], desc_noise_bits, rng)
    points["disp"][:n] = fx * bl / np.maximum(Pc[sel, 2], 1e-9)

    aC, auv, aok = proj(world.ls_A)
    bC, buv, bok = proj(world.ls_B)
    lok = aok & bok
    mid2 = ((0.5 * (auv + buv) - np.array([cx, cy])) ** 2).sum(-1)
    mid2[~lok] = np.inf
    lsel = np.argsort(mid2)[:cap_ls]
    lsel = lsel[np.isfinite(mid2[lsel])]
    m = len(lsel)
    lines = dict(sp=f32((cap_ls, 2)), ep=f32((cap_ls, 2)), sdisp=np.ones(cap_ls, np.float32),
                 edisp=np.ones(cap_ls, np.float32), sP=f32((cap_ls, 3)), eP=f32((cap_ls, 3)),
                 le=f32((cap_ls, 3)), angle=None, NDc=f32((cap_ls, 6)),
                 desc=np.zeros((cap_ls, 8), np.uint32), sigma2=np.ones(cap_ls, np.float32),
                 valid=np.arange(cap_ls) < m)
    if m:
        a2, b2 = auv[lsel], buv[lsel]
        le = np.cross(np.concatenate([a2, np.ones((m, 1))], 1),
                      np.concatenate([b2, np.ones((m, 1))], 1))
        lines["le"][:m] = le / np.maximum(np.hypot(le[:, 0], le[:, 1]), 1e-9)[:, None]
        lines["sp"][:m], lines["ep"][:m] = a2, b2
        lines["sP"][:m], lines["eP"][:m] = aC[lsel], bC[lsel]
        lines["NDc"][:m] = np.concatenate([np.cross(aC[lsel], bC[lsel]),
                                           bC[lsel] - aC[lsel]], axis=-1)
        lines["desc"][:m] = _desc_noise(world.ls_desc[lsel], desc_noise_bits, rng)
    lines["angle"] = np.arctan2(lines["ep"][:, 1] - lines["sp"][:, 1],
                                lines["ep"][:, 0] - lines["sp"][:, 0]).astype(np.float32)
    return {"points": points, "lines": lines}
