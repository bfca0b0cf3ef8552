"""Seeded stereo scenes rendered on the device: one closed lap of a route,
its landmarks and its ground-truth poses.

The projection and the splat follow the port's host renderer
(``io/synthetic.SyntheticScene``: a Gaussian blob per point landmark, a
chain of smaller blobs along each projected line segment, composed by a
per-pixel maximum over a grey background, then sensor noise), rewritten as
batched tensor code so that a lap renders in seconds.  Nothing here imports
the port.

A route is a closed lap: ``sides`` straight stretches of ``straight_m``,
each followed by a right turn of ``360 / sides`` degrees on a circle of
``turn_radius_m``; one side with no straight is a circle.  The camera looks
along the path (camera x right, y down, z forward; world y down), bobs
vertically by ``bob_m`` over ``bob_cycles`` periods a lap, and starts at
the identity pose.  Landmarks lie beside the path, ``near_m`` to ``far_m``
from it on the sides listed in ``walls`` (-1 left, +1 right), at heights
``height_m``.  The landmarks come from the traffic's ``world_seed``, every
count from the traffic file, and the run's seed draws the sensor noise, so
every seed renders the same world and the same amount of work.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

BACKGROUND = 30.0
POINT_SIGMA, POINT_RAD = 1.1, 3
LINE_SIGMA, LINE_RAD = 0.9, 2
MAX_LINE_SAMPLES = 8192


@dataclass(frozen=True)
class Camera:
    """Rectified stereo pinhole camera of a deployment."""

    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float
    baseline: float

    @classmethod
    def from_config(cls, cfg: dict) -> "Camera":
        c = cfg["camera"]
        return cls(int(c["width"]), int(c["height"]), float(c["fx"]), float(c["fy"]),
                   float(c["cx"]), float(c["cy"]), float(c["baseline"]))


class Route:
    """The lap's geometry as a function of arc length."""

    def __init__(self, route: dict):
        self.sides = int(route["sides"])
        self.straight = float(route["straight_m"])
        self.radius = float(route["turn_radius_m"])
        self.frames = int(route["frames"])
        self.bob = float(route.get("bob_m", 0.0))
        self.bob_cycles = int(route.get("bob_cycles", 0))
        self.turn = 2.0 * math.pi / self.sides
        self.side_len = self.straight + self.radius * self.turn
        self.length = self.sides * self.side_len

    def frenet(self, s: np.ndarray):
        """(position (n, 3), heading angle (n,)) at arc lengths ``s``."""
        s = np.mod(np.asarray(s, np.float64), self.length)
        k = np.floor(s / self.side_len).astype(np.int64)
        k = np.minimum(k, self.sides - 1)
        local = s - k * self.side_len
        # the start of side k and its heading: walk the previous sides
        start = np.zeros((self.sides, 3))
        for j in range(1, self.sides):
            th = (j - 1) * self.turn
            p = start[j - 1] + self.straight * _dir(th)
            start[j] = _center(p, th, self.radius) - self.radius * _normal(th + self.turn)
        th0 = k * self.turn
        on_straight = local < self.straight
        p_str = start[k] + np.minimum(local, self.straight)[:, None] * _dir(th0)
        alpha = np.maximum(local - self.straight, 0.0) / self.radius
        ctr = _center(p_str, th0, self.radius)
        p_turn = ctr - self.radius * _normal(th0 + alpha)
        pos = np.where(on_straight[:, None], p_str, p_turn)
        heading = th0 + np.where(on_straight, 0.0, alpha)
        if self.bob_cycles:
            pos[:, 1] = self.bob * np.sin(2.0 * math.pi * self.bob_cycles * s / self.length)
        return pos, heading

    def poses(self) -> np.ndarray:
        """(frames, 4, 4) camera -> world poses of one lap, float64; frame 0
        is the identity."""
        s = np.arange(self.frames) * (self.length / self.frames)
        pos, th = self.frenet(s)
        T = np.tile(np.eye(4), (self.frames, 1, 1))
        c, si = np.cos(th), np.sin(th)
        T[:, 0, 0], T[:, 0, 2], T[:, 2, 0], T[:, 2, 2] = c, si, -si, c
        T[:, :3, 3] = pos
        return T


def _dir(th):
    th = np.asarray(th, np.float64)
    return np.stack([np.sin(th), np.zeros_like(th), np.cos(th)], -1)


def _normal(th):
    """The camera's x axis (right of the heading) in the world."""
    th = np.asarray(th, np.float64)
    return np.stack([np.cos(th), np.zeros_like(th), -np.sin(th)], -1)


def _center(p, th, r):
    return p + r * _normal(th)


def _uniform(gen, n, lo, hi, device):
    return lo + (hi - lo) * torch.rand(n, generator=gen, device=device, dtype=torch.float64)


@dataclass
class Landmarks:
    P: torch.Tensor          # (Np, 3) world points
    P_bright: torch.Tensor   # (Np,)
    LA: torch.Tensor         # (Nl, 3) segment start
    LB: torch.Tensor         # (Nl, 3) segment end
    L_bright: torch.Tensor   # (Nl,)


def landmarks(route: Route, traffic: dict, gen: torch.Generator, device) -> Landmarks:
    """Point and line landmarks beside the route, drawn from ``gen``: arc
    position, wall side, distance from the path and height; each segment
    runs vertical or along the path."""
    lm = traffic["landmarks"]
    walls = torch.tensor(lm["walls"], dtype=torch.float64, device=device)
    lo, hi = lm["near_m"], lm["far_m"]
    y0, y1 = lm["height_m"]

    def place(n):
        s = _uniform(gen, n, 0.0, route.length, device)
        side = walls[torch.randint(len(lm["walls"]), (n,), generator=gen, device=device)]
        off = _uniform(gen, n, lo, hi, device) * side
        y = _uniform(gen, n, y0, y1, device)
        pos, th = route.frenet(s.cpu().numpy())
        pos = torch.as_tensor(pos, device=device) + off[:, None] * torch.as_tensor(
            _normal(th), device=device)
        pos[:, 1] = y
        return pos, torch.as_tensor(th, device=device)

    n_p, n_l = int(lm["points"]), int(lm["lines"])
    P, _ = place(n_p)
    P_bright = _uniform(gen, n_p, 120.0, 250.0, device)
    A, th = place(n_l)
    length = _uniform(gen, n_l, *lm["line_length_m"], device)
    vertical = torch.rand(n_l, generator=gen, device=device) < lm["vertical_share"]
    along = torch.stack([torch.sin(th), torch.zeros_like(th), torch.cos(th)], -1)
    up = torch.tensor([0.0, -1.0, 0.0], dtype=torch.float64, device=device).expand(n_l, 3)
    B = A + length[:, None] * torch.where(vertical[:, None], up, along)
    L_bright = _uniform(gen, n_l, 140.0, 250.0, device)
    return Landmarks(P, P_bright, A, B, L_bright)


def _project(T_c_w: torch.Tensor, X: torch.Tensor, cam: Camera):
    """(V, 4, 4) x (N, 3) -> u, v, z of shape (V, N)."""
    Xc = torch.einsum("vij,nj->vni", T_c_w[:, :3, :3], X) + T_c_w[:, None, :3, 3]
    z = Xc[..., 2]
    zc = torch.clamp(z, min=1e-6)
    return cam.cx + cam.fx * Xc[..., 0] / zc, cam.cy + cam.fy * Xc[..., 1] / zc, z


def _splat(flat: torch.Tensor, view, u, v, bright, cam: Camera, sigma, rad):
    """Max-compose Gaussian blobs centred at (u, v) into the flat (V*H*W)
    image stack; a blob that would cross the border is skipped."""
    x0, y0 = torch.floor(u), torch.floor(v)
    ok = (x0 >= rad) & (x0 < cam.width - rad - 1) & (y0 >= rad) & (y0 < cam.height - rad - 1)
    view, u, v, bright, x0, y0 = (t[ok] for t in (view, u, v, bright, x0, y0))
    d = torch.arange(-rad, rad + 1, device=u.device, dtype=u.dtype)
    xs = x0[:, None, None] + d[None, None, :]
    ys = y0[:, None, None] + d[None, :, None]
    g = torch.exp(-((xs - u[:, None, None]) ** 2 + (ys - v[:, None, None]) ** 2)
                  / (2.0 * sigma * sigma))
    val = (bright[:, None, None] * g).to(torch.float32)
    idx = (view[:, None, None] * (cam.height * cam.width)
           + ys.long() * cam.width + xs.long())
    flat.scatter_reduce_(0, idx.reshape(-1), val.reshape(-1), "amax")


def render_views(T_c_w: torch.Tensor, marks: Landmarks, cam: Camera) -> torch.Tensor:
    """Noise-free (V, H, W) float32 renders for camera poses (world ->
    camera)."""
    V = T_c_w.shape[0]
    dev = T_c_w.device
    flat = torch.full((V * cam.height * cam.width,), BACKGROUND, dtype=torch.float32,
                      device=dev)
    views = torch.arange(V, device=dev)
    u, v, z = _project(T_c_w, marks.P, cam)
    ok = z > 0.5
    vi = views[:, None].expand_as(u)
    br = marks.P_bright[None].expand_as(u)
    _splat(flat, vi[ok], u[ok], v[ok], br[ok], cam, POINT_SIGMA, POINT_RAD)

    ua, va, za = _project(T_c_w, marks.LA, cam)
    ub, vb, zb = _project(T_c_w, marks.LB, cam)
    ok = (za > 0.5) & (zb > 0.5)
    n = (torch.maximum((ub - ua).abs(), (vb - va).abs()) * 2.0).floor() + 2
    n = torch.where(ok, n.clamp(max=MAX_LINE_SAMPLES), torch.zeros_like(n)).long()
    n_flat = n.reshape(-1)
    seg = torch.repeat_interleave(torch.arange(n_flat.numel(), device=dev), n_flat)
    start = torch.cumsum(n_flat, 0) - n_flat
    k = torch.arange(seg.numel(), device=dev) - start[seg]
    t = k.to(torch.float64) / (n_flat[seg] - 1).to(torch.float64)
    ua, va, ub, vb = (x.reshape(-1)[seg] for x in (ua, va, ub, vb))
    xs = ua + t * (ub - ua)
    ys = va + t * (vb - va)
    br = marks.L_bright[None].expand(V, -1).reshape(-1)[seg]
    _splat(flat, seg // marks.LA.shape[0], xs, ys, br, cam, LINE_SIGMA, LINE_RAD)
    return flat.view(V, cam.height, cam.width)


def stereo_views(T_w_c: torch.Tensor, baseline: float) -> torch.Tensor:
    """(2F, 4, 4) world -> camera transforms, left and right of each pose
    interleaved; the right camera sits ``baseline`` along the left's x."""
    T_c_w = torch.linalg.inv(T_w_c)
    shift = torch.eye(4, dtype=T_w_c.dtype, device=T_w_c.device)
    shift[0, 3] = -baseline
    return torch.stack([T_c_w, shift @ T_c_w], 1).reshape(-1, 4, 4)


@dataclass
class Lap:
    frames: torch.Tensor     # (F, 2, H, W) uint8 (left, right)
    poses: np.ndarray        # (F, 4, 4) float64 camera -> world, ground truth
    marks: Landmarks
    cam: Camera


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    return gen


def render_lap(cam: Camera, traffic: dict, seed: int, device, chunk: int = 32) -> Lap:
    """One closed lap of ``traffic``'s route rendered on ``device``: the
    landmarks of the traffic's ``world_seed`` (one hall or block, as a
    recorded dataset has one), the sensor noise of ``traffic["noise"]`` grey
    levels drawn from ``seed``, rounded to uint8."""
    route = Route(traffic["route"])
    marks = landmarks(route, traffic, generator(traffic["landmarks"]["world_seed"], device),
                      device)
    gen = generator(seed, device)
    poses = route.poses()
    T = torch.as_tensor(poses, device=device)
    noise = float(traffic["noise"])
    out = torch.empty((route.frames, 2, cam.height, cam.width), dtype=torch.uint8,
                      device=device)
    for a in range(0, route.frames, chunk):
        b = min(a + chunk, route.frames)
        img = render_views(stereo_views(T[a:b], cam.baseline), marks, cam)
        if noise > 0:
            img = img + noise * torch.randn(img.shape, generator=gen, device=device,
                                            dtype=torch.float32)
        out[a:b] = img.clamp_(0, 255).round_().to(torch.uint8).view(b - a, 2, cam.height,
                                                                    cam.width)
    return Lap(out, poses, marks, cam)


def in_view(lap_poses: np.ndarray, marks: Landmarks, cam: Camera) -> tuple:
    """Mean point and line landmarks in the left view over the lap (a
    point whose blob lands inside the image, a line with both ends in
    front and its middle inside)."""
    T = torch.linalg.inv(torch.as_tensor(lap_poses, device=marks.P.device))
    u, v, z = _project(T, marks.P, cam)
    pts = ((z > 0.5) & (u >= POINT_RAD) & (u < cam.width - POINT_RAD - 1)
           & (v >= POINT_RAD) & (v < cam.height - POINT_RAD - 1)).sum(1).double().mean()
    ua, va, za = _project(T, marks.LA, cam)
    ub, vb, zb = _project(T, marks.LB, cam)
    um, vm = (ua + ub) / 2, (va + vb) / 2
    lines = ((za > 0.5) & (zb > 0.5) & (um >= 0) & (um < cam.width) & (vm >= 0)
             & (vm < cam.height)).sum(1).double().mean()
    return float(pts), float(lines)
