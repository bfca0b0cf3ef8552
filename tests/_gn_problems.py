"""Seeded pose-solve problems for the GN kernel's tests, in torch alone (the
card's tests import it; no jax): ``__graft_entry__``'s synthetic tracking
inputs (points and lines 2.5-9 m ahead of the EuRoC camera, a small
motion) with pixel noise, outliers, masked rows and pyramid weights."""

from __future__ import annotations

import numpy as np
import torch

from plslam_tpu_torch.core import lie
from plslam_tpu_torch.core.camera import euroc_default_camera
from plslam_tpu_torch.core.plucker import plane_from_points, plucker_from_planes
from plslam_tpu_torch.frontend.features import TrackedLines, TrackedPoints


def problem(seed: int, n_pts: int = 256, n_ls: int = 64, noise: float = 0.5,
            outliers: float = 0.1, masked: float = 0.1, device="cpu"):
    """(DT0, TrackedPoints, TrackedLines), float32 on ``device``: the
    identity start, ``masked`` of each modality's rows invalid or outliers
    already flagged, ``outliers`` of the observations moved 20-40 px."""
    cam = euroc_default_camera()
    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    xi = f(rng.uniform(-1, 1, 6) * np.array([0.03, 0.03, 0.05, 0.01, 0.01, 0.01]))
    T = lie.exp_se3(xi)

    def ahead(n):
        return f(np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                           rng.uniform(2.5, 9.0, n)], -1))

    def level(n):
        return f(1.2 ** (-2.0 * rng.integers(0, 4, n)))

    def mask(n):
        return (torch.as_tensor(rng.uniform(size=n) >= masked),
                torch.as_tensor(rng.uniform(size=n) >= masked / 2))

    P = ahead(n_pts)
    obs = cam.project(lie.transform_point(T, P)).numpy()
    obs = obs + rng.normal(0, noise, obs.shape)
    bad = rng.uniform(size=n_pts) < outliers
    obs[bad] += rng.uniform(20, 40, (int(bad.sum()), 2))
    valid, inlier = mask(n_pts)
    pts = TrackedPoints(P=P, obs=f(obs), sigma2=level(n_pts), valid=valid, inlier=inlier)

    A = ahead(n_ls)
    B = A + f(rng.uniform(-1, 1, (n_ls, 3)))
    o2 = torch.tensor([1.0, 0.0, 0.0]) * cam.b
    NDc = plucker_from_planes(plane_from_points(A, B, torch.zeros(3)),
                              plane_from_points(A, B, o2))
    sobs = cam.project(lie.transform_point(T, A)).numpy()
    eobs = cam.project(lie.transform_point(T, B)).numpy()
    sobs = sobs + rng.normal(0, noise, sobs.shape)
    eobs = eobs + rng.normal(0, noise, eobs.shape)
    lbad = rng.uniform(size=n_ls) < outliers
    sobs[lbad] += 25.0
    h = lambda a: np.concatenate([a, np.ones((len(a), 1))], -1)
    le = np.cross(h(sobs), h(eobs))
    le /= np.linalg.norm(le[:, :2], axis=-1, keepdims=True)
    lvalid, linlier = mask(n_ls)
    ls = TrackedLines(sP=A, eP=B, sp=cam.project(A), ep=cam.project(B), NDc=NDc,
                      sobs=f(sobs), eobs=f(eobs), le_obs=f(le), sigma2=level(n_ls),
                      valid=lvalid, inlier=linlier)
    to = lambda tree: type(tree)(*(x.to(device) for x in tree))
    return torch.eye(4, device=device), to(pts), to(ls)


def stack(problems):
    """B problems as one (DT0, TrackedPoints, TrackedLines) with a leading
    axis of B."""
    DT0 = torch.stack([p[0] for p in problems])
    pts = TrackedPoints(*(torch.stack(list(x)) for x in zip(*[p[1] for p in problems])))
    ls = TrackedLines(*(torch.stack(list(x)) for x in zip(*[p[2] for p in problems])))
    return DT0, pts, ls


def plain_batched(tensors, cam, use_points, use_lines, plucker, early_exit, max_iters,
                  min_error, min_error_change):
    """A CPU stand-in for ``cuda_gauss_newton.gauss_newton_cuda`` (same
    arguments, same outputs): the plain twin once per problem, stacked."""
    from plslam_tpu_torch.core.camera import StereoCamera
    from plslam_tpu_torch.frontend import tracker

    c = StereoCamera(*cam, b=0.0)
    cfg = tracker.TrackerConfig(use_points=use_points, use_lines=use_lines,
                                plucker_lines=plucker, early_exit=early_exit,
                                min_error=min_error, min_error_change=min_error_change)
    outs = []
    for b in range(tensors[0].shape[0]):
        x = [t[b] for t in tensors]
        res = tracker.gauss_newton_plain(x[0], TrackedPoints(*x[1:6]), TrackedLines(*x[6:]),
                                         c, cfg, max_iters)
        outs.append((res.DT, res.cov, res.err, res.good, torch.stack(res.done_in)))
    return tuple(torch.stack(o) for o in zip(*outs))
