"""Secondary benchmark: full SLAM frames/s (tracking + threaded mapping +
local BA) and local-BA LM iterations/s on the card (the port of
``bench_slam.py``).

    python -m plslam_tpu_torch.bench_slam [--device cuda|cpu]

Prints bench_slam.py's two JSON lines, ``full_slam_frames_per_s`` and
``local_ba_lm_iterations_per_s``, with its keys; everything else goes to
standard error on ``#`` lines: the card's name and power limit, the
keyframes mapped, and the program captures (association and local-BA
shape buckets, ``graphs.ProgramCache``) that landed inside the timed
window, with the allocator cache releases made before them
(``graphs.stats()``: none while the card has room).  Those captures stay
in the window, as the JAX program's compiles of new buckets stay in its
own.

The LM problem is tests/test_ba.make_problem(K=8, P=512, L=64) cast to
f32: ``make_ba_problem_np`` draws its numbers and ``local_ba_problem``
builds it on the device.  ``lm_rounds`` with 10 trips runs as one
``graphs.Program`` (the counterpart of the JAX ``jax.jit``): one warm-up
call, then 5 timed calls.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time

import numpy as np
import torch

from . import graphs
from .backend import ba
from .backend.mapping import MapConfig
from .bench import SCENE, Say, camera, card, render, resolve_device
from .config import PLSLAMConfig
from .core import lie
from .core.camera import StereoCamera
from .core.plucker import plucker_from_two_points, plucker_to_orth
from .io.synthetic import SyntheticScene
from .pipeline import PLSLAM

N_FRAMES = 16
N_WARMUP = 4
# KF-heavy: stress mapping
CONFIG = dict(orb_nfeatures=1200, lsd_nfeatures=256, min_entropy_ratio=0.99)
MAP_CONFIG = dict(local_ba_kf=8, ba_points=2048, ba_lines=256, ba_pobs=8192, ba_lobs=2048)
# bench_ba_iters: the problem's sizes, LM trips per call and timed calls
BA_SIZE = dict(K=8, P=512, L=64)
LM_ITERS = 10
LM_REPS = 5
LBA_CAM = (435.2, 435.2, 367.4, 252.2, 0.110074)


def make_ba_problem_np(K=8, P=512, L=64, noise=0.0, pert=0.02, seed=11):
    """numpy twin of tests/test_ba.make_problem (same draws, same order):
    every camera sees every landmark, pose 0 fixed, perturbed start."""
    rng = np.random.default_rng(seed)
    poses_xi = np.concatenate([rng.uniform(-0.5, 0.5, (K, 2)), rng.uniform(-0.1, 0.1, (K, 1)),
                               rng.uniform(-0.05, 0.05, (K, 3))], axis=1)
    Pw = np.stack([rng.uniform(-3, 3, P), rng.uniform(-2, 2, P), rng.uniform(4, 10, P)], -1)
    LA = np.stack([rng.uniform(-3, 3, L), rng.uniform(-2, 2, L), rng.uniform(4, 10, L)], -1)
    LB = LA + np.stack([rng.uniform(-1.5, 1.5, L), rng.uniform(-1.5, 1.5, L),
                        rng.uniform(-0.5, 0.5, L)], -1)
    pert_xi = rng.normal(size=(K, 6)) * pert
    pert_xi[0] = 0.0
    pert_P = rng.normal(size=(P, 3)) * pert
    pert_orth = rng.normal(size=(L, 4)) * pert * 0.5
    noise_uv = rng.normal(size=(K * P, 2)) * noise
    noise_s = rng.normal(size=(K * L, 2)) * noise
    noise_e = rng.normal(size=(K * L, 2)) * noise
    return dict(poses_xi=poses_xi, Pw=Pw, LA=LA, LB=LB, pert_xi=pert_xi, pert_P=pert_P,
                pert_orth=pert_orth, noise_uv=noise_uv, noise_s=noise_s, noise_e=noise_e)


def local_ba_problem(dev, K=8, P=512, L=64):
    """bench_slam.py's f32 BA problem on ``dev``: ``make_ba_problem_np``'s
    draws projected by the LBA_CAM camera, whose intrinsics stay f64 here
    as make_problem's do (``StereoCamera.create`` rounds them to f32)."""
    d = {k: torch.from_numpy(v).to(dev) for k, v in make_ba_problem_np(K, P, L).items()}
    cam = StereoCamera(*LBA_CAM)
    T_c_w = lie.inv_se3(lie.exp_se3(d["poses_xi"]))
    cp = torch.arange(K, device=dev).repeat_interleave(P)
    lp = torch.arange(P, device=dev).repeat(K)
    cl = torch.arange(K, device=dev).repeat_interleave(L)
    ll = torch.arange(L, device=dev).repeat(K)
    uv = cam.project(lie.transform_point(T_c_w[cp], d["Pw"][lp])) + d["noise_uv"]
    sA = cam.project(lie.transform_point(T_c_w[cl], d["LA"][ll])) + d["noise_s"]
    eB = cam.project(lie.transform_point(T_c_w[cl], d["LB"][ll])) + d["noise_e"]
    Lw = plucker_from_two_points(d["LA"], d["LB"])
    scale = torch.linalg.norm(Lw, dim=-1)
    orth = plucker_to_orth(Lw / scale[:, None]) + d["pert_orth"]
    f32 = torch.float32
    ones = functools.partial(torch.ones, device=dev)
    return ba.BAProblem(
        T_c_w=(lie.exp_se3(d["pert_xi"]) @ T_c_w).to(f32),
        pose_fixed=torch.arange(K, device=dev) == 0, pose_valid=ones(K, dtype=torch.bool),
        points=(d["Pw"] + d["pert_P"]).to(f32), point_valid=ones(P, dtype=torch.bool),
        lines_orth=orth.to(f32), lines_scale=scale.to(f32), line_valid=ones(L, dtype=torch.bool),
        p_cam=cp, p_lm=lp, p_uv=uv.to(f32), p_sigma2=ones(K * P, dtype=f32),
        p_valid=ones(K * P, dtype=torch.bool),
        l_cam=cl, l_lm=ll, l_sobs=sA.to(f32), l_eobs=eB.to(f32),
        l_sigma2=ones(K * L, dtype=f32), l_valid=ones(K * L, dtype=torch.bool))


def _captures(slam) -> dict[str, int]:
    return {kind: st["captures"] for kind, st in slam.mapper.graph_stats().items()}


def bench_slam(frames=None, *, scene: dict = SCENE, config: dict = CONFIG,
               map_config: dict = MAP_CONFIG, n_warmup: int = N_WARMUP,
               n_frames: int = N_FRAMES, device="cuda") -> dict:
    """bench_slam.py's ``bench_slam`` on ``frames`` (rendered from ``scene``
    when None; ``n_warmup + n_frames`` pairs).  Returns {"fps", "n_kf",
    "captures": program captures per kind inside the timed window,
    "releases": the allocator cache releases before them, "good": every
    frame's good flag}."""
    dev = torch.device(device)
    if frames is None:
        frames = render(scene, n_warmup + n_frames, dev)
    frames = [(torch.as_tensor(il, device=dev), torch.as_tensor(ir, device=dev))
              for il, ir in frames]
    slam = PLSLAM(camera(SyntheticScene(**scene)), PLSLAMConfig(**config),
                  MapConfig(**map_config), device=dev)
    for i in range(n_warmup):
        slam.process(*frames[i], timestamp=0.05 * i)
    slam.wait_until_idle()
    before, released = _captures(slam), graphs.stats()["releases"]
    t0 = time.perf_counter()
    for i in range(n_warmup, n_warmup + n_frames):
        slam.process(*frames[i], timestamp=0.05 * i)
    slam.wait_until_idle()
    dt = time.perf_counter() - t0
    n_kf = len(slam.mapper.map.keyframes)
    captures = {k: n - before[k] for k, n in _captures(slam).items() if n - before[k]}
    released = graphs.stats()["releases"] - released
    slam.finish(run_gba=False)
    return {"fps": n_frames / dt, "n_kf": n_kf, "captures": captures, "releases": released,
            "good": [lg.good for lg in slam.logs]}


def bench_ba_iters(*, reps: int = LM_REPS, device="cuda") -> dict:
    """LM iterations/s of the Schur-complement local BA at the default
    local-map problem size (``BA_SIZE``, ``LM_ITERS`` trips a call, ``reps``
    timed calls).  Returns {"iters_per_s", "cost0", "cost": after the
    trips}."""
    iters = LM_ITERS
    dev = torch.device(device)
    prob = local_ba_problem(dev, **BA_SIZE)
    cam = StereoCamera.create(*LBA_CAM)
    cfg = ba.BAConfig()
    run = graphs.Program(lambda: ba.lm_rounds(prob, cam, cfg, prob.p_valid, prob.l_valid, iters),
                         dev)
    r = run()
    r[0].T_c_w.cpu()
    t0 = time.perf_counter()
    for _ in range(reps):
        r = run()
    r[0].T_c_w.cpu()
    ips = iters * reps / (time.perf_counter() - t0)
    cost0 = float(ba.total_cost(prob, cam, cfg, prob.p_valid, prob.l_valid))
    return {"iters_per_s": ips, "cost0": cost0, "cost": float(r[1])}


def json_lines(fps: float, iters_per_s: float) -> list[dict]:
    """bench_slam.py's two JSON objects."""
    return [{"metric": "full_slam_frames_per_s", "value": round(fps, 3), "unit": "frames/s",
             "vs_baseline": round(fps / 20.0, 3)},
            {"metric": "local_ba_lm_iterations_per_s", "value": round(iters_per_s, 2),
             "unit": "iters/s", "vs_baseline": None}]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default: card 0) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    say = Say()
    say(f"device={dev} card={card(dev)} torch {torch.__version__}")
    s = bench_slam(render(SCENE, N_WARMUP + N_FRAMES, dev), device=dev)
    b = bench_ba_iters(device=dev)
    for line in json_lines(s["fps"], b["iters_per_s"]):
        print(json.dumps(line), flush=True)
    say(f"program captures inside the timed window: {s['captures'] or 'none'}; allocator "
        f"cache releases before them: {s['releases']}")
    say(f"LM cost {b['cost0']:.6g} -> {b['cost']:.6g} after {LM_ITERS} trips")
    print(f"# keyframes mapped during bench: {s['n_kf']}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
