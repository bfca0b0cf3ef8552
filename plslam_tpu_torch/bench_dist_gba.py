"""kf-block sharded global BA on a long ring trajectory against the
single-device chunked GBA (the port of ``scripts/bench_dist_gba.py``).

The ring map (``io/ring_map.build_ring_map``: seed 7, N_KF keyframes,
128 N_KF points, 8 N_KF lines, the JAX script's draws) goes through:

- ``single``: the chunked GBA in this process
  (``MapHandler.global_bundle_adjustment``);
- ``mesh{w}``: the kf-block GBA (``parallel/dist_gba``) over a 1-D mesh of
  w ranks, started by ``parallel.launch``;
- ``mesh{h}x{w/h}``: the same over the 2-axis ("dcn", "ici") mesh.

On the card w is the number of visible cards, one NCCL rank each, and the
2-axis mesh is (1, w): one host.  With ``--device cpu`` w is 8 gloo ranks
and the 2-axis mesh the JAX script's (2, 4).

    python -m plslam_tpu_torch.bench_dist_gba [N_KF] [single|meshN|...] [--device cuda|cpu]

Prints the JAX script's one JSON line: n_kf, n_pts, n_ls, pre_err and an
entry per form with wall_s, pt_err (the median point error to the truth
of the points seen twice), chunks, chunks_per_device (1-D mesh) and
peak_rss_gb (this process's, or rank 0's for a mesh); the card's name and
power limit go to standard error.
"""

from __future__ import annotations

import argparse
import json
import resource
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from .bench import Say, card, resolve_device
from .io.ring_map import build_ring_map
from .parallel import dist_gba, multihost
from .parallel.launch import launch
from .parallel.mesh import make_mesh

N_KF = 128
CPU_RANKS = 8
CPU_HOSTS = 2     # the JAX script's 2x4 mesh
TIMEOUT_S = 1800.0


def sizes(n_kf: int) -> dict:
    return {"n_kf": n_kf, "n_pts": n_kf * 128, "n_ls": n_kf * 8}


def build(n_kf: int, device):
    """(mapper, (T_true, pt_true)): the JAX script's ``build``."""
    s = sizes(n_kf)
    return build_ring_map(rng_seed=7, n_kf=n_kf, n_pts=s["n_pts"], n_ls=s["n_ls"],
                          pose_noise=0.01, lm_noise=0.03, device=device)


def pt_err(mapper, pt_true) -> float:
    mp = mapper.map
    el = np.where(mp.pt_valid & (mp.pt_nobs >= 2))[0]
    return float(np.median(np.linalg.norm(mp.pt_w[el] - pt_true[el], axis=1)))


def peak_rss_gb() -> float:
    return round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6, 2)


def mesh_names(world: int, device_type: str) -> tuple[str, str]:
    """The 1-D and the 2-axis form's keys at ``world`` ranks."""
    hosts = CPU_HOSTS if device_type == "cpu" else 1
    return f"mesh{world}", f"mesh{hosts}x{world // hosts}"


def rank_main(inputs: dict) -> dict:
    """One rank of the mesh forms (``parallel.launch`` target): per name in
    ``inputs["meshes"]`` a fresh ring map, its error before, the kf-block
    GBA on that mesh, the error after and the chunk count."""
    dt = inputs["device_type"]
    dev = torch.device("cuda", torch.cuda.current_device()) if dt == "cuda" else torch.device(dt)
    flat, _ = mesh_names(dist.get_world_size(), dt)
    out = {}
    for name in inputs["meshes"]:
        mapper, (_, pt_true) = build(int(inputs["n_kf"]), dev)
        out[f"{name}__pre_err"] = pt_err(mapper, pt_true)
        if name == flat:
            mesh = make_mesh(dist_gba.AXIS, dt)
        else:
            hosts, per_host = map(int, name[len("mesh"):].split("x"))
            mesh = multihost.make_multihost_mesh(hosts, per_host, device_type=dt)
        t0 = time.perf_counter()
        blk = dist_gba.distributed_global_bundle_adjustment(mapper, mesh)
        out[f"{name}__wall_s"] = time.perf_counter() - t0
        out[f"{name}__pt_err"] = pt_err(mapper, pt_true)
        out[f"{name}__chunks"] = len(blk.metas)
        out[f"{name}__peak_rss_gb"] = peak_rss_gb()
    return out


def run(n_kf: int = N_KF, only: str | None = None, *, device="cuda",
        timeout: float = TIMEOUT_S) -> dict:
    """The JAX script's ``main``: returns {"line": its JSON object, "pre_err"
    and "pt_err" (per form) unrounded, "world": the mesh forms' ranks}."""
    dev = torch.device(device)
    world = torch.cuda.device_count() if dev.type == "cuda" else CPU_RANKS
    flat, grid = mesh_names(world, dev.type)
    want = lambda k: only is None or only == k  # noqa: E731
    results, errs, pre = {}, {}, None
    if want("single"):
        mapper, (_, pt_true) = build(n_kf, dev)
        pre = pt_err(mapper, pt_true)
        t0 = time.perf_counter()
        mapper.global_bundle_adjustment()
        wall = time.perf_counter() - t0
        errs["single"] = pt_err(mapper, pt_true)
        results["single"] = {"wall_s": round(wall, 1), "pt_err": round(errs["single"], 5),
                             "peak_rss_gb": peak_rss_gb()}
        del mapper
    meshes = [m for m in (flat, grid) if want(m)]
    if meshes:
        o = launch("plslam_tpu_torch.bench_dist_gba:rank_main", world,
                   {"n_kf": n_kf, "meshes": meshes, "device_type": dev.type}, timeout=timeout,
                   device_type=dev.type)[0]
        for m in meshes:
            if pre is None:
                pre = float(o[f"{m}__pre_err"])
            errs[m] = float(o[f"{m}__pt_err"])
            chunks = int(o[f"{m}__chunks"])
            entry = {"wall_s": round(float(o[f"{m}__wall_s"]), 1), "pt_err": round(errs[m], 5),
                     "chunks": chunks}
            if m == flat:
                entry["chunks_per_device"] = -(-chunks // world)
            entry["peak_rss_gb"] = float(o[f"{m}__peak_rss_gb"])
            results[m] = entry
    line = {**sizes(n_kf), "pre_err": round(pre, 5), **results}
    return {"line": line, "pre_err": pre, "pt_err": errs, "world": world}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_kf", nargs="?", type=int, default=N_KF, help=f"keyframes (default {N_KF})")
    ap.add_argument("only", nargs="?", default=None,
                    help="run one form: single, mesh{w} or mesh{h}x{w/h}")
    ap.add_argument("--device", default="cuda", help="cuda (default: card 0) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    say = Say()
    say(f"device={dev} card={card(dev)} torch {torch.__version__}")
    out = run(args.n_kf, args.only, device=dev)
    say(f"{out['world']} rank(s) for the mesh forms")
    print(json.dumps(out["line"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
