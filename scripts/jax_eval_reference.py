#!/usr/bin/env python3
"""The JAX package's evaluation programs on the CPU at chip_smoke.py phase
12's sizes: the reference values the port's evaluation path is held against.

    PYTHONPATH=. JAX_PLATFORMS=cpu python scripts/jax_eval_reference.py e2e [N]
    PYTHONPATH=. JAX_PLATFORMS=cpu python scripts/jax_eval_reference.py compare
    PYTHONPATH=. JAX_PLATFORMS=cpu python scripts/jax_eval_reference.py lmq
    PYTHONPATH=. JAX_PLATFORMS=cpu python scripts/jax_eval_reference.py gba
    PYTHONPATH=. JAX_PLATFORMS=cpu python scripts/jax_eval_reference.py gba-seeds [SEED ...]

Each imports the original script (``scripts/e2e_robust.py``,
``compare_line_modes.py``, ``line_match_quality.py``,
``endpoint_gba_ab.py``), edits none of it, runs it at phase 12's size and
prints one JSON line of unrounded values.  ``e2e``: N nuisance frames
(default 48) in both line modes; the TUM dumps go to a temporary
directory.  ``compare``: the 30-frame line-mode comparison.  ``lmq``: the
eight labelled configurations of the line-match harness.  ``gba``: the
three solves of the endpoint-GBA oracle.  ``gba-seeds``: the f32 GBAs of
both packages (JAX and ``plslam_tpu_torch`` on the CPU) on the oracle's
ring from each seed (default 1-7), and the endpoint GBA's first damping
on seed 3 (about 15 min).  Run one subcommand per process:
``endpoint_gba_ab`` turns on JAX's float64 mode when it is imported.
"""

import contextlib
import importlib.util
import io
import json
import os
import re
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name: str, argv=()):
    """Import scripts/<name>.py as a module, with ``argv`` as its command
    line while it loads (e2e_robust reads N_FRAMES from it)."""
    sys.path.insert(0, ROOT)
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "scripts",
                                                                     name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    saved, sys.argv = sys.argv, [spec.origin, *argv]
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.argv = saved
    return mod


def e2e(n: int) -> dict:
    mod = _load("e2e_robust", [str(n)])
    out_dir = tempfile.mkdtemp(prefix="jax_e2e_robust_")
    save_tum, ate_rmse, ates = mod.save_tum, mod.ate_rmse, []
    mod.save_tum = lambda path, *a: save_tum(os.path.join(out_dir, os.path.basename(path)), *a)
    mod.ate_rmse = lambda *a, **k: ates.append(ate_rmse(*a, **k)) or ates[-1]
    runs = []
    run_mode = mod.run_mode
    mod.run_mode = lambda *a: runs.append(run_mode(*a)) or runs[-1]
    mod.main()
    for r, a in zip(runs, ates):
        r["ate_rmse_m_unrounded"] = a
    return {"e2e_robust": runs, "frames": n, "tum_dir": out_dir}


def compare() -> dict:
    import jax.numpy as jnp
    import numpy as np

    mod = _load("compare_line_modes")
    scene = mod.SyntheticScene(seed=5)
    cam = mod.StereoCamera.create(scene.fx, scene.fy, scene.cx, scene.cy, scene.b,
                                  width=scene.width, height=scene.height, dtype=jnp.float32)
    poses = mod.circular_trajectory(mod.N_FRAMES, step_t=0.10, step_r=0.012)
    travel = sum(float(np.linalg.norm(poses[i + 1][:3, 3] - poses[i][:3, 3]))
                 for i in range(len(poses) - 1))
    out = {"travel_m": travel}
    for plucker in (False, True):
        ate, nkf = mod.run_mode(plucker, scene, cam, poses)
        out["plucker" if plucker else "endpoint"] = {"ate_rmse_m": ate, "keyframes": nkf}
    return {"compare_line_modes": out}


def lmq() -> dict:
    """The harness's own ``__main__`` block, its printed rows parsed."""
    import runpy

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path(os.path.join(ROOT, "scripts", "line_match_quality.py"),
                       run_name="__main__")
    rows = []
    for line in buf.getvalue().splitlines():
        m = re.match(r"(.*?)\s+matches=\s*(\d+) correct=\s*(\d+) wrong=\s*(\d+) .*"
                     r"gt-visible detections=(\d+)", line)
        if m:
            rows.append({"label": m.group(1).strip(), "matches": int(m.group(2)),
                         "correct": int(m.group(3)), "wrong": int(m.group(4)),
                         "detections": int(m.group(5))})
    return {"line_match_quality": rows}


def gba() -> dict:
    import numpy as np

    mod = _load("endpoint_gba_ab")
    out = {}
    for name, plucker in (("ours_plucker", True), ("ours_endpoint", False)):
        mapper, (T_true, pt_true) = mod.build(plucker=plucker)
        if plucker:
            out["pre"] = {"pt": mod.pt_err(mapper, pt_true), "pose": mod.pose_err(mapper, T_true)}
        mapper.global_bundle_adjustment()
        out[name] = {"pt": mod.pt_err(mapper, pt_true), "pose": mod.pose_err(mapper, T_true)}
    mapper, (_, pt_true) = mod.build(plucker=False)
    xi, X, E, pt_ids, hist = mod.faithful_endpoint_lm(mapper)
    out["oracle_endpoint_f64"] = {
        "pt": float(np.median(np.linalg.norm(X - pt_true[pt_ids], axis=1))),
        "cost_hist": [float(c) for c in hist], "iters_used": len(hist) - 1}
    return {"endpoint_gba_ab": out}


def gba_seeds(seeds) -> dict:
    """Both packages' f32 chunked GBAs (Plücker and endpoint) on the oracle's
    ring built from each seed, and on seed 3 the endpoint GBA's first LM
    damping lambda_init in {1e-4, 1e-3, 1e-2}: the spread that phase 12's
    GBA bars allow for.  Median point error and mean pose error (m)."""
    import dataclasses

    import numpy as np
    import torch

    from plslam_tpu_torch.io.ring_map import build_ring_map

    mod = _load("endpoint_gba_ab")
    torch.set_num_threads(1)

    def errs(mapper, truth):
        return [mod.pt_err(mapper, truth[1]), mod.pose_err(mapper, truth[0])]

    def both(seed, plucker, lam=None):
        jm, truth = mod.G._build_ring_map(rng_seed=seed, n_kf=mod.N_KF, n_pts=mod.N_PTS,
                                          n_ls=mod.N_LS, pose_noise=0.01, lm_noise=0.03)
        tm, _ = build_ring_map(rng_seed=seed, n_kf=mod.N_KF, n_pts=mod.N_PTS, n_ls=mod.N_LS,
                               pose_noise=0.01, lm_noise=0.03, device="cpu")
        row = {"pre": errs(jm, truth)}
        for name, m in (("jax", jm), ("port", tm)):
            m.cfg = dataclasses.replace(m.cfg, plucker_lines=plucker)
            if lam is not None:
                m.ba_cfg = m.ba_cfg._replace(lambda_init=lam)
            m.global_bundle_adjustment()
            row[name] = errs(m, truth)
        return row

    out = {"seeds": {}, "lambda_init_seed_3": {}}
    for seed in seeds:
        out["seeds"][seed] = {mode: both(seed, mode == "plucker")
                              for mode in ("plucker", "endpoint")}
        print(json.dumps({seed: out["seeds"][seed]}), file=sys.stderr, flush=True)
    for lam in (1e-4, 1e-3, 1e-2):
        out["lambda_init_seed_3"][lam] = both(3, False, lam)
    return {"gba_seeds": out}


def main(argv) -> None:
    if not argv or argv[0] not in ("e2e", "compare", "lmq", "gba", "gba-seeds"):
        raise SystemExit(__doc__)
    if argv[0] == "e2e":
        res = e2e(int(argv[1]) if len(argv) > 1 else 48)
    elif argv[0] == "gba-seeds":
        res = gba_seeds([int(s) for s in argv[1:]] or list(range(1, 8)))
    else:
        res = {"compare": compare, "lmq": lmq, "gba": gba}[argv[0]]()
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
