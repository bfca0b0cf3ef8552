#!/usr/bin/env python3
"""Where the JAX package and ``plslam_tpu_torch`` part on ``e2e_robust``'s
nuisance sequence, run single-threaded so each package's run is
deterministic.

    PYTHONPATH=. JAX_PLATFORMS=cpu python scripts/e2e_mode_divergence.py \\
        run PACKAGE MODE [N] [--out FILE] [--noise-seed S]
    python scripts/e2e_mode_divergence.py compare A.json B.json

``run``: renders ``e2e_robust``'s N frames (default 48) at 752x480 (the
port's renderer, equal to the script's serial render), runs PACKAGE
(``jax`` or ``torch``, the latter on the CPU with one intra-op thread) in
MODE (``plucker`` or ``endpoint``) with ``multithread_slam=False`` and the
script's capacities, and writes one JSON record: each frame's VO pose, the
keyframes' frames and their poses as the VO gave them, after the local BAs
and after the final GBA, the local BAs applied, and the aligned keyframe
ATE at each of those three stages.  ``--noise-seed`` reseeds the scene's
random stream (occluders and sensor noise) after the scene is drawn, so
one scene gives several draws of the nuisances.

``compare``: two records of one mode; prints the first frame whose VO
poses part by more than 1e-5 m or 1e-5 rad, the frames after which they
part by 1 mm and 1 cm, the first keyframe decision that differs, and each
record's ATE at the three stages.

``mapper``: the JAX package's keyframes of a ``run`` (its VO poses and
features, recorded as its mapper receives them) replayed into both
packages' ``MapHandler``s with the local BA deferred as in the pipeline;
prints the largest keyframe-pose difference after each keyframe.  Then,
on the first local-BA problem (keyframes 0 and 1, equal in both
packages), one LM trip's step (dpose, dpoint) of each package's f32
solver against the port's solver run in float64, and the two f32 steps
against each other.

    PYTHONPATH=. JAX_PLATFORMS=cpu python scripts/e2e_mode_divergence.py \\
        mapper MODE [N]

``vo-step``: the JAX package's VO over N frames (default 4) in MODE; at
each frame the port's ``vo.match_and_track`` runs from the same state and
the same detections, and the largest |T_f_w| difference is printed.

    PYTHONPATH=. JAX_PLATFORMS=cpu python scripts/e2e_mode_divergence.py \\
        vo-step MODE [N]
"""

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _frames(n: int, noise_seed):
    from plslam_tpu_torch import e2e_robust as E

    scene = E.make_scene()
    if noise_seed is not None:
        scene.rng = np.random.default_rng(noise_seed)
    poses = E.circular_trajectory(n, step_t=0.02, step_r=0.002)
    return scene, poses, E.render_frames(scene, poses, min(4, os.cpu_count() or 1))


def _slam(package: str, plucker: bool, scene):
    cfg_kw = dict(use_line_plucker=plucker, use_loop_closure=False, multithread_slam=False)
    map_kw = dict(use_lines=True, plucker_lines=plucker, local_ba_kf=16, ba_points=2048,
                  ba_lines=256, ba_pobs=16384, ba_lobs=2048)
    cam_kw = dict(width=scene.width, height=scene.height)
    intr = (scene.fx, scene.fy, scene.cx, scene.cy, scene.b)
    if package == "jax":
        import jax.numpy as jnp

        from plslam_tpu.backend.mapping import MapConfig
        from plslam_tpu.config import PLSLAMConfig
        from plslam_tpu.core.camera import StereoCamera
        from plslam_tpu.pipeline import PLSLAM

        cam = StereoCamera.create(*intr, dtype=jnp.float32, **cam_kw)
        return PLSLAM(cam, PLSLAMConfig(**cfg_kw), MapConfig(**map_kw))
    import torch

    from plslam_tpu_torch.backend.mapping import MapConfig
    from plslam_tpu_torch.config import PLSLAMConfig
    from plslam_tpu_torch.core.camera import StereoCamera
    from plslam_tpu_torch.pipeline import PLSLAM

    torch.set_num_threads(1)
    cam = StereoCamera.create(*intr, **cam_kw)
    return PLSLAM(cam, PLSLAMConfig(**cfg_kw), MapConfig(**map_kw), device="cpu")


def run(package: str, mode: str, n: int, noise_seed) -> dict:
    from plslam_tpu_torch.io.trajectory import ate_rmse

    scene, poses, frames = _frames(n, noise_seed)
    slam = _slam(package, mode == "plucker", scene)
    vo = [np.eye(4)]
    for i, (il, ir) in enumerate(frames):
        res = slam.process(il, ir, timestamp=0.05 * i)
        if res is not None:
            T = res.T_f_w.cpu().numpy() if hasattr(res.T_f_w, "cpu") else np.asarray(res.T_f_w)
            vo.append(np.asarray(T, np.float64).reshape(4, 4))
    slam.wait_until_idle()
    kf_frames = [0] + [lg.frame for lg in slam.logs if lg.is_kf]
    after_lba = [k.T_w_k.copy() for k in slam.mapper.map.keyframes]
    slam.finish(run_gba=True)
    after_gba = [k.T_w_k.copy() for k in slam.mapper.map.keyframes]
    gt = np.stack([poses[i][:3, 3] for i in kf_frames])

    def ate(Ts):
        return float(ate_rmse(np.stack([T[:3, 3] for T in Ts]), gt))

    return {
        "package": package, "mode": mode, "frames": n, "noise_seed": noise_seed,
        "good": [bool(lg.good) for lg in slam.logs],
        "kf_frames": kf_frames, "lba_applied": int(getattr(slam.mapper, "n_local_ba_applied", -1)),
        "ate": {"vo": ate([vo[i] for i in kf_frames]), "lba": ate(after_lba),
                "gba": ate(after_gba)},
        "vo": [T.tolist() for T in vo],
        "kf_after_lba": [T.tolist() for T in after_lba],
        "kf_after_gba": [T.tolist() for T in after_gba],
        "gt": [poses[i].tolist() for i in range(n)],
    }


def compare(a: dict, b: dict) -> dict:
    va, vb = np.asarray(a["vo"]), np.asarray(b["vo"])
    dt = np.linalg.norm(va[:, :3, 3] - vb[:, :3, 3], axis=1)
    # the rotation angle between them (small angles; f32 rotations are not
    # orthonormal enough for an arccos of the trace)
    dr = np.linalg.norm(va[:, :3, :3] - vb[:, :3, :3], axis=(1, 2)) / np.sqrt(2.0)
    gt = np.asarray(a["gt"])[:, :3, 3]
    err_a = np.linalg.norm(va[:, :3, 3] - gt, axis=1)
    err_b = np.linalg.norm(vb[:, :3, 3] - gt, axis=1)

    def first(mask):
        idx = np.nonzero(mask)[0]
        return int(idx[0]) if len(idx) else None

    ka, kb = a["kf_frames"], b["kf_frames"]
    kf_diff = next((i for i, (x, y) in enumerate(zip(ka, kb)) if x != y),
                   None if len(ka) == len(kb) else min(len(ka), len(kb)))
    return {
        "first_frame_apart_1e-5": first((dt > 1e-5) | (dr > 1e-5)),
        "first_frame_apart_1mm": first(dt > 1e-3),
        "first_frame_apart_1cm": first(dt > 1e-2),
        "max_vo_apart_m": float(dt.max()),
        "vo_err_at_last_frame_m": [float(err_a[-1]), float(err_b[-1])],
        "vo_err_mean_m": [float(err_a.mean()), float(err_b.mean())],
        "first_keyframe_decision_apart": kf_diff,
        "keyframes": [len(ka), len(kb)],
        "lba_applied": [a["lba_applied"], b["lba_applied"]],
        "ate": [a["ate"], b["ate"]],
        "who": [a["package"], b["package"]],
    }


def _np_tree(tree):
    """A JAX pytree of NamedTuples as the same structure of numpy arrays."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_np_tree(x) for x in tree))
    return np.asarray(tree)


def _jax_keyframes(plucker: bool, n: int) -> list:
    """(pose, numpy features) of each keyframe the JAX mapper receives."""
    scene, _, frames = _frames(n, None)
    slam = _slam("jax", plucker, scene)
    kfs, m = [], slam.mapper
    init, add = m.initialize, m.add_keyframe

    def rec_init(pose, feats):
        kfs.append((np.array(pose), _np_tree(feats)))
        return init(pose, feats)

    def rec_add(pose, feats, **kw):
        kfs.append((np.array(pose), _np_tree(feats)))
        return add(pose, feats, **kw)

    m.initialize, m.add_keyframe = rec_init, rec_add
    for i, (il, ir) in enumerate(frames):
        slam.process(il, ir, timestamp=0.05 * i)
    slam.wait_until_idle()
    return scene, kfs


def mapper(mode: str, n: int) -> dict:
    import jax.numpy as jnp
    import torch

    from plslam_tpu.backend import ba as jba
    from plslam_tpu.backend import mapping as jmap
    from plslam_tpu.config import PLSLAMConfig as JCfg
    from plslam_tpu.core.camera import StereoCamera as JCam
    from plslam_tpu_torch import config as TC
    from plslam_tpu_torch.backend import ba as tba
    from plslam_tpu_torch.backend import mapping as tmap
    from plslam_tpu_torch.config import PLSLAMConfig as TCfg
    from plslam_tpu_torch.convert import ba_problem_from_numpy, stereo_features_from_numpy
    from plslam_tpu_torch.core.camera import StereoCamera as TCam

    torch.set_num_threads(1)
    plucker = mode == "plucker"
    scene, kfs = _jax_keyframes(plucker, n)
    kw = dict(use_lines=True, plucker_lines=plucker, local_ba_kf=16, ba_points=2048,
              ba_lines=256, ba_pobs=16384, ba_lobs=2048)
    cfg_kw = dict(use_line_plucker=plucker, use_loop_closure=False, multithread_slam=False)
    jc, tc = JCfg(**cfg_kw), TCfg(**cfg_kw)
    intr = (scene.fx, scene.fy, scene.cx, scene.cy, scene.b)
    size = dict(width=scene.width, height=scene.height)
    jcam = JCam.create(*intr, dtype=jnp.float32, **size)
    tcam = TCam.create(*intr, **size)

    def handlers():
        return (jmap.MapHandler(jcam, jmap.MapConfig(**kw), jc.ba(), tracker_cfg=jc.tracker()),
                tmap.MapHandler(tcam, tmap.MapConfig(**kw), TC.ba(tc),
                                tracker_cfg=TC.tracker(tc), device="cpu"))

    def feed(jm, tm, T, f, first=False, **akw):
        tf = stereo_features_from_numpy(f, "cpu")
        if first:
            jm.initialize(T, f)
            tm.initialize(T, tf)
        else:
            jm.add_keyframe(T, f, **akw)
            tm.add_keyframe(T, tf, **akw)

    jm, tm = handlers()
    apart = []
    for i, (T, f) in enumerate(kfs):
        feed(jm, tm, T, f, first=i == 0, defer_ba=True)
        if i == len(kfs) - 1:
            jm.flush_ba()
            tm.flush_ba()
        Ta = np.stack([k.T_w_k for k in jm.map.keyframes])
        Tb = np.stack([k.T_w_k for k in tm.map.keyframes])
        apart.append(float(np.abs(Ta - Tb).max()))

    # the first local BA's problem, one LM trip in each package and in f64
    jm, tm = handlers()
    for i, (T, f) in enumerate(kfs[:2]):
        feed(jm, tm, T, f, first=i == 0, run_ba=False)
    jp, jmeta = jm.build_local_ba()
    tp, _ = tm.build_local_ba()
    equal = all(a is None and b is None or np.array_equal(np.asarray(a), np.asarray(b))
                for a, b in zip(jp, tp))
    lam = jc.ba().lambda_init
    jprob = jba.BAProblem(*(None if x is None else jnp.asarray(x) for x in jp))
    a_j = jba.assemble(jprob, jcam, jc.ba(), jprob.p_valid, jprob.l_valid, True)
    d_j = jba.solve_schur(a_j, jprob, jc.ba(), jnp.float32(lam))
    steps = {}
    for name, dtype in (("port", torch.float32), ("f64", torch.float64)):
        tprob = ba_problem_from_numpy(tp, "cpu")
        tprob = tprob._replace(**{k: v.to(dtype) for k, v in tprob._asdict().items()
                                  if v is not None and v.is_floating_point()})
        a = tba.assemble(tprob, tcam, TC.ba(tc), tprob.p_valid, tprob.l_valid, True,
                         tba.assembly_plans(tprob))
        steps[name] = [x.double().numpy() for x in
                       tba.solve_schur(a, tprob, TC.ba(tc), torch.tensor(lam, dtype=dtype))[:2]]
    steps["jax"] = [np.asarray(x, np.float64) for x in d_j[:2]]
    valid = np.asarray(jp.point_valid)

    def err(x, y):
        return [float(np.abs(x[0] - y[0]).max()), float(np.abs(x[1] - y[1])[valid].max())]

    return {
        "mode": mode, "frames": n, "keyframes": len(kfs),
        "max_pose_apart_after_each_keyframe_m": apart,
        "first_lba": {
            "problems_equal": bool(equal), "lambda": lam,
            "largest_step": [float(np.abs(steps["f64"][0]).max()),
                             float(np.abs(steps["f64"][1])[valid].max())],
            "jax_vs_f64": err(steps["jax"], steps["f64"]),
            "port_vs_f64": err(steps["port"], steps["f64"]),
            "jax_vs_port": err(steps["jax"], steps["port"]),
        },
    }


def vo_step(mode: str, n: int) -> dict:
    import jax.numpy as jnp
    import torch

    from plslam_tpu import vo as jvo
    from plslam_tpu.config import PLSLAMConfig as JCfg
    from plslam_tpu.core.camera import StereoCamera as JCam
    from plslam_tpu_torch import config as TC
    from plslam_tpu_torch import convert, vo
    from plslam_tpu_torch.config import PLSLAMConfig as TCfg
    from plslam_tpu_torch.core.camera import StereoCamera as TCam
    from plslam_tpu_torch.ops import fast, lines

    torch.set_num_threads(1)
    scene, poses, frames = _frames(n, None)
    cfg_kw = dict(use_line_plucker=mode == "plucker", use_loop_closure=False,
                  multithread_slam=False)
    jc, tc = JCfg(**cfg_kw), TCfg(**cfg_kw)
    intr = (scene.fx, scene.fy, scene.cx, scene.cy, scene.b)
    size = dict(width=scene.width, height=scene.height)
    jv = jvo.VisualOdometry(JCam.create(*intr, dtype=jnp.float32, **size),
                            jc.frontend(scene.width), jc.tracker())
    tv = vo.VisualOdometry(TCam.create(*intr, **size), TC.frontend(tc, scene.width),
                           TC.tracker(tc), device="cpu")

    def t(a):
        a = np.asarray(a)
        return torch.from_numpy(np.array(a.view(np.int32) if a.dtype == np.uint32 else a))

    def state_np(x):
        x = _np_tree(x)
        return x._replace(features=type(x.features)(*(_np_tree(f) for f in x.features)))

    jv.initialize(*(jnp.asarray(x) for x in frames[0]))
    rows = []
    for i in range(1, n):
        st = jv.state
        imgs = jnp.asarray(np.stack(frames[i]))
        kp, pdesc = jv._det_pts(imgs, st.fast_th)
        seg, ldesc = jv._det_ls(imgs)
        want, jv.state = jvo._match_and_track((kp, pdesc), (seg, ldesc), st, jv.cam, jv.fcfg,
                                              jv.tcfg, jv.params)
        got, _ = vo.match_and_track(
            (fast.Keypoints(*(t(x) for x in kp)), t(pdesc)),
            (lines.Segments(*(t(x) for x in seg)), t(ldesc)),
            convert.vo_state_from_numpy(state_np(st), "cpu"), tv.cam, tv.fcfg, tv.tcfg,
            tv.params)
        rows.append({"frame": i, "inliers": [int(want.n_inliers), int(got.n_inliers)],
                     "max_T_apart": float(np.abs(np.asarray(want.T_f_w)
                                                 - got.T_f_w.numpy()).max()),
                     "t_err_m": float(np.linalg.norm(np.asarray(want.T_f_w)[:3, 3]
                                                     - poses[i][:3, 3]))})
    return {"mode": mode, "frames": rows}


def main(argv) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("package", choices=("jax", "torch"))
    r.add_argument("mode", choices=("plucker", "endpoint"))
    r.add_argument("n", nargs="?", type=int, default=48)
    r.add_argument("--out", default=None)
    r.add_argument("--noise-seed", type=int, default=None)
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    mp = sub.add_parser("mapper")
    mp.add_argument("mode", choices=("plucker", "endpoint"))
    mp.add_argument("n", nargs="?", type=int, default=48)
    vs = sub.add_parser("vo-step")
    vs.add_argument("mode", choices=("plucker", "endpoint"))
    vs.add_argument("n", nargs="?", type=int, default=4)
    args = ap.parse_args(argv)
    if args.cmd == "mapper":
        print(json.dumps(mapper(args.mode, args.n)), flush=True)
    elif args.cmd == "vo-step":
        print(json.dumps(vo_step(args.mode, args.n)), flush=True)
    elif args.cmd == "run":
        rec = run(args.package, args.mode, args.n, args.noise_seed)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(rec, f)
        print(json.dumps({k: rec[k] for k in ("package", "mode", "frames", "noise_seed",
                                              "kf_frames", "lba_applied", "ate")}),
              flush=True)
        print(json.dumps({"good_frames": sum(rec["good"])}), flush=True)
    else:
        with open(args.a) as f:
            a = json.load(f)
        with open(args.b) as f:
            b = json.load(f)
        print(json.dumps(compare(a, b)), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
