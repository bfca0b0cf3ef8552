"""Host ms per stage of ``MapHandler.add_keyframe`` per keyframe on one GPU
(the twin of ``scripts/profile_mapping.py``).

    python -m plslam_tpu_torch.profile_mapping [--device cuda|cpu] [--scale S]

The bench scene (752x480, 1200 points, 256 line slots) tracked by a
graphed ``VisualOdometry``; every one of 14 frames becomes a keyframe of a
graphed ``MapHandler`` at bench_slam.py's map caps, through the
production flow that ``add_keyframe`` runs without the refinement: the
fused association with the deferred local BA's flush in its one fetch,
the new landmarks, the local BA's assembly and dispatch (deferred), the
culling; then the final flush.  Each stage is a ``utils/profiling.timed``
block around its call, and the fetch inside the association is the
mapper's own ``mapper.fetch.wait``; a keyframe's time in each is the
difference of the thread's counters over it.  Prints per stage the mean, median
and max ms over the keyframes after the first 4, the total per keyframe
with its keyframes/s, and the map's size.  ``--device cpu`` runs the
plain kernels; ``--scale`` scales the image and the feature widths (the
CPU tests run 0.25).
"""

from __future__ import annotations

import argparse
import sys
import threading

import numpy as np
import torch

from . import config as C
from .backend.mapping import MapConfig, MapHandler
from .bench import camera, card, resolve_device, scaled
from .config import PLSLAMConfig
from .io.synthetic import SyntheticScene, circular_trajectory
from .utils.profiling import counters, per_call_ms, timed
from .vo import VisualOdometry

N_KF = 14
WARM = 4
MAP_CAPS = dict(local_ba_kf=8, ba_points=2048, ba_lines=256, ba_pobs=8192, ba_lobs=2048)
# (counter, the row it times), in add_keyframe's order
STEPS = (("profile_mapping.assoc", "assoc+flushBA (1 fetch)"),
         ("mapper.fetch.wait", "  of which: combined fetch"),
         ("profile_mapping.spawn", "spawn_landmarks(host)"),
         ("profile_mapping.lba", "ba_assemble+dispatch"),
         ("profile_mapping.cull", "cull(host)"),
         ("profile_mapping.flush", "final ba flush"))


def _seconds(before: dict, after: dict) -> dict:
    """Seconds this thread spent in each ``timed`` block between two
    ``counters()`` snapshots."""
    rows = per_call_ms(before, after).get(threading.current_thread().name, {})
    return {name: ms * n / 1e3 for name, (ms, n) in rows.items()}


def run(device="cuda", *, frames=None, scale: float = 1.0, n_kf: int = N_KF, warm: int = WARM,
        capture: bool = True) -> dict:
    """Map n_kf keyframes of ``frames`` (rendered from the bench scene when
    None; n_kf + 1 pairs along ``circular_trajectory``); returns {"stages":
    row -> per-keyframe seconds, "warm", "mapper", "trajectory": the
    keyframes' (n, 4, 4) poses}."""
    dev = torch.device(device)
    scene_kw, widths = scaled(scale)
    scene = SyntheticScene(**scene_kw)
    cam = camera(scene)
    cfg = PLSLAMConfig(orb_nfeatures=widths["n_points"], lsd_nfeatures=widths["n_lines"])
    vo = VisualOdometry(cam, C.frontend(cfg, scene.width), C.tracker(cfg), device=dev,
                        capture=capture)
    mapper = MapHandler(cam, MapConfig(**MAP_CAPS), C.ba(cfg), tracker_cfg=C.tracker(cfg),
                        device=dev, capture=capture)
    poses = circular_trajectory(n_kf + 1, step_t=0.05)
    if frames is None:
        frames = [[torch.from_numpy(x).to(dev) for x in scene.render_stereo(T, noise=1.0)]
                  for T in poses]
    mapper.initialize(np.eye(4), vo.initialize(*frames[0]))

    stages = {row: [] for _, row in STEPS}
    for i in range(1, n_kf + 1):
        vo.process(*frames[i])
        feats = vo.current_features
        vo.mark_keyframe()
        # the production (fused + deferred) flow: one combined fetch for
        # the pending BA of the previous keyframe, the association and
        # the packed keyframe features, then one deferred BA dispatch
        before = counters()
        with timed("profile_mapping.assoc"):
            kf = mapper._associate_and_insert(poses[i], feats)
        with timed("profile_mapping.spawn"):
            mapper._spawn_landmarks(kf)
        with timed("profile_mapping.lba"):
            mapper.local_bundle_adjustment(defer=True)
        with timed("profile_mapping.cull"):
            mapper.cull_landmarks()
        took = _seconds(before, counters())
        for name, row in STEPS[:-1]:
            stages[row].append(took.get(name, 0.0))
    before = counters()
    with timed("profile_mapping.flush"):
        mapper.flush_ba()
    name, row = STEPS[-1]
    stages[row].append(_seconds(before, counters()).get(name, 0.0))
    return {"stages": stages, "warm": warm, "mapper": mapper,
            "trajectory": np.stack(mapper.keyframe_trajectory())}


def report(out: dict) -> list[str]:
    """The JAX script's table: mean, median and max ms per stage after the
    warm-up keyframes, the total per keyframe and the map's size."""
    lines = [f"{'stage':28s} {'mean ms':>9s} {'p50 ms':>9s} {'max ms':>9s}"]
    tot = 0.0
    for name, ts in out["stages"].items():
        ts = np.asarray(ts[out["warm"]:] if len(ts) > out["warm"] else ts) * 1e3
        if not name.startswith("  "):
            tot += ts.mean()
        lines.append(f"{name:28s} {ts.mean():9.1f} {np.median(ts):9.1f} {ts.max():9.1f}")
    mp = out["mapper"].map
    lines.append(f"{'TOTAL per KF':28s} {tot:9.1f}  ->  {1e3 / tot:.1f} KF/s")
    lines.append(f"map: {mp.n_pt} pts, {mp.n_ls} lines, {len(mp.keyframes)} KFs")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default: card 0) or cpu")
    ap.add_argument("--scale", type=float, default=1.0, help="image and feature widths")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device={dev} card={card(dev)}", flush=True)
    for line in report(run(dev, scale=args.scale)):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
