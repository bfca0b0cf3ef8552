"""Host-side map-maintenance scaling of the port's ``SlamMap``: per-keyframe
wall time of its mutation paths (observation insertion with the
covisibility bookkeeping, pruning, merges, keyframe drop) over a
1000-keyframe synthetic run (the twin of ``scripts/profile_map_host.py``).

    python -m plslam_tpu_torch.profile_map_host [N_KF]

It is host numpy, so it runs the same whatever the device.  The same
seeded sequence as the JAX script: 240 observations reach the map per
keyframe, 35% of them new points, the rest re-observations of recent
landmarks; every 5th keyframe prunes 120 observation rows, every 25th
merges 20 landmark pairs, every 100th drops a random keyframe's
observations.  Prints the per-keyframe medians of the first, middle and
last thirds and the last-over-first growth ratio (FLAT below 3).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from .backend.mapping import MapConfig, SlamMap

N_KF = 1000
OBS_PER_KF = 240      # ~reference feature budget reaching the map per KF
NEW_FRAC = 0.35
PRUNE_EVERY, PRUNE_N = 5, 120
MERGE_EVERY, MERGE_N = 25, 20
DROP_EVERY = 100


class _KF:  # covis sizing only needs the keyframes' count
    active = True


def run(n_kf: int = N_KF) -> tuple[SlamMap, np.ndarray]:
    """(the map after n_kf keyframes, each keyframe's seconds)."""
    rng = np.random.default_rng(0)
    mp = SlamMap(MapConfig())
    per_kf = []
    for k in range(n_kf):
        t0 = time.perf_counter()
        mp.keyframes.append(_KF())
        mp.expand_graphs()
        n_new = int(OBS_PER_KF * NEW_FRAC) if k else OBS_PER_KF
        Pw = rng.uniform(-5, 5, (n_new, 3))
        # descriptor words are int32 in the port's tables
        desc = rng.integers(0, 2 ** 32, (n_new, 8), dtype=np.uint32).view(np.int32)
        mp.new_points(Pw, desc, k, np.arange(n_new))
        if k:
            # re-observe recent landmarks (covis increments against every
            # prior observer: the hot path)
            lo = max(0, mp.n_pt - 12 * OBS_PER_KF)
            cand = np.arange(lo, mp.n_pt - n_new)
            old = rng.choice(cand, OBS_PER_KF - n_new, replace=False)
            old = old[mp.pt_valid[old]]
            mp.add_point_obs(old, k, np.arange(n_new, n_new + len(old)))
        if k % PRUNE_EVERY == 0 and k:
            tb = mp.pobs
            live = np.where(tb.valid[: tb.n])[0]
            mp.remove_point_obs_rows(rng.choice(live, min(PRUNE_N, len(live)), replace=False))
        if k % MERGE_EVERY == 0 and k:
            live = np.where(mp.pt_valid)[0]
            pairs = rng.choice(live, (MERGE_N, 2), replace=False)
            for keep, kill in pairs:
                if mp.pt_valid[keep] and mp.pt_valid[kill] and keep != kill:
                    mp.merge_point_landmarks(int(keep), int(kill))
        if k % DROP_EVERY == 0 and k:
            mp.drop_keyframe_obs(int(rng.integers(0, k)))
        per_kf.append(time.perf_counter() - t0)
    return mp, np.asarray(per_kf)


def summary(per_kf: np.ndarray) -> dict:
    """Per-keyframe median ms of the thirds (the first keyframe left out)
    and the last-over-first growth ratio."""
    per_kf = per_kf[1:]
    third = len(per_kf) // 3
    med = [float(np.median(per_kf[i * third: (i + 1) * third]) * 1e3) for i in range(3)]
    return {"median_ms": med, "growth_ratio": med[2] / max(med[0], 1e-9)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_kf", nargs="?", type=int, default=N_KF)
    args = ap.parse_args(argv)
    mp, per_kf = run(args.n_kf)
    s = summary(per_kf)
    med, ratio = s["median_ms"], s["growth_ratio"]
    print(f"KFs={args.n_kf} landmarks={int(mp.pt_valid.sum())} obs_rows={mp.pobs.n}")
    print(f"per-KF host ms (median): first_third={med[0]:.2f} mid={med[1]:.2f} "
          f"last_third={med[2]:.2f} growth_ratio={ratio:.2f}")
    print("FLAT" if ratio < 3.0 else "GROWING", "— map host time per KF")
    return 0


if __name__ == "__main__":
    sys.exit(main())
