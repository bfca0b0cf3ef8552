#!/usr/bin/env python3
"""The JAX package's values that chip_smoke.py's phase 13 holds the
benchmark twins (``plslam_tpu_torch.bench*``) to, where the JAX benchmark
programs do not print them.

    PYTHONPATH=. JAX_PLATFORMS=cpu python scripts/jax_bench_reference.py [N_KF]

scripts/bench_dist_gba.py's ring map (seed 7, N_KF keyframes, default
128): its median point error before the GBA, unrounded (the script prints
it to 1e-5 m), and the chunk count of ``dist_gba.partition_map`` at 1, 2,
4 and 8 blocks, the kf-block GBA's chunks on a mesh of that many devices
(the script prints the count at 8 only).  The other values come from the
programs' own output on the CPU: bench.py's ``good_frames`` (standard
error) and bench_slam.py's ``# keyframes mapped during bench``.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import __graft_entry__ as G
from plslam_tpu.parallel import dist_gba


def main(argv) -> None:
    n_kf = int(argv[0]) if argv else 128
    mapper, (_, pt_true) = G._build_ring_map(rng_seed=7, n_kf=n_kf, n_pts=n_kf * 128,
                                             n_ls=n_kf * 8, pose_noise=0.01, lm_noise=0.03)
    mp = mapper.map
    el = np.where(mp.pt_valid & (mp.pt_nobs >= 2))[0]
    pre = float(np.median(np.linalg.norm(mp.pt_w[el] - pt_true[el], axis=1)))
    chunks = {n: len(dist_gba.partition_map(mapper, n).metas) for n in (1, 2, 4, 8)}
    print(f"n_kf {n_kf}: pre_err {pre!r} m; chunks by blocks {chunks}")


if __name__ == "__main__":
    main(sys.argv[1:])
