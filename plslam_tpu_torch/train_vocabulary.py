"""Train and save a small DBoW2-format vocabulary pair (the port of
``scripts/train_vocabulary.py``, which wrote the shipped
``configs/vocab_*_k10L3.yml.gz``).

Renders a set of synthetic scenes (376x240), runs the production
detectors (FAST + ORB pyramid and line + LBD; the FAST and patch-gather
kernels on the card) through ``VisualOdometry`` on each frame, trains the
hierarchical binary k-means vocabulary of each modality
(``backend/vocab.train_vocabulary``) and saves it in DBoW2's OpenCV-YAML
layout.  The output directory is required, so the shipped vocabularies
are replaced only when ``configs`` is named.

    python -m plslam_tpu_torch.train_vocabulary OUT_DIR [--scenes 6]
        [--frames 8] [--device cuda|cpu]

Writes ``OUT_DIR/vocab_orb_k10L3.yml.gz`` and ``vocab_lbd_k10L3.yml.gz``.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .backend import vocab as V
from .core.camera import StereoCamera
from .frontend.frame import FrontendConfig
from .io.synthetic import SyntheticScene, circular_trajectory
from .vo import VisualOdometry

N_SCENES = 6
N_FRAMES = 8
K, DEPTH = 10, 3
NAMES = ("vocab_orb_k10L3.yml.gz", "vocab_lbd_k10L3.yml.gz")


def collect_descriptors(n_scenes=N_SCENES, n_frames=N_FRAMES, device="cuda"):
    """(ORB, LBD) descriptors of every valid stereo feature, uint32 words."""
    dev = torch.device(device)
    pdesc, ldesc = [], []
    for seed in range(n_scenes):
        scene = SyntheticScene(n_points=400, n_lines=48, seed=seed, width=376, height=240,
                               fx=217.6, fy=217.6, cx=183.7, cy=126.1)
        cam = StereoCamera.create(scene.fx, scene.fy, scene.cx, scene.cy, scene.b,
                                  width=scene.width, height=scene.height)
        vo = VisualOdometry(cam, FrontendConfig(n_points=600, n_lines=96), device=dev)
        for T in circular_trajectory(n_frames, step_t=0.12):
            il, ir = (torch.from_numpy(x).to(dev) for x in scene.render_stereo(T, noise=1.5))
            feats = vo.initialize(il, ir)
            p, l = feats.points, feats.lines
            pdesc.append(p.desc[p.valid].cpu().numpy().view(np.uint32))
            ldesc.append(l.desc[l.valid].cpu().numpy().view(np.uint32))
        print(f"scene {seed}: {sum(len(d) for d in pdesc)} point / "
              f"{sum(len(d) for d in ldesc)} line descriptors so far", flush=True)
    return np.concatenate(pdesc), np.concatenate(ldesc)


def train_and_save(pdesc: np.ndarray, ldesc: np.ndarray, out: str) -> list[str]:
    """Train each modality's vocabulary, save it under ``out`` and load it
    back (the round trip must keep the word count)."""
    os.makedirs(out, exist_ok=True)
    paths = []
    for name, desc in zip(NAMES, (pdesc, ldesc)):
        voc = V.train_vocabulary(desc, k=K, depth=DEPTH)
        path = os.path.join(out, name)
        V.save_dbow2_vocabulary(path, voc)
        back = V.load_dbow2_vocabulary(path)
        assert back.num_words == voc.num_words
        print(f"{path}: {voc.num_words} words, "
              f"{os.path.getsize(path) / 1024:.0f} KiB", flush=True)
        paths.append(path)
    return paths


def main(argv=None) -> list[str]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("--scenes", type=int, default=N_SCENES)
    ap.add_argument("--frames", type=int, default=N_FRAMES)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    t0 = time.time()
    pdesc, ldesc = collect_descriptors(args.scenes, args.frames, args.device)
    print(f"collected {len(pdesc)} ORB + {len(ldesc)} LBD descriptors "
          f"({time.time() - t0:.0f}s)", flush=True)
    return train_and_save(pdesc, ldesc, args.out_dir)


if __name__ == "__main__":
    main()
