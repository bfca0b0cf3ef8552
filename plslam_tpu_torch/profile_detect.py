"""Sub-stage times of the detection program on one GPU (the twin of
``scripts/profile_detect.py``).

    python -m plslam_tpu_torch.profile_detect [N] [--device cuda|cpu] [--scale S]

Each row is one ``graphs.Program`` over a static input buffer, replayed N
times (default 24) on the bench scene's frames (4 poses, cycled) between
two CUDA events, each replay after the copy of its input into the buffer
(``roofline.time_stage``); ms per call.  The rows, in the JAX script's
order: the dispatch floor (a trivial program, alone and as two chained
programs), the fused point+line detection, points alone, lines alone,
then the point sub-stages (pyramid build; FAST score + NMS over all
levels, by the port's kernel ``fast_score_nms_batch`` where the JAX script
times XLA's form; score + NMS + per-cell selection; ``detect_pyramid_batch``
to the top-k; ORB describe of both images' keypoints) and the line
sub-stages (``detect_segments``; LBD describe; the gradient front: blur,
Sobel and the edge NMS).  Each row's output on the first input is also
held bit for bit against the same function run without the graph.
``--device cpu`` times the plain kernels on the host clock; ``--scale``
scales the image and the feature widths (the CPU tests run 0.25).
"""

from __future__ import annotations

import argparse
import sys

import torch

from . import graphs
from .bench import card, resolve_device, scaled
from .frontend.frame import (FrontendConfig, _detect_describe_lines_batch,
                             _detect_describe_points_batch)
from .io.synthetic import SyntheticScene, circular_trajectory
from .ops import fast, lbd, lines, orb
from .ops.cuda_fast import fast_score_nms_batch
from .ops.image import blur, build_pyramid, sobel
from .roofline import N, Stage, bits_equal, seconds_per_call, time_stage

N_POSES = 4
FAST_TH = 20.0


def _chained(dev: torch.device, imgs_buf: torch.Tensor, frames: list, n: int) -> dict:
    """Two trivial programs per call, the second reading the first's output:
    whether two dispatches a frame pipeline or serialize."""
    first = graphs.Program(lambda: imgs_buf[0, 0, 0] + 1.0, dev)
    mid = first()
    second = graphs.Program(lambda: mid * 2.0, dev) if first.captured else None

    def call(i):
        imgs_buf.copy_(frames[i % len(frames)])
        a = first()
        return second() if second is not None else a * 2.0

    sec = seconds_per_call(call, n, dev)
    same = bits_equal(call(0), (frames[0][0, 0, 0] + 1.0) * 2.0)
    return {"stage": "dispatch floor x2 (two chained)", "ms": 1e3 * sec, "graphed":
            first.captured, "bits_equal": same}


def stages(dev: torch.device, n: int, scale: float = 1.0) -> list[Stage]:
    """Every row's program but the chained floor, in the JAX script's order."""
    scene_kw, widths = scaled(scale)
    cfg = FrontendConfig(**widths)
    scene = SyntheticScene(**scene_kw)
    frames = [torch.stack([torch.from_numpy(x).to(dev) for x in scene.render_stereo(T, noise=1.0)])
              for T in circular_trajectory(N_POSES, step_t=0.05)]
    imgs_list = [frames[i % len(frames)] for i in range(n)]
    th = torch.full((), cfg.fast_th, dtype=torch.float32, device=dev)
    per = cfg.n_points // cfg.n_levels + 1
    det_cfg = lines.LineDetectorConfig(max_out=cfg.n_lines, n_orient=cfg.line_orient_bins)

    def on_images(name, fn):
        buf = frames[0].clone()
        return Stage(name, lambda: fn(buf), buf, (), imgs_list)

    levels0 = build_pyramid(frames[0], cfg.n_levels, cfg.scale_factor)
    lv_list = [build_pyramid(f, cfg.n_levels, cfg.scale_factor) for f in imgs_list]

    def on_levels(name, fn):
        buf = [lv.clone() for lv in levels0]
        return Stage(name, lambda: fn(buf), buf, (), lv_list)

    thr = fast.threshold_vector(FAST_TH, frames[0].shape[0], dev)

    def score_all(lv):
        return [fast_score_nms_batch(x.contiguous(), thr) for x in lv]

    def sel_all(lv):
        return [fast.select_corners(*fast_score_nms_batch(x.contiguous(), thr), per, cfg.edge_th)
                for x in lv]

    def det_pyr(lv):
        return fast.detect_pyramid_batch(lv, FAST_TH, cfg.n_points, cfg.edge_th, cfg.scale_factor)

    kp = det_pyr(levels0)
    seg = lines.detect_segments(frames[0], det_cfg)

    def grad_front(im):
        gx, gy = sobel(blur(im, 1.0))
        mag = torch.sqrt(gx * gx + gy * gy)
        return lines._edge_nms(mag, gx, gy) & (mag > det_cfg.mag_th), mag

    return [
        on_images("dispatch floor (trivial program)", lambda im: im[0, 0, 0] + 1.0),
        on_images("FUSED point+line detection",
                  lambda im: (_detect_describe_points_batch(im, cfg, th),
                              _detect_describe_lines_batch(im, cfg))),
        on_images("point detect+describe (alone)",
                  lambda im: _detect_describe_points_batch(im, cfg, th)),
        on_images("line detect+LBD (alone)", lambda im: _detect_describe_lines_batch(im, cfg)),
        on_images("  pyramid build",
                  lambda im: build_pyramid(im, cfg.n_levels, cfg.scale_factor)),
        on_levels("  FAST score+NMS (all levels, kernel)", score_all),
        on_levels("  score+NMS+select (all levels)", sel_all),
        on_levels("  detect_pyramid_batch (score..topk)", det_pyr),
        on_images(f"  ORB describe ({cfg.n_points} kp x 2)",
                  lambda im: orb.describe_batch(im, kp.xy, kp.valid)),
        on_images("  line detect_segments", lambda im: lines.detect_segments(im, det_cfg)),
        on_images("  LBD describe", lambda im: lbd.describe_batch(im, seg.sp, seg.ep, seg.valid)),
        on_images("  line gradient front (blur+sobel+nms)", grad_front),
    ]


def run(device="cuda", n: int = N, scale: float = 1.0, say=None) -> dict:
    """Every row: {"card", "rows": [{"stage", "ms", "graphed", "bits_equal"}]}."""
    dev = torch.device(device)
    say = say or (lambda msg: None)
    rows = []
    for i, st in enumerate(stages(dev, n, scale)):
        st.load(0)
        rows.append(time_stage(st, dev, n, graphs.tree_clone(st.fn())))
        say(f"{rows[-1]['stage']:<42s} {rows[-1]['ms']:7.3f} ms")
        if i == 0:  # the chained floor follows the trivial program
            rows.append(_chained(dev, st.static, st.inputs, n))
            say(f"{rows[-1]['stage']:<42s} {rows[-1]['ms']:7.3f} ms")
    return {"card": card(dev), "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=N, help="calls timed per row")
    ap.add_argument("--device", default="cuda", help="cuda (default: card 0) or cpu")
    ap.add_argument("--scale", type=float, default=1.0, help="image and feature widths")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device={dev} card={card(dev)} N={args.n} patch gather and FAST: "
          f"{'CUDA kernels' if dev.type == 'cuda' else 'plain twins'}", flush=True)
    run(dev, args.n, args.scale, say=lambda msg: print(msg, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
