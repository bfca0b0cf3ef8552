"""The BASELINE ATE suite through the port's CLI (counterpart of
``scripts/run_baseline_suite.py``): the four BASELINE.md evaluation
configurations over EuRoC sequences, one ``python -m
plslam_tpu_torch.run_euroc`` run each, and the ATE table.

    python -m plslam_tpu_torch.run_baseline_suite --data /data/euroc \\
        [--params configs/euroc_params.yaml] [--gt-root /data/euroc_gt] \\
        [--device cuda|cpu] [--configs 1-points-only,2-pl-plucker]
    python -m plslam_tpu_torch.run_baseline_suite --mini --device cpu

Sequence -> config map (BASELINE.md "Operational baseline"):
  1. MH_01  stereo points-only odometry, LC off
  2. MH_01  points+lines, Pluecker/orthonormal, local BA, LC off
  3. V1_02 + V2_03  endpoint lines + DBoW2-style loop closure + PGO
  4. the full 11-sequence sweep with the default (Pluecker) config

Ground truth: per sequence, the first existing of
  <gt-root or data>/<seq>/groundtruth.txt   (reference gt-ass 3x4 form)
  <seq dir>/mav0/state_groundtruth_estimate0/data.csv  (EuRoC csv)
  <seq dir>/groundtruth.csv

``--mini`` writes the miniature on-disk fixture (``io/mini_euroc``) and
runs each configuration once against it: the same path end to end without
real data.  ``--configs`` runs a subset of the configurations.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SEQS_ALL = ["MH_01", "MH_02", "MH_03", "MH_04", "MH_05",
            "V1_01", "V1_02", "V1_03", "V2_01", "V2_02", "V2_03"]

CONFIGS = {
    "1-points-only": dict(has_lines=False, use_loop_closure=False, use_line_plucker=True),
    "2-pl-plucker": dict(has_lines=True, use_loop_closure=False, use_line_plucker=True),
    "3-endpoint-lc": dict(has_lines=True, use_loop_closure=True, use_line_plucker=False),
    "4-default": dict(),
}
CONFIG_SEQS = {
    "1-points-only": ["MH_01"],
    "2-pl-plucker": ["MH_01"],
    "3-endpoint-lc": ["V1_02", "V2_03"],
    "4-default": SEQS_ALL,
}


def find_seq_dir(root: str, seq: str) -> str | None:
    for cand in (seq, f"{seq}_easy", f"{seq}_medium", f"{seq}_difficult",
                 seq.lower(), seq.replace("_", "")):
        p = os.path.join(root, cand)
        if os.path.isdir(p):
            return p
    return None


def find_gt(seq_dir: str, gt_root: str | None, seq: str) -> str | None:
    cands = []
    if gt_root:
        cands += [os.path.join(gt_root, seq.lower(), "groundtruth.txt"),
                  os.path.join(gt_root, seq, "groundtruth.txt")]
    cands += [os.path.join(seq_dir, "mav0", "state_groundtruth_estimate0", "data.csv"),
              os.path.join(seq_dir, "groundtruth.csv"),
              os.path.join(seq_dir, "groundtruth.txt")]
    for c in cands:
        if os.path.exists(c):
            return c
    return None


def write_overlay(base_yaml: str, overrides: dict, path: str) -> str:
    """The run config ``base_yaml`` with ``overrides`` applied, as YAML."""
    with open(base_yaml) as f:
        data = yaml.safe_load(f.read().replace("\t", " ")) or {}
    data.update(overrides)
    with open(path, "w") as f:
        yaml.safe_dump(data, f)
    return path


def run_one(seq_dir, params, config_yaml, gt, out, nmax=0, device="cuda"):
    """One CLI run in a subprocess; its JSON tail, or {"error": ...}."""
    cmd = [sys.executable, "-m", "plslam_tpu_torch.run_euroc", seq_dir, "--params", params,
           "--config", config_yaml, "--out", out, "--native-loader", "--device", device]
    if nmax:
        cmd += ["-n", str(nmax)]
    if gt:
        cmd += ["--gt", gt]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    r = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=36000)
    if r.returncode != 0:
        return {"error": r.stderr.strip().splitlines()[-1] if r.stderr.strip()
                else f"rc={r.returncode}"}
    tail = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    return json.loads(tail[-1]) if tail else {"error": "no ATE line"}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", help="root of EuRoC sequence directories")
    ap.add_argument("--params", default=os.path.join(REPO, "configs", "euroc_params.yaml"))
    ap.add_argument("--gt-root", default=None,
                    help="gt-ass style root (reference config/asl/gt-ass)")
    ap.add_argument("--config", default=os.path.join(REPO, "configs", "config_euroc.yaml"))
    ap.add_argument("--mini", action="store_true",
                    help="smoke-run on the generated miniature fixture")
    ap.add_argument("-n", "--nmax", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device of each run")
    ap.add_argument("--configs", default=",".join(CONFIGS),
                    help="comma-separated configurations to run")
    args = ap.parse_args(argv)
    names = [c for c in args.configs.split(",") if c]
    unknown = sorted(set(names) - set(CONFIGS))
    if unknown:
        ap.error(f"unknown configurations {unknown}; choose from {list(CONFIGS)}")

    with tempfile.TemporaryDirectory(prefix="baseline_suite_") as tmp:
        if args.mini:
            from .io import mini_euroc

            info = mini_euroc.make(os.path.join(tmp, "mini"), frames=8)
            seq_dirs = {s: info["dir"] for ss in CONFIG_SEQS.values() for s in ss}
            gts = {s: info["gt_csv"] for s in seq_dirs}
            params = info["params"]
            config_seqs = {k: v[:1] for k, v in CONFIG_SEQS.items()}
        else:
            if not args.data:
                ap.error("--data is required (or use --mini)")
            params = args.params
            config_seqs = CONFIG_SEQS
            seq_dirs, gts = {}, {}
            for s in SEQS_ALL:
                d = find_seq_dir(args.data, s)
                if d:
                    seq_dirs[s] = d
                    gts[s] = find_gt(d, args.gt_root, s)

        rows = []
        for cname in names:
            cfg_yaml = write_overlay(args.config, CONFIGS[cname],
                                     os.path.join(tmp, f"{cname}.yaml"))
            for seq in config_seqs[cname]:
                if seq not in seq_dirs:
                    rows.append((cname, seq, "— (sequence not mounted)"))
                    continue
                res = run_one(seq_dirs[seq], params, cfg_yaml, gts.get(seq),
                              os.path.join(tmp, f"{cname}_{seq}.txt"), nmax=args.nmax,
                              device=args.device)
                cell = (f"{res['ate_rmse_m']:.4f} m ({res['n_keyframes']} KF)"
                        if "ate_rmse_m" in res else f"ERR {res.get('error')}")
                rows.append((cname, seq, cell))
                print(f"# {cname} {seq}: {cell}", flush=True)

    print("\n| config | sequence | ATE RMSE |")
    print("|---|---|---|")
    for c, s, cell in rows:
        print(f"| {c} | {s} | {cell} |")
    return rows


if __name__ == "__main__":
    main()
