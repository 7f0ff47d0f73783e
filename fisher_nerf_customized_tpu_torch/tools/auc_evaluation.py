"""AUC over runs: the completeness curves of every recon_metrics.yaml
that a glob pattern matches, padded to --max_steps (each step holds the
last recorded value), per policy the final completeness' mean and std
and the mean trapezoid AUC; the per-step mean and std to a CSV (the JAX
package's scripts/auc_evaluation.py, the same JSON and CSV).

    python -m fisher_nerf_customized_tpu_torch.tools.auc_evaluation \\
        'experiments/**/recon_metrics.yaml' [--max_steps 1000] \\
        [--csv_out auc_merged.csv]
"""
from __future__ import annotations

import argparse
import csv
import glob
import json
from collections import defaultdict

import numpy as np
import yaml

from ..engine.eval import trapezoid_auc


def load_runs(paths):
    runs = []
    for path in paths:
        with open(path) as f:
            data = yaml.safe_load(f)
        steps = data.get("steps", [])
        curve = [(s["step"], s.get("completeness_ratio", 0.0)) for s in steps]
        runs.append(dict(policy=data.get("policy", "unknown"),
                         scene=data.get("scene", "unknown"),
                         curve=curve, path=path))
    return runs


def pad_curve(curve, max_steps):
    """The curve at every step below max_steps, 0 before its first
    point, each later step the last recorded value."""
    out = np.zeros(max_steps)
    vals = dict(curve)
    last = 0.0
    for t in range(max_steps):
        if t in vals:
            last = vals[t]
        out[t] = last
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("glob_pattern",
                   help="e.g. 'experiments/**/recon_metrics.yaml'")
    p.add_argument("--max_steps", type=int, default=1000)
    p.add_argument("--csv_out", default="auc_merged.csv")
    args = p.parse_args(argv)

    paths = sorted(glob.glob(args.glob_pattern, recursive=True))
    if not paths:
        raise SystemExit(f"no files match {args.glob_pattern}")
    by_policy = defaultdict(list)
    for r in load_runs(paths):
        by_policy[r["policy"]].append(pad_curve(r["curve"], args.max_steps))

    summary = {}
    for policy, curves in by_policy.items():
        arr = np.stack(curves)
        summary[policy] = dict(
            n_runs=len(curves),
            final_mean=float(arr[:, -1].mean()),
            final_std=float(arr[:, -1].std()),
            auc_mean=float(np.mean([trapezoid_auc(c) for c in arr])))
    print(json.dumps(summary, indent=2))

    with open(args.csv_out, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["policy", "step", "mean", "std"])
        for policy, curves in by_policy.items():
            arr = np.stack(curves)
            for t in range(args.max_steps):
                w.writerow([policy, t, float(arr[:, t].mean()),
                            float(arr[:, t].std())])
    print(f"wrote {args.csv_out}")
    return summary


if __name__ == "__main__":
    main()
