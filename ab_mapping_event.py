#!/usr/bin/env python3
"""Mapping-event wall time of the PyTorch port in two checkouts, run
alternately on one NVIDIA GPU.

    python3 ab_mapping_event.py --base DIR [--pairs 10] [--json PATH]

Compares the checkout that holds this script (the change) with the one at
DIR (the base, for example the parent commit unpacked by `git archive`).
Each run is a process of its own that imports
fisher_nerf_customized_tpu_torch from one checkout, builds that
checkout's kernels, and drives chip_smoke.py's slice with this checkout's
copy of it (`chip_smoke.run_slam`): 120 scripted steps of
GaussianSLAM.track_rgbd, 12 mapping events, each timed on the host clock
between synchronizes.  The pairs alternate which side runs first.  Prints
one line per run, then one JSON line: per side the runs' mean event times,
their median and quartiles, the map-build times, and the pairs in which
the change's mean was the lower.
"""
import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def one_run(root):
    """One slice run with the package of checkout `root`; prints a JSON
    line with its event times."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    import fisher_nerf_customized_tpu_torch as pkg
    from fisher_nerf_customized_tpu_torch.ops import cuda_build
    if os.path.dirname(os.path.dirname(os.path.abspath(pkg.__file__))) != root:
        raise RuntimeError(f"imported {pkg.__file__}, not from {root}")
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_build.build_all()
    dev = torch.device("cuda")
    events = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    smoke.run_slam(smoke.eccv_config(), dev, smoke.ACTIONS, events)
    torch.cuda.synchronize()
    map_s = time.perf_counter() - t0
    print(json.dumps(dict(event_ms=[e["ms"] for e in events], map_s=map_s,
                          n_active=events[-1]["n_active"])))


def quartiles(xs):
    q1, med, q3 = np.percentile(xs, [25, 50, 75])
    return dict(median=float(med), q1=float(q1), q3=float(q3))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--base", help="checkout to compare against")
    parser.add_argument("--pairs", type=int, default=10)
    parser.add_argument("--json", default=None,
                        help="also write every run's numbers to this file")
    parser.add_argument("--one", default=None, help=argparse.SUPPRESS)
    opts = parser.parse_args(argv)
    if opts.one:
        one_run(opts.one)
        return 0
    if not opts.base:
        parser.error("--base is required")
    roots = dict(base=os.path.abspath(opts.base), change=HERE)
    runs = dict(base=[], change=[])
    for i in range(opts.pairs):
        for side in (("base", "change") if i % 2 == 0 else
                     ("change", "base")):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one",
                 roots[side]], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"{side} run of pair {i} failed:\n"
                                   f"{proc.stdout[-4000:]}\n"
                                   f"{proc.stderr[-4000:]}")
            run = json.loads(proc.stdout.strip().splitlines()[-1])
            run["mean_ms"] = float(np.mean(run["event_ms"]))
            runs[side].append(run)
            print(f"pair {i} {side}: event mean {run['mean_ms']:.1f} ms, "
                  f"median {float(np.median(run['event_ms'])):.1f} ms, "
                  f"map build {run['map_s']:.2f} s, "
                  f"n_active {run['n_active']}", flush=True)
    means = {side: [r["mean_ms"] for r in rs] for side, rs in runs.items()}
    summary = dict(
        pairs=opts.pairs,
        change_lower=sum(c < b for b, c in zip(means["base"],
                                               means["change"])),
        **{side: dict(event_mean_ms=means[side], **quartiles(means[side]),
                      map_s=[r["map_s"] for r in runs[side]])
           for side in runs})
    if opts.json:
        os.makedirs(os.path.dirname(os.path.abspath(opts.json)),
                    exist_ok=True)
        with open(opts.json, "w") as f:
            json.dump(dict(summary, runs=runs), f, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
