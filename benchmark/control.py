#!/usr/bin/env python3
"""The readings that the limits of a cell are set from, on the card:

    python3 benchmark/control.py --workload eccv_episode \\
        --seeds 11,12,13 --seconds 10 --json out.json

runs the cell once a seed in this one process (set-up, a window of
--seconds, the check) and prints, for each seed, every compared number
of the program and of the control: the reference put in the program's
place one precision below the configuration's (bfloat16 renders and
gradients for float32, float32 distances for float64).  A limit lies
above the program's largest reading and below the control's smallest.
The benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import sys

import run as bench


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    rows = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        r, _m = bench.run_cell(args.workload, seed, args.seconds, False,
                               control=True)
        row = dict(seed=seed, program={n: v for n, v, _l in r.checks},
                   control=r.control_checks, limits={n: lim for n, _v, lim
                                                     in r.checks},
                   notes={k: v for k, v in r.notes.items()},
                   after=r.after_parts)
        rows.append(row)
        print(json.dumps(row, default=str), flush=True)
    names = rows[0]["program"]
    summary = {n: dict(program_max=max(x["program"][n] for x in rows),
                       control_min=min(x["control"].get(n, float("nan"))
                                       for x in rows),
                       limit=rows[0]["limits"][n]) for n in names}
    print(json.dumps(dict(workload=args.workload, summary=summary)))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(rows=rows, summary=summary), f, indent=1,
                      default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
