#!/usr/bin/env python3
"""One run of one benchmark cell of the PyTorch port on an NVIDIA GPU.

    python3 benchmark/run.py --workload eccv_episode --seed 7 \\
        --seconds 30 --trace 0

run from the root of a checkout.  The cell's configuration, traffic
parameters, entry and limits come from BENCHMARK.json and the files it
names (benchmark/workloads/<cell>.json, benchmark/configs/<config>.json);
its metrics are read by benchmark/metrics/<metric>.py, found by name.
With --trace 0 the last line of standard output is the cell's end-to-end
metrics, with --trace 1 its per-layer metrics; each number of the
correctness check is printed beside its limit as the last lines of
standard error.  No card, or fewer than the cell asks for: exit 2, no
result.  JAX or the JAX package in the process after the window: exit 3.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse       # noqa: E402
import importlib      # noqa: E402
import importlib.util  # noqa: E402
import os             # noqa: E402
import shutil         # noqa: E402
import sys            # noqa: E402
import tempfile       # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for path in (HERE, ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)

from harness import core        # noqa: E402


def _cache_env():
    """Build and kernel caches at fixed paths inside the checkout; no
    library the port uses may load JAX."""
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def cell_spec(cell: str) -> tuple[dict, dict, dict]:
    """(manifest entry, workload file, configuration file) of a cell.  A
    workload file that BENCHMARK.json does not list yet (a cell kept for a
    later PR) runs on one chip."""
    man = core.manifest()
    work = core.load_json(os.path.join(HERE, "workloads", f"{cell}.json"))
    entry = {w["name"]: w for w in man["workloads"]}.get(cell) or dict(
        name=cell, config=work["config"], traffic=work["traffic"], chips=1)
    if work["config"] != entry["config"] or \
            work["traffic"] != entry["traffic"]:
        raise ValueError(f"{cell}: workload file and BENCHMARK.json differ")
    conf = core.load_json(os.path.join(HERE, "configs",
                                       f"{entry['config']}.json"))
    return entry, work, conf


def cell_metrics(cell: str, trace: bool) -> list[dict]:
    """The metrics a cell reports: its end-to-end metrics, or with a trace
    its per-layer metrics (those that list it, or without a list those
    whose end-to-end metric it reports)."""
    man = core.manifest()
    e2e = [m for m in man["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names
                             else [])]


def reader(name: str):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", config_patch: dict | None = None,
             control: bool = False, params_patch: dict | None = None):
    """Set-up, window and check of one cell; returns (run, metrics).
    config_patch / params_patch replace keys of the configuration and of
    the traffic parameters (the tests' small sizes on the CPU)."""
    _cache_env()
    entry, work, conf = cell_spec(cell)
    if config_patch:
        conf = dict(conf, **config_patch)
    if params_patch:
        work = dict(work, params=dict(work["params"], **params_patch))
    import torch  # noqa: F401
    import fisher_nerf_customized_tpu_torch  # noqa: F401
    r = core.Run(cell, seed, seconds, trace, device, work, conf, T_PROCESS,
                 control=control)
    r.setup_parts["import"] = time.perf_counter() - T_PROCESS
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    tmp = tempfile.mkdtemp(prefix="bench_run_")
    try:
        r.workdir = tmp
        importlib.import_module(f"entries.{work['entry']}").run(r)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    metrics = {}
    for m in cell_metrics(cell, trace):
        value = reader(m["name"])(r)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return r, metrics


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    entry, _work, _conf = cell_spec(args.workload)
    import torch
    chips = int(entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    r, metrics = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace))
    bad = core.forbidden_modules()
    if bad:
        print(f"run.py: the process holds {', '.join(bad)}", file=sys.stderr)
        return 3
    device = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                  count=chips, memory_peak_bytes=int(r.memory_peak_bytes))
    breakdown = None
    if args.trace:
        from harness.trace import breakdown as trace_breakdown
        s = r.trace_summary
        device.update(busy_s=s["busy_s"], window_s=s["window_s"])
        breakdown = trace_breakdown(s)
    print(f"setup parts (s): {r.setup_parts}", file=sys.stderr)
    print(f"after the window (s): {r.after_parts}", file=sys.stderr)
    print(f"notes: {r.notes}", file=sys.stderr)
    for name, value, limit in r.checks:
        print(f"compared {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(core.result_line(r, metrics, device, breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
