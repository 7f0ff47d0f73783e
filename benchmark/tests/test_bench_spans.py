"""The per-layer metrics that read the port's own spans and counters
(harness/spans.py, utils/logging_utils.py's STORE), in traced runs on the
CPU at the small sizes of test_bench_run.py: each store-reading metric of
eccv_episode and eccv_eval comes out finite and positive,
launches_per_adam_step.map is left out (no CUDA kernel on the CPU), and
the traced stretch's host time is named by the program's spans rather
than by the harness's marks around each event or chunk."""
import math

import pytest
import torch

from test_bench_run import SMALL

STORE_METRICS = {
    "eccv_episode": ("map_event_span_ms", "adam_step_ms.map",
                     "live_slot_pct.map", "recon_surface_ms"),
    "eccv_eval": ("render_pose_ms.eval",),
}
# long enough for mapping events and a recon update after the traced one
SECONDS = {"eccv_episode": 12.0, "eccv_eval": 8.0}
PARAMS = {"eccv_episode": dict(trace_events=1),
          "eccv_eval": dict(map_steps=20, trace_chunks=2)}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _innermost_shares(summary, n=400):
    """The share of n evenly spaced instants of the traced stretch that
    each innermost host range (or `untracked`) holds."""
    from harness.trace import _innermost
    ranges = sorted(summary["phases"] + [m for m in summary["marks"]
                                         if m[2] != "traced"])
    starts = [r[0] for r in ranges]
    lo, hi = summary["lo"], summary["hi"]
    shares: dict[str, float] = {}
    for i in range(n):
        name = _innermost(ranges, starts, lo + (i + 0.5) * (hi - lo) / n)
        shares[name] = shares.get(name, 0.0) + 1.0 / n
    return shares


@pytest.mark.parametrize("cell", ["eccv_episode", "eccv_eval"])
def test_traced_run_reads_the_program_spans(cell):
    import run
    from harness.trace import breakdown
    r, metrics = run.run_cell(cell, 2718281828459, SECONDS[cell], True,
                              device="cpu", config_patch=SMALL,
                              params_patch=PARAMS[cell])
    assert r.correct, r.checks
    for name in STORE_METRICS[cell]:
        value = metrics[name]["value"]
        assert math.isfinite(value) and value > 0, (name, value)
    assert "launches_per_adam_step.map" not in metrics
    if cell == "eccv_episode":
        assert metrics["live_slot_pct.map"]["value"] <= 100.0
    names = {n for n, _s in breakdown(r.trace_summary, top=1000)
             ["idle_gaps"]}
    assert names and not any(n.startswith(("map:", "eval:"))
                             for n in names), names
    shares = _innermost_shares(r.trace_summary)
    program = sum(v for k, v in shares.items()
                  if k.startswith(("map.step.", "render.")))
    harness = sum(v for k, v in shares.items()
                  if k == "untracked" or k.startswith(("map:", "eval:")))
    assert program > 0.5 and harness < 0.1, shares
