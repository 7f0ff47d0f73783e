"""BENCHMARK.json against the benchmark's contract and its files."""
import json
import os
import re

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
MAN = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def _metrics():
    return MAN["end_to_end"] + MAN["per_layer"]


def test_top_level_keys_and_limits():
    assert set(MAN) == KEYS
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert MAN["paths"] == ["benchmark"]
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert 1 <= len(MAN["configs"]) <= 24 and 1 <= len(MAN["workloads"]) <= 24
    assert 1 <= len(MAN["end_to_end"]) <= 16
    assert 1 <= len(MAN["per_layer"]) <= 128
    assert len(json.dumps(MAN)) <= 64 * 1024


@pytest.mark.parametrize("m", _metrics(), ids=lambda m: m["name"])
def test_metric_names_and_units(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    allowed = {"name", "unit", "better", "source", "workloads"}
    if m in MAN["end_to_end"]:
        allowed |= {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        allowed |= {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    assert set(m) <= allowed


def test_names_unique():
    for group in (_metrics(), MAN["workloads"], MAN["configs"]):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_workload_resolves(w):
    """Its files, its configuration, a reader for each metric it reports,
    and setup_s, another end-to-end metric and a per-layer one."""
    import run
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    entry, work, conf = run.cell_spec(w["name"])
    assert os.path.exists(os.path.join(HERE, "entries",
                                       f"{work['entry']}.py"))
    assert set(work["limits"]) and all(v > 0 for v in work["limits"].values())
    e2e = run.cell_metrics(w["name"], False)
    per = run.cell_metrics(w["name"], True)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and per
    for m in e2e + per:
        assert callable(run.reader(m["name"]))
    for m in per:
        assert m["moves"] in names


@pytest.mark.parametrize("m", MAN["per_layer"], ids=lambda m: m["name"])
def test_per_layer_moves_reported(m):
    e2e = {x["name"]: x for x in MAN["end_to_end"]}
    cells = m.get("workloads", [w["name"] for w in MAN["workloads"]])
    for cell in cells:
        assert cell in e2e[m["moves"]].get("workloads", [cell])


@pytest.mark.parametrize("c", MAN["configs"], ids=lambda c: c["name"])
def test_configs(c):
    used = {w["config"] for w in MAN["workloads"]}
    assert c["name"] in used and NAME.match(c["name"])
    path = os.path.join(ROOT, c["file"])
    assert c["file"].startswith("benchmark/") and os.path.exists(path)
    data = json.load(open(path))
    assert data["reduced"] == c["reduced"] and data["source"] == c["source"]
    assert all(NAME.match(k) for k in c["reduced"])


def test_setup_bound_and_fit():
    """setup_s at 0.25, and a check of 24 cells at run_seconds (2 + 14
    runs a cell, each allowed run_seconds + 60 s, 180 s a cell to compile,
    1200 s spare) fits in 12 hours."""
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    n = 24
    runs = 2 + 14 * n
    assert runs * (MAN["run_seconds"] + 60) + n * 180 + 1200 <= 43200
