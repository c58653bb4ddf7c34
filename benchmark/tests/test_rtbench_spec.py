"""BENCHMARK.json against the contract's shape, every file found by name,
the result line's keys, and what the harness may import."""

import ast
import json
import os
import re

import pytest

from rtbench import core

BENCH = core.BENCH
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return core.benchmark_json()


def test_top_level_keys_and_command(bench):
    assert set(bench) == TOP
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024


def test_names_units_and_keys(bench):
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [w["traffic"] for w in bench["workloads"]]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len({w["name"] for w in bench["workloads"]}) == len(bench["workloads"])
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(bench["workloads"]) // 4)


def test_every_cell_reports_what_it_must(bench):
    for w in bench["workloads"]:
        e2e = {m["name"] for m in core.cell_metrics(bench, w["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = core.cell_metrics(bench, w["name"], "per_layer")
        assert layer and all(m["moves"] in e2e for m in layer)


def test_every_file_loads_by_name(bench):
    for c in bench["configs"]:
        cfg = core.config(c["name"])
        assert cfg["name"] == c["name"] and c["file"] == f"benchmark/configs/{c['name']}.json"
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
        assert os.path.exists(os.path.join(BENCH, "scenes", cfg["scene"] + ".json"))
    for w in bench["workloads"]:
        mix = core.traffic(w["traffic"])
        entry = core.entry(mix["entry"])
        assert hasattr(entry, "Loop") and hasattr(entry, "check")
        mesh = core.config(w["config"]).get("mesh", {"dp": 1, "sp": 1})
        assert mesh["dp"] * mesh["sp"] == w["chips"]  # a rank a card
        assert core.limits(w["name"])
    for m in bench["per_layer"]:
        assert callable(core.metric_reader(m["name"]).read)


def test_result_line_keys(bench):
    from rtbench import result

    class Run:
        cell = {"name": "demo.progressive"}
        traffic = {"entry": "progressive"}

    rec = {"correct": True, "win": {"units": 10, "wall_s": 0.1}, "e2e": {"epoch_ms": 10.0},
           "setup_s": 9.0, "peak": 123, "trace": None, "run": Run,
           "checks": {"photon_bad_share": {"value": 0.0, "limit": 0.1}}}
    line = result.result_line(bench, rec, {"platform": "gpu", "kind": "x", "count": 1}, False)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(line["metrics"]) == {"setup_s", "epoch_ms"}
    assert line["device"]["memory_peak_bytes"] == 123


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def _sources(*parts):
    root = os.path.join(BENCH, *parts)
    for d, _, files in os.walk(root):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_jax_anywhere_in_the_benchmark():
    for path in _sources():
        for mod in _imports(path):
            assert mod.split(".")[0] not in core.FORBIDDEN, (path, mod)
            assert mod != "raytracer_tpu_torch.bench", (path, mod)


def test_reference_imports_nothing_of_the_port():
    for path in _sources("reference"):
        for mod in _imports(path):
            assert mod.split(".")[0] != "raytracer_tpu_torch", (path, mod)
