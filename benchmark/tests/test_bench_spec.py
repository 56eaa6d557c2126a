"""BENCHMARK.json keeps to the benchmark's contract, and a cell, a mix or a
metric is found by name, so a later one is added as files alone."""
import json
import re
import shutil

import pytest

from benchmark import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def bench():
    return json.loads((spec.ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_keeps_to_the_contract():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51
    assert all(w.startswith("benchmark/") or not w.endswith(".py")
               for w in b["command"])
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"]: w for w in b["workloads"]}
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert (spec.ROOT / c["file"]).exists()
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1
        assert len(w["why"]) <= 200 and NAME.match(w["name"])
        assert (spec.HERE / "mixes" / f"{w['traffic']}.json").exists()
        assert set(spec.load_cell(w["name"]).limits) == {
            "sse_excess", "worst_block", "missing"}
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= set(cells)
        spec.reader(m["name"])                  # has a reader
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for cell in cells:                  # setup_s, another e2e, a per-layer
        c = spec.load_cell(cell)
        names = {m["name"] for m in c.end_to_end}
        assert "setup_s" in names and len(names) >= 2 and c.per_layer
    assert len(json.dumps(b)) < 64 * 1024


def test_a_new_mix_and_metric_are_found_by_name(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / spec.HERE.name,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    d = tmp_path / spec.HERE.name
    mix = json.loads((d / "mixes" / "serve_opaque.json").read_text())
    mix["rate_per_s"] = 50.0
    (d / "mixes" / "serve_small.json").write_text(json.dumps(mix))
    (d / "limits" / "bc7enc16_default.serve_small.json").write_text(
        json.dumps({"sse_excess": 0.1, "worst_block": 1.0, "missing": 0}))
    (d / "metrics" / "p50_ms.py").write_text(
        "def read(run):\n    return 42.0\n")
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "bc7enc16_default.serve_small",
                           "config": "bc7enc16_default",
                           "traffic": "serve_small", "chips": 1, "why": "x"})
    b["end_to_end"].append({"name": "p50_ms.serve", "unit": "ms",
                            "better": "lower", "bound": 0.1,
                            "source": "host_clock",
                            "workloads": ["bc7enc16_default.serve_small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = spec.load_cell("bc7enc16_default.serve_small", tmp_path)
    assert cell.mix["rate_per_s"] == 50.0
    assert cell.limits == {"sse_excess": 0.1, "worst_block": 1.0,
                           "missing": 0}
    assert "p50_ms.serve" in {m["name"] for m in cell.end_to_end}
    assert spec.reader("p50_ms.serve", tmp_path).read(None) == 42.0
    with pytest.raises(KeyError):
        spec.load_cell("bc7enc16_default.nothing", tmp_path)
