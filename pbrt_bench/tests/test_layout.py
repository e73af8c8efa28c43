"""BENCHMARK.json, and every file of a cell, a configuration, a traffic mix,
a driver and a metric, found by name."""

from __future__ import annotations

import json
import re

import pytest

from pbrt_bench import harness, scenes

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["pbrt_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((harness.REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files(cell):
    w = next(x for x in BENCH["workloads"] if x["name"] == cell)
    spec = scenes.load_json("workloads", cell)
    assert (spec["config"], spec["traffic"]) == (w["config"], w["traffic"])
    traffic = scenes.load_json("traffic", spec["traffic"])
    harness.load_module("drivers", traffic["driver"]).Driver
    cfg = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert json.loads((harness.REPO / cfg["file"]).read_text())["name"] == cfg["name"]
    assert w["chips"] == 1
    reported = [m["name"] for m in harness.cell_metrics(BENCH, cell, "end_to_end")]
    assert "setup_s" in reported and len(reported) >= 2
    assert harness.cell_metrics(BENCH, cell, "per_layer")


@pytest.mark.parametrize("metric", METRICS)
def test_metric_reader_found(metric):
    assert callable(harness.load_module("metrics", metric).read)


def test_names_and_units():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names))
    for m in BENCH["per_layer"]:
        assert m["moves"] in [e["name"] for e in BENCH["end_to_end"]]
        assert all(c in CELLS for c in m["workloads"])


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
