"""The harness finds every cell, configuration, mix and metric by name."""

from __future__ import annotations

import json
import os
import re

import pytest

from benchmark import harness

from conftest import REPO

SPEC = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_loads(cell):
    spec, w, config, mix = harness.load_cell(REPO, cell)
    assert config["entry"] in ("serve", "train")
    assert os.path.exists(os.path.join(REPO, config["reference"]))
    assert mix["kind"] == {"serve": "detect", "train": "train"}[
        config["entry"]]
    e2e = harness.cell_metrics(spec, cell, False)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    layers = harness.cell_metrics(spec, cell, True)
    assert layers, "every cell reports a per-layer metric"
    for m in layers:
        assert callable(harness.load_reader(m["name"]))


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file(conf):
    config = json.load(open(os.path.join(REPO, conf["file"])))
    assert conf["file"].startswith("benchmark/")
    assert config["source"] == conf["source"]
    assert config["reduced"] == conf["reduced"] == []
    assert set(config["limits"]) and all(
        v >= 0 for v in config["limits"].values())


def test_names_and_units():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in SPEC[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in SPEC["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]


def test_every_metric_file_is_listed():
    listed = {m["name"] for m in SPEC["per_layer"]}
    files = {f[:-3] for f in os.listdir(os.path.join(REPO, "benchmark",
                                                     "metrics"))
             if f.endswith(".py")}
    assert files == listed


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_lists_its_cells(metric):
    """Every per-layer metric names its cells, and each of them reports
    the end-to-end metric it moves."""
    cells = {w["name"] for w in SPEC["workloads"]}
    assert metric["workloads"] and set(metric["workloads"]) <= cells
    for cell in metric["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(SPEC, cell, False)}
        assert metric["moves"] in e2e
        assert metric in harness.cell_metrics(SPEC, cell, True)
