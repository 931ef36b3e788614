"""``BENCHMARK.json`` against the benchmark's files and the benchmark's
contract: every cell names an existing configuration, entry and metrics,
every name and unit is well formed, and each file is found by name."""

import json
import os
import re

import pytest

from bench_common import harness

BENCH = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
LINE = re.compile(r"[^\t\n]{1,200}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits the driver's 43200 s
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.fullmatch(cfg["name"]) and LINE.fullmatch(cfg["why"])
    assert LINE.fullmatch(cfg["source"]) and cfg["source"].startswith("https://")
    assert cfg["file"] == f"benchmark/configs/{cfg['name']}.json"
    data = harness.config(cfg["name"])
    assert data["name"] == cfg["name"] and data["reduced"] == cfg["reduced"]
    assert len(cfg["reduced"]) <= 16


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    for key in ("name", "config", "traffic"):
        assert NAME.fullmatch(cell[key]), key
    assert LINE.fullmatch(cell["why"]) and cell["chips"] == 1
    wl = harness.workload(cell["name"])
    assert wl["name"] == cell["name"] and wl["config"] == cell["config"]
    assert wl["chips"] == cell["chips"] and wl["why"] == cell["why"]
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}
    entry = harness.entry(wl["entry"])
    assert hasattr(entry, "Bench")
    e2e, layer = harness.cell_metrics(BENCH, cell["name"])
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer
    for m in layer:
        assert m["moves"] in names
        assert callable(harness.metric_reader(m["name"]).read)
    assert set(wl["check"]["limits"]) and all(v >= 0 for v in wl["check"]["limits"].values())


def test_names_and_units():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    assert len({w["name"] for w in BENCH["workloads"]}) == len(BENCH["workloads"])
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(BENCH["workloads"])
    for m in metrics:
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert (0.01 if m["name"] != "setup_s" else 0.0) <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert LINE.fullmatch(m["layer"])
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_metric_and_config_file_is_used():
    used = {m["name"] for m in BENCH["per_layer"]}
    files = {f[:-3] for f in os.listdir(os.path.join(harness.HERE, "metrics")) if f.endswith(".py")}
    assert files == used
    configs = {f[:-5] for f in os.listdir(os.path.join(harness.HERE, "configs"))}
    assert configs == {c["name"] for c in BENCH["configs"]} == \
        {w["config"] for w in BENCH["workloads"]}
