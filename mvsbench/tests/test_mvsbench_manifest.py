"""BENCHMARK.json and the files it names: the contract's shape, and that the
harness finds a cell, a configuration, a mode and a metric by name."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from mvsbench import harness

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "mvsbench"
DOC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [c["name"] for c in DOC["workloads"]]


def test_top_level_keys_and_limits():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert DOC["paths"] == ["mvsbench"]
    assert 1 <= DOC["run_seconds"] <= 51 and isinstance(DOC["run_seconds"], int)
    assert len(json.dumps(DOC)) < 64 * 1024
    for word in DOC["command"]:
        assert not word.startswith("/") and ".." not in word
    metrics = DOC["end_to_end"] + DOC["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [c["name"] for c in DOC["configs"]]
    assert len(set(m["name"] for m in metrics)) == len(metrics)
    for name in names:
        assert NAME.match(name), name
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for m in DOC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}, m
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25, m
    assert [m for m in DOC["end_to_end"] if m["name"] == "setup_s"][0]["bound"] <= 0.25
    for m in DOC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_configurations_are_files_under_paths_and_used():
    used = {c["config"] for c in DOC["workloads"]}
    files = set()
    for c in DOC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"mvsbench/configs/{c['name']}.json" and c["file"] not in files
        files.add(c["file"])
        body = json.loads((REPO / c["file"]).read_text())
        assert body["source"] == c["source"] and body["reduced"] == c["reduced"] == []
        assert c["name"] in used and 0 < len(c["why"]) <= 200 and 0 < len(c["source"]) <= 200


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_names_an_existing_configuration_and_mode(cell):
    entry = [c for c in DOC["workloads"] if c["name"] == cell][0]
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert 0 < len(entry["why"]) <= 200 and entry["chips"] in (1, 4)
    workload, config = harness.cell_files(cell)
    assert workload["config"] == entry["config"] and workload["chips"] == entry["chips"]
    assert (BENCH / "modes" / f"{workload['mode']}.py").is_file()
    assert config["precision"] == "float32"
    assert set(workload["limits"]) and all(v > 0 for v in workload["limits"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_every_metric_is_reported_with_what_it_moves(cell):
    e2e, layer = harness.cell_metrics(DOC, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer
    for m in layer:
        assert m["moves"] in names, (cell, m["name"])
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


def test_per_layer_metrics_list_their_cells():
    for m in DOC["per_layer"]:
        assert set(m["workloads"]) <= set(CELLS), m


def test_a_dropped_workload_file_is_found_without_code_changes(tiny_bench):
    root, bench = tiny_bench
    result = harness.run("tiny_dtu_eval", 7, 0.5, False, device="cpu", bench_dir=bench,
                         root=root, log=lambda *a, **k: None)
    assert result["correct"], result
    assert set(result["metrics"]) == {"maps_per_s", "dispatch_p90_ms", "setup_s"}
    assert list(result)[-1] == "checks"


def test_a_traced_run_reports_its_cells_span_metrics(tiny_bench):
    root, bench = tiny_bench
    result = harness.run("tiny_dtu_train", 7, 0.5, True, device="cpu", bench_dir=bench,
                         root=root, log=lambda *a, **k: None)
    assert result["correct"], result
    # on the CPU no peak is known and no device op is traced: the readers of
    # mfu and idle return nothing, the span's reader its number
    assert set(result["metrics"]) == {"backward_ms.train"}, result["metrics"]
    assert result["breakdown"]["idle_gaps"]
