"""The harness finds every cell's configuration, mix, metrics and
reference by name, and BENCHMARK.json keeps the shape the checks read."""

from __future__ import annotations

import json
import re

import pytest
from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
DATA = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [cell["name"] for cell in DATA["workloads"]]
METRICS = DATA["end_to_end"] + DATA["per_layer"]


class EmptyRun:
    setup_s, window_s, records, calls, profile, fixed_call_s = 1.0, 0.0, 0, [], None, []

    def prof_us_per_record(self, stages):
        return None


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_files(real_spec, cell):
    entry = real_spec.cell(cell)
    config = real_spec.config(entry["config"])
    mix = real_spec.traffic(entry["traffic"])
    assert config["name"] == entry["config"] and mix["name"] == entry["traffic"]
    assert real_spec.reference(config["reference"]).is_file()
    assert config["records_per_call"] % mix["pool_records"] == 0
    names = {m["name"] for m in real_spec.metrics(cell, False)}
    assert {"records_per_s", "setup_s"} <= names
    assert real_spec.metrics(cell, True)


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_each_metric_has_a_reader_that_reads_nothing_from_nothing(real_spec, metric):
    """A reader that finds nothing returns nothing; ``setup_s`` is always
    there."""
    value = real_spec.reader(metric)(EmptyRun())
    assert value == (1.0 if metric == "setup_s" else None)


def test_benchmark_json_shape():
    assert set(DATA) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert DATA["paths"] == ["portbench"] and (ROOT / DATA["command"][1]).is_file()
    names = [e["name"] for e in DATA["configs"] + DATA["workloads"] + METRICS]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for entry in DATA["configs"]:
        assert (ROOT / entry["file"]).resolve().is_relative_to(BENCH)
        assert all(NAME.match(k) for k in entry["reduced"])
    assert {m["name"] for m in DATA["end_to_end"]} == {"records_per_s", "setup_s"}
    for m in DATA["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = {m["layer"] for m in DATA["per_layer"]}
    assert all(m["moves"] == "records_per_s" for m in DATA["per_layer"]) and len(layers) == 6
    pairs = [(c["config"], c["traffic"]) for c in DATA["workloads"]]
    assert len(pairs) == len(set(pairs)) and all(c["chips"] == 1 for c in DATA["workloads"])
    assert len(json.dumps(DATA)) < 64 * 1024
