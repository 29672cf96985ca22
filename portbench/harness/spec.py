"""Finds what ``BENCHMARK.json`` names, by name, under the benchmark's
folder: ``configs/`` (each configuration's ``file``), ``traffic/<mix>.json``,
``metrics/<metric>.py`` (a reader: ``read(run) -> float | None``) and
``reference/<reference>.py`` (a configuration's plain reference).  A
later cell, mix or metric comes with its own files and entries; nothing
here names one.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib


class Spec:
    def __init__(self, root: pathlib.Path, bench: pathlib.Path):
        self.root, self.bench = root, bench
        path = root / "BENCHMARK.json"
        if not path.is_file():
            raise FileNotFoundError(f"no BENCHMARK.json in {root}")
        self.data = json.loads(path.read_text())

    def cell(self, name: str) -> dict:
        for cell in self.data["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for entry in self.data["configs"]:
            if entry["name"] == name:
                return json.loads((self.root / entry["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.bench / "traffic" / f"{name}.json").read_text())

    def metrics(self, cell: str, trace: bool) -> list[dict]:
        """The metrics a run of ``cell`` reports: the end-to-end ones, or
        with ``trace`` the per-layer ones."""
        entries = self.data["per_layer" if trace else "end_to_end"]
        return [m for m in entries if cell in m.get("workloads", [cell])]

    def reader(self, name: str):
        return _load(self.bench / "metrics" / f"{name}.py", "portbench_metric_" + name.replace(".", "_").replace("-", "_")).read

    def reference(self, name: str) -> pathlib.Path:
        return self.bench / "reference" / f"{name}.py"


def _load(path: pathlib.Path, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
