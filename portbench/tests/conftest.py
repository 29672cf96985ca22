"""Shared fixtures of the benchmark's own tests: a benchmark root at a tiny
size (the real configurations and mixes with fewer columns and records),
and a runner of ``run.main`` on the CPU in a process of its own."""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(ROOT))

TINY_COLUMNS = 300_000
TINY_POOL = 2_000
TINY_PASSES = 3


def tiny_name(workload: str) -> str:
    return f"tiny.{workload}"


@pytest.fixture(scope="module")
def real_spec():
    from harness.spec import Spec

    return Spec(ROOT, BENCH)


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory, real_spec) -> pathlib.Path:
    """A benchmark root whose cells are the real ones at a tiny size:
    every other number of their configurations and mixes as committed."""
    root = tmp_path_factory.mktemp("tiny-bench")
    bench = root / "portbench"
    (bench / "configs").mkdir(parents=True)
    (bench / "traffic").mkdir()
    (bench / "metrics").symlink_to(BENCH / "metrics")
    (bench / "reference").symlink_to(BENCH / "reference")
    data = json.loads(json.dumps(real_spec.data))
    for entry in data["configs"]:
        config = real_spec.config(entry["name"])
        config.update(msa_columns=TINY_COLUMNS, records_per_call=TINY_POOL * TINY_PASSES)
        entry["file"] = f"portbench/configs/{entry['name']}.json"
        (root / entry["file"]).write_text(json.dumps(config))
        pattern = bench / "configs" / config["msa_pattern"]
        if not pattern.exists():
            pattern.symlink_to(BENCH / "configs" / config["msa_pattern"])
    for name in {cell["traffic"] for cell in data["workloads"]}:
        mix = real_spec.traffic(name)
        mix["pool_records"] = TINY_POOL
        (bench / "traffic" / f"{name}.json").write_text(json.dumps(mix))
        qualities = bench / "traffic" / mix["qualities"]
        if not qualities.exists():
            qualities.symlink_to(BENCH / "traffic" / mix["qualities"])
    for cell in data["workloads"]:
        cell["name"] = tiny_name(cell["name"])
    for metric in data["end_to_end"] + data["per_layer"]:
        if "workloads" in metric:
            metric["workloads"] = [tiny_name(w) for w in metric["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(data))
    return root


RUNNER = """
import pathlib, sys
sys.path[:0] = [{bench!r}, {root_dir!r}]
import run
{fault}
sys.exit(run.main({argv!r}, root=pathlib.Path({root!r}), bench=pathlib.Path({root!r}) / "portbench",
                  device="cpu", look_for_chip=False))
"""


def run_tiny(root: pathlib.Path, workload: str, seed: int, trace: int = 0, fault: str = ""):
    """(exit code, result or None, standard error) of one run of a tiny
    cell on the CPU, with ``fault`` (Python source) run first."""
    argv = ["--workload", tiny_name(workload), "--seed", str(seed), "--seconds", "0.1",
            "--trace", str(trace)]
    code = RUNNER.format(bench=str(BENCH), root_dir=str(ROOT), fault=fault, argv=argv, root=str(root))
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=root)
    lines = done.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if lines and lines[-1].startswith("{") else None
    return done.returncode, result, done.stderr
