"""Whole runs of the harness on the CPU at a tiny size: the port against
the plain reference, the last line's format, the import check, and the
faults the comparison has to catch with the timed path broken underneath.
These skip the harness's look for a card (``look_for_chip=False``) and
run the port with ``--device cpu``; what needs the card is in
``test_portbench_cuda.py``."""

from __future__ import annotations

import pytest
from conftest import run_tiny

SEED = 2**31 + 101
CHECKS = ["calls_failed", "records_missing_or_extra", "lines_out_of_place",
          "sampled_lines_compared", "sampled_lines_wrong", "header_problems"]


@pytest.mark.parametrize("workload,trace", [("chr21_f4.test_pairs", 0), ("chr21_f3.test_pairs", 1)])
def test_run_is_correct_and_prints_its_line(tiny_root, workload, trace):
    rc, result, err = run_tiny(tiny_root, workload, SEED, trace)
    assert rc == 0, err[-3000:]
    assert result["correct"] is True, err[-3000:]
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks" and list(result["checks"]) == CHECKS
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["checks"]["sampled_lines_compared"]["value"] > 1000
    want = {"records_per_s", "setup_s"} if not trace else {
        "call_fixed_s", "host_stages_us_per_rec", "realign_us_per_rec", "agg_pack_dispatch_us_per_rec"}
    assert want <= set(result["metrics"]), result["metrics"]
    assert all(m["value"] >= 0 for m in result["metrics"].values())
    tail = err.strip().splitlines()[-len(CHECKS):]
    assert [line.split()[2] for line in tail] == CHECKS


# Python run in the run's process before the harness: each breaks the
# timed path underneath, as a faulty program would
FAULTS = {
    # the projection returns the records as they came
    "state_unchanged": '''
import panvc3_tpu_torch.pipeline.project_alignments as pa
from panvc3_tpu_torch.io.sam import SamReader
def unchanged(src, dst, cfg, **kw):
    reader = SamReader(src)
    with open(dst, "wb") as out:
        out.write(reader.header.to_text().encode())
        for block in reader.raw_record_line_blocks():
            out.write(b"".join(block))
    return pa.ProjectStatistics()
pa.run_project_alignments = unchanged
''',
    # every other record of each batch left out
    "half_the_batch_left_out": '''
import panvc3_tpu_torch.io.sam as sam
write_raw = sam.SamWriter.write_raw
def half(self, blob, names=None):
    lines = blob.split(b"\\n")
    write_raw(self, b"\\n".join(lines[0:-1:2] + [b""]), names)
sam.SamWriter.write_raw = half
''',
    # each realigned record's position off by one where the line is made
    "answer_altered": '''
import panvc3_tpu_torch.io.sam as sam
write_raw = sam.SamWriter.write_raw
def altered(self, blob, names=None):
    out = []
    for line in blob.split(b"\\n"):
        if b"\\tXB:B:" in line:
            f = line.split(b"\\t")
            f[3] = str(int(f[3]) + 1).encode()
            line = b"\\t".join(f)
        out.append(line)
    write_raw(self, b"\\n".join(out), names)
sam.SamWriter.write_raw = altered
''',
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_faults_come_out_not_correct(tiny_root, fault):
    rc, result, err = run_tiny(tiny_root, "chr21_f4.test_pairs", SEED + 1, 0, FAULTS[fault])
    assert rc == 0, err[-3000:]
    assert result["correct"] is False
    assert any(c["value"] != 0 for k, c in result["checks"].items() if k != "sampled_lines_compared")


@pytest.mark.parametrize("name", ["jax", "panvc3_tpu"])
def test_a_forbidden_module_ends_the_run_without_a_result(tiny_root, name):
    fault = f"import types; sys.modules[{name!r}] = types.ModuleType({name!r})"
    rc, result, err = run_tiny(tiny_root, "chr21_f4.test_pairs", SEED + 2, 0, fault)
    assert rc != 0 and result is None
    assert f"this process loaded {name}" in err


def test_a_reader_that_loads_a_forbidden_module_ends_the_run(tiny_root, tmp_path):
    """A metric reader runs after the window; what it loads is checked
    before the result is printed."""
    import shutil

    from conftest import BENCH

    root = tmp_path / "root"
    shutil.copytree(tiny_root, root, symlinks=True)
    metrics = root / "portbench" / "metrics"
    metrics.unlink()
    shutil.copytree(BENCH / "metrics", metrics, ignore=shutil.ignore_patterns("__pycache__"))
    reader = metrics / "records_per_s.py"
    reader.write_text(reader.read_text() + "\nimport jax  # noqa: E402,F401\n")
    stub = tmp_path / "stub" / "jax"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("")
    fault = f"sys.path.insert(0, {str(stub.parent)!r})"
    rc, result, err = run_tiny(root, "chr21_f4.test_pairs", SEED + 3, 0, fault)
    assert rc == 3 and result is None
    assert "this process loaded jax" in err


def test_no_result_without_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files
    cannot run: the port is not there."""
    import shutil
    import subprocess
    import sys

    from conftest import BENCH, ROOT

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    done = subprocess.run([sys.executable, "portbench/run.py", "--workload", "chr21_f4.test_pairs",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert done.returncode != 0 and not done.stdout.strip()
