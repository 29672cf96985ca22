"""The port imports no JAX and nothing of panvc3_tpu, and never falls back
from CUDA to the CPU."""

from __future__ import annotations

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "panvc3_tpu_torch"

# imports every module of the port, runs a small slice of the pipeline
# (the CLI on a tiny MSA built with the port's own index, with integer and
# with quality scoring and through the gap kernel, then the object path,
# the fused engines through the CLI, --data-parallel through the CLI and a
# mesh of four CPU shards through the library, the workflow driver, BAM out
# and back in, and three host tools on that BAM), then lists any JAX or
# panvc3_tpu module loaded
_SCRIPT = r"""
import importlib, os, pkgutil, sys
import numpy as np
import panvc3_tpu_torch
for mod in pkgutil.walk_packages(panvc3_tpu_torch.__path__, "panvc3_tpu_torch."):
    if mod.name != "panvc3_tpu_torch.__main__":
        importlib.import_module(mod.name)
from panvc3_tpu_torch.bitvec import GapBitVector
from panvc3_tpu_torch.cli.main import main
from panvc3_tpu_torch.msa_index import ChrEntry, MsaIndex, SequenceEntry

work = sys.argv[1]
rng = np.random.default_rng(0)
base = rng.choice(np.frombuffer(b"ACGT", np.uint8), 600)
rows = {}
for k, sid in enumerate(["F", "REF"]):
    seq = base.copy()
    seq[rng.random(600) < 0.03] = ord("-")
    rows[sid] = seq.tobytes()
index = MsaIndex()
ce = ChrEntry("c")
ce.sequence_entries = [SequenceEntry(s, GapBitVector.from_gap_string(a)) for s, a in sorted(rows.items())]
index.chr_entries.append(ce)
index.sort()
index.save(f"{work}/msa.npz")
ref = rows["REF"].replace(b"-", b"")
founder = rows["F"].replace(b"-", b"")
open(f"{work}/ref.fa", "wb").write(b">c\n" + ref + b"\n")
lines = [f"@HD\tVN:1.6\n@SQ\tSN:c/F\tLN:{len(founder)}"]
for i in range(40):
    pos = int(rng.integers(0, len(founder) - 60))
    seq = founder[pos:pos + 20] + b"ACG" + founder[pos + 22:pos + 52]
    lines.append(f"r{i}\t0\tc/F\t{pos + 1}\t60\t20=3I2D30=\t*\t0\t0\t{seq.decode()}\t" + "I" * len(seq))
open(f"{work}/in.sam", "w").write("\n".join(lines) + "\n")
for extra, geometry in (([], "1"), (["-q"], "1"), ([], "0")):
    os.environ["PANVC3_EVENT_GEOMETRY"] = geometry
    rc = main(["project_alignments", "--device", "cpu", "-a", f"{work}/in.sam",
               "-m", f"{work}/msa.npz", "-r", f"{work}/ref.fa", "-d", "REF",
               "-s", "/", "-o", f"{work}/out.sam", "--status-output-interval", "0",
               *extra])
    assert rc == 0
    assert sum(1 for ln in open(f"{work}/out.sam") if not ln.startswith("@")) == 40
del os.environ["PANVC3_EVENT_GEOMETRY"]
# the object path
from panvc3_tpu_torch.pipeline.project_alignments import ProjectConfig, run_project_alignments
cfg = ProjectConfig(msa_index_path=f"{work}/msa.npz", reference_path=f"{work}/ref.fa",
                    reference_msa_id="REF", ref_id_separator="/", engine="device",
                    fastlane=False, status_output_interval=0)
stats = run_project_alignments(f"{work}/in.sam", f"{work}/obj.sam", cfg, device="cpu")
assert stats.matched_reads == 40 and stats.realigned_range_count > 0
# the fused engines through the CLI (the arbiter forced), then the workflow
# driver on the bundled toy data
os.environ["PANVC3_ENGINE_LANE"] = "fused"
assert main(["project_alignments", "--device", "cpu", "-a", f"{work}/in.sam",
             "-m", f"{work}/msa.npz", "-r", f"{work}/ref.fa", "-d", "REF", "-s", "/",
             "-o", f"{work}/fused.sam", "--status-output-interval", "0"]) == 0
assert open(f"{work}/fused.sam").read() == open(f"{work}/out.sam").read()
del os.environ["PANVC3_ENGINE_LANE"]
# --data-parallel: a mesh of the one CPU through the CLI, then four shards
# on it through the library on the fused lane
assert main(["project_alignments", "--device", "cpu", "--data-parallel", "-1",
             "-a", f"{work}/in.sam", "-m", f"{work}/msa.npz", "-r", f"{work}/ref.fa",
             "-d", "REF", "-s", "/", "-o", f"{work}/dp.sam", "--status-output-interval", "0"]) == 0
assert open(f"{work}/dp.sam").read().split("@PG")[0] == open(f"{work}/out.sam").read().split("@PG")[0]
import dataclasses
stats = run_project_alignments(f"{work}/in.sam", f"{work}/mesh.sam",
                               dataclasses.replace(cfg, data_parallel=-1, fused_kernel=True),
                               device=["cpu"] * 4)
assert stats.matched_reads == 40
assert open(f"{work}/mesh.sam").read() == open(f"{work}/obj.sam").read()
from panvc3_tpu_torch import workflow
assert workflow.main(["--workdir", f"{work}/wf", "--engine", "device", "--device", "cpu",
                      "--n-reads", "60"]) == 0
# a BAM round trip on the fast lane, then host tools on the BAM
common = ["--device", "cpu", "-m", f"{work}/msa.npz", "-r", f"{work}/ref.fa", "-d", "REF",
          "-s", "/", "--status-output-interval", "0"]
from panvc3_tpu_torch.io.sam import SamReader, SamWriter
reader = SamReader(f"{work}/in.sam")
writer = SamWriter(f"{work}/in.bam", reader.header, bam=True)
for rec in reader:
    writer.write(rec)
writer.close()
assert main(["project_alignments", *common, "-a", f"{work}/in.bam", "-B", "-b", "-o", f"{work}/out.bam"]) == 0
assert open(f"{work}/out.bam", "rb").read(4) == b"\x1f\x8b\x08\x04"
assert len(list(SamReader(f"{work}/out.bam"))) == 40
assert main(["index_msa", "--list-contents", "-d", f"{work}/msa.npz"]) == 0
assert main(["rewrite_cigar", "-a", f"{work}/out.bam", "-B", "-M", "-b", "-o", f"{work}/m.bam",
             "--status-output-interval", "0"]) == 0
assert main(["recalculate_mapq", "-a", f"{work}/m.bam", "-o", f"{work}/mapq.sam", "--jobs", "2",
             "--status-output-interval", "0"]) == 0
assert sum(1 for ln in open(f"{work}/mapq.sam") if not ln.startswith("@")) == 40
assert main(["alignment_statistics", "-a", f"{work}/m.bam", "-O"]) == 0
leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
print("JAX_MODULES", leaked)
ref_pkg = sorted(m for m in sys.modules if m == "panvc3_tpu" or m.startswith("panvc3_tpu."))
print("PANVC3_TPU_MODULES", ref_pkg)
"""


def test_port_runs_without_importing_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), PANVC3_HOST_DP="0")
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT, str(tmp_path)],
        env=env, capture_output=True, timeout=300, cwd=str(tmp_path),
    )
    assert proc.returncode == 0, proc.stderr.decode()
    out = proc.stdout.decode()
    assert "JAX_MODULES []" in out, out
    assert "PANVC3_TPU_MODULES []" in out, out


def test_no_jax_import_statement_in_port():
    pattern = re.compile(r"^\s*(import\s+jax|from\s+jax[\s.])", re.MULTILINE)
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders, offenders


_REF_IMPORT = re.compile(
    r"^\s*(import\s+panvc3_tpu(\.|\s|$|,)|from\s+panvc3_tpu(\.|\s))", re.MULTILINE
)


def test_no_panvc3_tpu_import_statement_in_port():
    """Only ``panvc3_tpu_torch`` is imported by name: the port and
    chip_smoke.py carry their own copies of the reference's host modules."""
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [str(f) for f in files if _REF_IMPORT.search(f.read_text())]
    assert not offenders, offenders
    # the pattern does see such a line
    assert _REF_IMPORT.search("from panvc3_tpu.io.sam import SamReader\n")
    assert _REF_IMPORT.search("import panvc3_tpu\n")
    assert not _REF_IMPORT.search("from panvc3_tpu_torch.io.sam import SamReader\n")


def test_realign_batch_defaults_to_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from panvc3_tpu_torch.ops.realign_batch import realign_batch

    refs, queries = [b"ACGTAC", b"GGA"], [b"ACTAC", b"GGTA"]
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        realign_batch(refs, queries, 0, -1)
    assert realign_batch(refs, queries, 0, -1, device="cpu") == [
        [(2, "="), (1, "D"), (3, "=")],
        [(2, "="), (1, "I"), (1, "=")],
    ]


def test_cuda_device_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from panvc3_tpu_torch.pipeline.project_alignments import (
        ProjectConfig,
        run_project_alignments,
    )

    cfg = ProjectConfig(msa_index_path="missing.npz", engine="device")
    with pytest.raises(RuntimeError, match="cuda"):
        run_project_alignments(tmp_path / "in.sam", tmp_path / "out.sam", cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        run_project_alignments(
            tmp_path / "in.sam", tmp_path / "out.sam", cfg, device="cuda:0"
        )
    # a mesh with any CUDA entry raises as well
    with pytest.raises(RuntimeError, match="cuda"):
        run_project_alignments(
            tmp_path / "in.sam", tmp_path / "out.sam",
            ProjectConfig(msa_index_path="missing.npz", engine="device", data_parallel=-1),
            device=["cpu", "cuda:0"],
        )
    # the CLI's default device is cuda as well
    proc = subprocess.run(
        [sys.executable, "-m", "panvc3_tpu_torch", "project_alignments",
         "-m", "x.npz", "-r", "x.fa", "-d", "REF", "-a", "x.sam"],
        env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True,
        timeout=120, cwd=str(tmp_path),
    )
    assert proc.returncode != 0
    assert b"torch.cuda.is_available() is False" in proc.stderr


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero, printing no result line, when no card
    is present."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")],
        capture_output=True, timeout=120, cwd=str(REPO),
    )
    assert proc.returncode != 0
    assert b'"ok"' not in proc.stdout
