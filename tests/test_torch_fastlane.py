"""The port's project_alignments slice against panvc3_tpu, byte for byte.

The CLI runs in a subprocess (``python -m panvc3_tpu_torch
project_alignments --device cpu``) with ``PANVC3_HOST_DP=0``, so every
realignment takes the device lane: aggregate dispatches through the wires,
with the DP in its plain PyTorch version on the CPU.  Its SAM output
(``@PG`` lines stripped) and realigned-ranges TSV must equal
panvc3_tpu's ``run_project_alignments`` on the same input, and the
subprocess's ``[fastlane diag]`` line must show the wires engaged.  The
other lanes and dispatch shapes run in-process.
"""

from __future__ import annotations

import io
import json
import os
import re
import subprocess
import sys

import pytest

from panvc3_tpu.pipeline.project_alignments import (
    ProjectConfig,
    TagSpec,
    run_project_alignments as jax_run_project_alignments,
)

from .test_fastpath import _rich_sam
from .test_projector_adversarial import ROWS, _build_inputs
from .test_workflow_data import WORKFLOW, founder_seqs, msa_files  # noqa: F401 (fixtures)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GENOME = str(WORKFLOW / "genome/genome.fa.gz")


def _strip_pg(sam: bytes) -> bytes:
    return b"\n".join(ln for ln in sam.split(b"\n") if not ln.startswith(b"@PG"))


def _with_n(sam: bytes) -> bytes:
    """Put an N at query offset 50 of every read: inside every inserted
    run of ``_rich_sam``, so no window qualifies for the 2-bit wire."""
    out = []
    for ln in sam.split(b"\n"):
        f = ln.split(b"\t")
        if ln and not ln.startswith(b"@") and len(f) > 9 and len(f[9]) > 60:
            f[9] = f[9][:50] + b"N" + f[9][51:]
        out.append(b"\t".join(f))
    return b"\n".join(out)


def _jax_host(sam, index, reference, tmp_path, **kw):
    ranges = tmp_path / "jax_ranges.tsv"
    cfg = ProjectConfig(
        msa_index_path=str(index),
        reference_path=str(reference),
        reference_msa_id="REF",
        ref_id_separator="/",
        tags=TagSpec(rec_idx="XI"),
        engine="host",
        preserve_tags=("XA",),
        output_realigned_ranges_path=str(ranges),
        status_output_interval=0,
        **kw,
    )
    out = io.BytesIO()
    jax_run_project_alignments(io.BytesIO(sam), out, cfg)
    return out.getvalue(), ranges.read_text()


def _port_cli(sam, index, reference, tmp_path, extra=()):
    sam_path = tmp_path / "in.sam"
    sam_path.write_bytes(sam)
    out_path = tmp_path / "port.sam"
    ranges = tmp_path / "port_ranges.tsv"
    full_env = dict(
        os.environ,
        PYTHONPATH=REPO,
        PANVC3_HOST_DP="0",
        PANVC3_FASTLANE_PROF="1",
    )
    proc = subprocess.run(
        [
            sys.executable, "-m", "panvc3_tpu_torch", "project_alignments",
            "--device", "cpu", "-a", str(sam_path), "-m", str(index),
            "-r", str(reference), "-d", "REF", "-s", "/",
            "--record-index-tag", "XI", "-t", "XA",
            "--device-batch-size", "32", "--status-output-interval", "0",
            "-l", str(ranges), "-o", str(out_path), *extra,
        ],
        env=full_env, capture_output=True, timeout=300, cwd=REPO,
    )
    err = proc.stderr.decode()
    assert proc.returncode == 0, err
    m = re.search(r"\[fastlane diag\] (\{.*\})", err)
    assert m, err
    return out_path.read_bytes(), ranges.read_text(), json.loads(m.group(1)), err


@pytest.mark.parametrize("queries", ["acgt", "with_n"])
def test_cli_device_lane_matches_jax(msa_files, founder_seqs, tmp_path, queries):  # noqa: F811
    index_path, _, _ = msa_files
    sam = _rich_sam(founder_seqs)
    if queries == "with_n":
        sam = _with_n(sam)
    want, want_ranges = _jax_host(sam, index_path, GENOME, tmp_path)
    got, got_ranges, diag, err = _port_cli(sam, index_path, GENOME, tmp_path)
    assert _strip_pg(got) == _strip_pg(want)
    assert got_ranges == want_ranges
    assert diag["device"] == "cpu"
    assert diag["dispatches"] > 0 and diag["refgather"] > 0
    if queries == "acgt":
        assert diag["wire2"] > 0
    else:
        # the 4-bit ref-gather wire carried every window
        assert diag["wire2"] == 0
    assert "Matched reads:     160" in err


def test_cli_adversarial_matches_fixtures_and_jax(tmp_path):
    rows = [r for r in ROWS if r["mode"] == "int"]
    index_path, fa_path, sam = _build_inputs(tmp_path, rows)
    want, want_ranges = _jax_host(sam, index_path, fa_path, tmp_path)
    got, got_ranges, diag, _ = _port_cli(sam, index_path, fa_path, tmp_path)
    assert _strip_pg(got) == _strip_pg(want)
    assert got_ranges == want_ranges
    # one contig per case: the flat reference is still deferring its
    # rebuild when the window dispatches, so the staged-row wire carries it
    assert diag["dispatches"] > 0
    fields = {}
    for line in got.decode().splitlines():
        if not line.startswith("@"):
            f = line.split("\t")
            fields[f[0]] = (int(f[3]) - 1, f[5])
    for i, r in enumerate(rows):
        assert fields[f"r{i}"] == (r["exp_pos"], r["exp_cigar"]), r["name"]


def _port_inprocess(sam, index, tmp_path, device="cpu", **kw):
    from panvc3_tpu_torch.pipeline import project_alignments as port

    ranges = tmp_path / "inproc_ranges.tsv"
    cfg = port.ProjectConfig(
        msa_index_path=str(index),
        reference_path=GENOME,
        reference_msa_id="REF",
        ref_id_separator="/",
        tags=port.TagSpec(rec_idx="XI"),
        engine="device",
        device_batch_size=32,
        preserve_tags=("XA",),
        output_realigned_ranges_path=str(ranges),
        status_output_interval=0,
        **kw,
    )
    out = io.BytesIO()
    stats = port.run_project_alignments(io.BytesIO(sam), out, cfg, device=device)
    return out.getvalue(), ranges.read_text(), stats


@pytest.fixture(scope="module")
def rich_case(msa_files, founder_seqs, tmp_path_factory):  # noqa: F811
    index_path, _, _ = msa_files
    sam = _rich_sam(founder_seqs, n_reads=480, seed=12)
    want = _jax_host(sam, index_path, GENOME, tmp_path_factory.mktemp("jax"))
    return index_path, sam, want


@pytest.mark.parametrize(
    "variant,engaged",
    [
        # per-batch device dispatch (classic wire), no aggregation
        ({"PANVC3_HOST_DP": "0", "PANVC3_DP_AGGREGATE": "0"}, {"dispatches": 0}),
        # aggregate dispatch shipping staged reference rows (classic wire)
        ({"PANVC3_HOST_DP": "0", "PANVC3_DP_REFGATHER": "0"}, {"refgather": 0}),
        # 4-bit ref-gather wire on N-free windows
        ({"PANVC3_HOST_DP": "0", "PANVC3_DP_WIRE2": "0"}, {"wire2": 0}),
        # host C DP lane forced
        ({"PANVC3_HOST_DP_CELLS": str(10**18)}, {"dispatches": 0}),
        # adaptive lane choice under adversarial scheduling jitter
        ({"PANVC3_FASTLANE_CHAOS": "3"}, {}),
        ({"PANVC3_HOST_DP": "0", "PANVC3_FASTLANE_CHAOS": "4"}, {}),
    ],
    ids=["per-batch", "no-refgather", "wire4", "host-lane", "chaos-adaptive", "chaos-device"],
)
def test_fastlane_variants_match_jax(rich_case, tmp_path, monkeypatch, variant, engaged):
    from panvc3_tpu_torch.pipeline import fastlane

    index_path, sam, (want, want_ranges) = rich_case
    for key in ("PANVC3_HOST_DP", "PANVC3_HOST_DP_CELLS"):
        monkeypatch.delenv(key, raising=False)
    for key, val in variant.items():
        monkeypatch.setenv(key, val)
    before = dict(fastlane.AGG_DIAG)
    got, got_ranges, stats = _port_inprocess(sam, index_path, tmp_path)
    delta = {k: fastlane.AGG_DIAG[k] - before[k] for k in before}
    assert stats.realigned_range_count > 0
    assert _strip_pg(got) == _strip_pg(want)
    assert got_ranges == want_ranges
    for key, val in engaged.items():
        assert delta[key] == val, (key, delta)
    if "PANVC3_DP_AGGREGATE" not in variant and "PANVC3_HOST_DP" in variant:
        assert delta["dispatches"] > 0, delta
    if "PANVC3_DP_WIRE2" in variant:
        assert delta["refgather"] > 0, delta


def test_fastlane_unthreaded_matches_jax(rich_case, tmp_path, monkeypatch):
    """The serial drain (no writer thread) dispatches per batch."""
    index_path, sam, (want, want_ranges) = rich_case
    monkeypatch.setenv("PANVC3_HOST_DP", "0")
    got, got_ranges, _ = _port_inprocess(
        sam, index_path, tmp_path, threaded_pipeline=False
    )
    assert _strip_pg(got) == _strip_pg(want)
    assert got_ranges == want_ranges


def _long_run_sam(founder_seqs, n_reads=24, seed=8) -> bytes:
    """Reads with one 130I130D run each: the aggregate R/Q pads then reach
    R+Q >= 256, past what the wires carry (the unwired dispatch)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    stripped = {sid: s.replace(b"-", b"") for sid, s in founder_seqs.items()}
    lines = ["@HD\tVN:1.6"]
    for sid, s in stripped.items():
        lines.append(f"@SQ\tSN:test/{sid}\tLN:{len(s)}")
    names = [s for s in stripped if s != "REF"]
    for i in range(n_reads):
        sid = names[i % len(names)]
        s = stripped[sid]
        pos = int(rng.integers(0, len(s) - 400))
        ins = rng.choice(np.frombuffer(b"ACGT", np.uint8), 130).tobytes()
        seq = (s[pos:pos + 60] + ins + s[pos + 190:pos + 250]).decode()
        lines.append(
            f"long{i}\t0\ttest/{sid}\t{pos + 1}\t60\t60=130I130D60=\t*\t0\t0"
            f"\t{seq}\t" + "I" * len(seq)
        )
    return ("\n".join(lines) + "\n").encode()


@pytest.mark.parametrize("aggregate", ["1", "0"])
def test_fastlane_long_runs_match_jax(msa_files, founder_seqs, tmp_path, monkeypatch, aggregate):  # noqa: F811
    index_path, _, _ = msa_files
    sam = _long_run_sam(founder_seqs)
    want, want_ranges = _jax_host(sam, index_path, GENOME, tmp_path)
    monkeypatch.setenv("PANVC3_HOST_DP", "0")
    monkeypatch.setenv("PANVC3_DP_AGGREGATE", aggregate)
    from panvc3_tpu_torch.pipeline import fastlane

    before = dict(fastlane.AGG_DIAG)
    got, got_ranges, stats = _port_inprocess(sam, index_path, tmp_path)
    delta = {k: fastlane.AGG_DIAG[k] - before[k] for k in before}
    # no wire carries these pads: the aggregate goes out unwired
    assert delta["refgather"] == 0
    assert (delta["dispatches"] > 0) == (aggregate == "1")
    assert stats.realigned_range_count >= 24
    assert _strip_pg(got) == _strip_pg(want)
    assert got_ranges == want_ranges


@pytest.mark.parametrize(
    "kw,device",
    [
        ({"data_parallel": 2}, ["cpu"] * 2),
        ({"fused_kernel": True}, "cpu"),
    ],
    ids=["data-parallel", "fused-kernel"],
)
def test_uncovered_configurations_raise(rich_case, tmp_path, kw, device):
    """No configuration is left uncovered, and none raises: --data-parallel
    runs the object path over a mesh of two shards (here both on the CPU),
    the fused engines run the object path's fused lane; each gives the
    single-device SAM and ranges."""
    from panvc3_tpu_torch.ops import engine

    index_path, sam, (want, want_ranges) = rich_case
    got, got_ranges, stats = _port_inprocess(sam, index_path, tmp_path, device=device, **kw)
    assert stats.matched_reads > 0
    assert _strip_pg(got) == _strip_pg(want)
    assert got_ranges == want_ranges
    if "fused_kernel" in kw:
        assert engine.FUSED_ROUTES["v4_dp"] + engine.FUSED_ROUTES["host_realign"] > 0


def _options(module):
    proc = subprocess.run(
        [sys.executable, "-m", module, "project_alignments", "--help"],
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        timeout=120, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr.decode()
    return set(re.findall(r"(?<![\w-])(--[a-z][a-z0-9-]*)", proc.stdout.decode()))


def test_cli_help_lists_jax_options_plus_device():
    jax_opts = _options("panvc3_tpu")
    port_opts = _options("panvc3_tpu_torch")
    assert "--msa-index" in jax_opts and "--engine" in jax_opts
    assert port_opts == jax_opts | {"--device"}
