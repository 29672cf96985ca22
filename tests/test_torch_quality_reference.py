"""The benchmark's plain reference of ``project_alignments -q``
(``portbench/reference/project_alignments_q.py``) against the port, on
the CPU, on inputs the benchmark's own generators make from a seed at a
small size: the test workflow's MSA shape at a few hundred thousand
columns and the source's read pairs with their quality strings.

The port's CLI entry with ``--use-read-base-qualities --device cpu``
writes every line as the reference works it out, with the realign runs
forced onto the host C DP lane and, apart, onto the device lane (its
plain versions on the CPU), aggregated or batch by batch; the fast lane's
``-q`` counters show the lane each took, and count a batch too long for
the quantised scores off the host lane.  The reference's quantised Malde
table is the port's, entry for entry, though it computes its own; its
float64 setting, upstream's arithmetic, aligns every run as the port's
host oracle does in its float64 mode.  Two controls in the
program's place read lines wrong: the reference with the qualities
ignored (integer scores) and with the scores quantised to 1/16 in place
of the configuration's 1/256.  A coarser quantisation changes a line in
about one of three hundred realigned records, so the controls run over
the realigned records of a larger pool.
"""

from __future__ import annotations

import os
import pathlib
import sys

import numpy as np
import pytest

from panvc3_tpu_torch.align import align_global, malde_tables
from panvc3_tpu_torch.cli.main import main as cli_main
from panvc3_tpu_torch.pipeline import fastlane

REPO = pathlib.Path(__file__).resolve().parent.parent
BENCH = REPO / "portbench"
sys.path.insert(0, str(BENCH))

from harness import msa, traffic  # noqa: E402
from harness.inputs import CellInputs  # noqa: E402
from harness.spec import Spec  # noqa: E402
from reference import project_alignments as base  # noqa: E402
from reference import project_alignments_q as refq  # noqa: E402

from .test_torch_fastlane import _port_inprocess  # noqa: E402
from .test_workflow_data import founder_seqs, msa_files  # noqa: E402,F401 (fixtures)

CELL = "chr21_f4_q.test_pairs"
SEED = 2**31 + 2207
COLUMNS = 300_000
POOL = 4096
CONTROL_POOL = 131_072  # ~2,600 realigned records

LANES = {
    "host": {"PANVC3_HOST_DP_CELLS": str(10**18)},
    "device": {"PANVC3_HOST_DP": "0"},
    "device-per-batch": {"PANVC3_HOST_DP": "0", "PANVC3_DP_AGGREGATE": "0"},
}


def _cell(pool: int):
    spec = Spec(REPO, BENCH)
    cell = spec.cell(CELL)
    config = dict(spec.config(cell["config"]), msa_columns=COLUMNS, records_per_call=pool)
    mix = dict(spec.traffic(cell["traffic"]), pool_records=pool)
    return config, mix


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """The inputs of one call of the whole pool, and the reference's line
    for each of its records."""
    config, mix = _cell(POOL)
    work = tmp_path_factory.mktemp("quality-reference")
    inputs = CellInputs(work, SEED, config, mix, cli_main, BENCH)
    records = np.arange(POOL)
    ref_inputs = base.Inputs(SEED, config, mix, records, BENCH)
    expected = refq.expected_lines(ref_inputs, config, mix, records)
    return config, work, inputs, dict(zip(records.tolist(), expected))


def _port_lines(config, work, inputs, lane: str) -> list[str]:
    out = work / f"projected-{lane}.sam"
    fill = {"device": "cpu", "alignments": inputs.alignments, "msa_index": inputs.index,
            "reference": inputs.fasta, "order": inputs.order, "output": out}
    assert cli_main([a.format_map(fill) for a in config["tool_argv"]]) == 0
    return [line for line in out.read_text().splitlines() if not line.startswith("@")]


@pytest.mark.parametrize("lane", list(LANES))
def test_port_writes_every_line_as_the_reference(small, monkeypatch, lane):
    config, work, inputs, expected = small
    for key in [k for k in os.environ if k.startswith("PANVC3_")]:
        monkeypatch.delenv(key)
    for key, value in LANES[lane].items():
        monkeypatch.setenv(key, value)
    before = dict(fastlane.AGG_DIAG)
    lines = _port_lines(config, work, inputs, lane)
    delta = {k: fastlane.AGG_DIAG[k] - before[k] for k in before}
    compared, wrong, first = base.judge(lines, np.arange(len(lines)), expected)
    assert (compared, wrong) == (POOL, 0), first
    on_device = lane != "host"
    took, other = ("dp_runs_dev", "dp_runs_host") if on_device else ("dp_runs_host", "dp_runs_dev")
    assert delta[took] > 0 and delta[other] == 0
    assert (delta["dispatches"] > 0) == (lane == "device")
    # phreds cross to the card only on the device lane; no batch here is
    # too long for the quantised scores
    assert (delta["qual_bytes_dev"] > 0) == on_device
    assert delta["qual_runs_off_host"] == 0


def test_a_batch_too_long_for_the_quantised_scores_is_counted_off_the_host_lane(
        msa_files, founder_seqs, tmp_path, monkeypatch):  # noqa: F811
    """One read with a 2750I2750D run: R+Q passes ``QUAL_MAX_STEPS``, so
    the host lane may not take its batch, and the device paths refuse it."""
    index_path, _, _ = msa_files
    stripped = {sid: seq.replace(b"-", b"") for sid, seq in founder_seqs.items()}
    lines = ["@HD\tVN:1.6"] + [f"@SQ\tSN:test/{sid}\tLN:{len(seq)}" for sid, seq in stripped.items()]
    seq = stripped["1"]
    inserted = np.random.default_rng(3).choice(np.frombuffer(b"ACGT", np.uint8), 2750).tobytes()
    read = (seq[100:160] + inserted + seq[2910:2970]).decode()
    lines.append(f"long\t0\ttest/1\t101\t60\t60=2750I2750D60=\t*\t0\t0\t{read}\t" + "5" * len(read))
    monkeypatch.setenv("PANVC3_HOST_DP_CELLS", str(10**18))
    before = fastlane.AGG_DIAG["qual_runs_off_host"]
    with pytest.raises(ValueError, match="too long"):
        _port_inprocess(("\n".join(lines) + "\n").encode(), index_path, tmp_path,
                        use_read_base_qualities=True)
    assert fastlane.AGG_DIAG["qual_runs_off_host"] - before == 1


@pytest.mark.parametrize("table", [0, 1], ids=["match", "mismatch"])
def test_reference_table_is_the_ports(table):
    ours, ports = refq.malde_tables()[table], malde_tables()[table]
    assert ours.shape == ports.shape == (64, 64)
    assert np.array_equal(ours, ports)


@pytest.fixture(scope="module")
def control_lines():
    """The reference's lines of the realigned records of a larger pool,
    and its inputs, at the configuration's 1/256."""
    config, mix = _cell(CONTROL_POOL)
    made = msa.Msa(SEED, config, BENCH / "configs")
    pool = traffic.make_pool(SEED, mix, traffic.Rows(made), int(config["aligner_k"]), BENCH / "traffic")
    records = np.flatnonzero(pool["realigns"])
    ref_inputs = base.Inputs(SEED, config, mix, records, BENCH)
    return config, mix, records, ref_inputs, refq.expected_lines(ref_inputs, config, mix, records)


def _integer_scores(ref_inputs, config, mix, records):
    integer = dict(config, tool_argv=[a for a in config["tool_argv"] if a != refq.QUALITY_FLAG])
    return base.expected_lines(ref_inputs, integer, mix, records)


CONTROLS = {
    "qualities_ignored": _integer_scores,
    "sixteenths": lambda ref_inputs, config, mix, records: refq.expected_lines(
        ref_inputs, config, mix, records, shift=4),
}


@pytest.mark.parametrize("control", list(CONTROLS))
def test_control_reads_lines_wrong(control_lines, control):
    config, mix, records, ref_inputs, expected = control_lines
    assert len(records) > 2000
    lines = ["\t".join(fields + sorted(tags))
             for fields, tags in CONTROLS[control](ref_inputs, config, mix, records)]
    compared, wrong, _ = base.judge(lines, records, dict(zip(records.tolist(), expected)))
    assert compared == len(records) and wrong >= 1


def test_reference_in_float64_is_the_ports_exact_oracle(control_lines, monkeypatch):
    """The reference's float64 setting, the upstream tool's arithmetic,
    aligns every run of the larger pool's realigned records as the port's
    host oracle does under ``PANVC3_MALDE_EXACT=1``."""
    config, mix, records, ref_inputs, _ = control_lines
    _, _, refs, queries, phreds = refq.realigned_runs(ref_inputs, len(records))
    assert len(refs) > 2000
    match, mismatch = refq.malde_tables(None)
    ours = refq.align_runs(refs, queries, phreds, 0, -1, match[refq.PINNED], mismatch[refq.PINNED])
    monkeypatch.setenv("PANVC3_MALDE_EXACT", "1")
    for ref, query, phred, ops in zip(refs, queries, phreds, ours):
        _, cigar = align_global(ref, query, 0, -1, np.full(len(ref), refq.PINNED), phred)
        assert list(cigar) == ops


@pytest.mark.parametrize("argv", [
    ["project_alignments", "--reference-msa-id=REF"],
    ["project_alignments", "-q"],
    ["project_alignments", refq.QUALITY_FLAG, "--keep-duplicate-ranges"],
    ["project_alignments", refq.QUALITY_FLAG, "--gap-opening-cost=-2", "--use-read-base-qualities=1"],
])
def test_reference_refuses_what_it_does_not_model(argv):
    with pytest.raises(ValueError):
        refq.options(argv)


def test_reference_reads_the_configurations_options():
    config, _ = _cell(POOL)
    opts = refq.options(config["tool_argv"])
    assert opts["preserve-tag"] == ["XS", "YS"] and opts["record-index-tag"] == "XI"
    assert (opts["gap-opening-cost"], opts["gap-extension-cost"]) == ("0", "-1")
