"""The port's tracer (``panvc3_tpu_torch.tracing``) on tiny fast-lane calls
on the CPU: the one ``[fastlane prof]`` line a traced call prints, as the
benchmark's harness parses it; the stage of each realign lane; the DP
runs and cells counted by lane; spans nested in their parents and tied to
their batch; nothing kept with the switch off; and the spans on the clock
of ``torch.profiler``'s trace."""

from __future__ import annotations

import bz2
import importlib.util
import io
import json
import os
import pathlib
import re
import sys
import threading

import pytest

from panvc3_tpu_torch import tracing
from panvc3_tpu_torch.pipeline import fastlane
from panvc3_tpu_torch.pipeline import project_alignments as port
from panvc3_tpu_torch.pipeline.index_msa import build_index_from_tsv
from panvc3_tpu_torch.utils import log_time

from .test_fastpath import _rich_sam

REPO = pathlib.Path(__file__).resolve().parent.parent
WORKFLOW = REPO / "workflows/test-workflow/data"
GENOME = WORKFLOW / "genome/genome.fa.gz"
PROF_LINE = re.compile(r"^\[[^]]*\] \[fastlane prof\] (.*) \(sum ([0-9.]+)s\)$", re.M)

# the realign lanes: the host C DP (forced by a cell threshold no batch
# reaches), the device lane's aggregate dispatch, its per-batch dispatch
LANES = {
    "host": {"PANVC3_HOST_DP_CELLS": str(10**18)},
    "device": {"PANVC3_HOST_DP": "0"},
    "device-per-batch": {"PANVC3_HOST_DP": "0", "PANVC3_DP_AGGREGATE": "0"},
}
SWITCHES = ("PANVC3_FASTLANE_PROF", "PANVC3_HOST_DP", "PANVC3_HOST_DP_CELLS",
            "PANVC3_DP_AGGREGATE")


def _harness_prof_stages():
    """``prof_stages`` of the benchmark's harness, which reads the line."""
    path = REPO / "portbench/harness/tool.py"
    spec = importlib.util.spec_from_file_location("portbench_harness_tool", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.prof_stages


@pytest.fixture(autouse=True)
def tracer_off_after():
    """The tracer's state is the process's: leave it off for later tests."""
    yield
    saved = os.environ.pop("PANVC3_FASTLANE_PROF", None)
    tracing.begin_call()
    if saved is not None:
        os.environ["PANVC3_FASTLANE_PROF"] = saved


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The test workflow's founder MSA indexed by the port, and 480 paired
    reads on its founders with runs to realign."""
    tmp = tmp_path_factory.mktemp("tracing")
    rows, founders = [], {}
    for line in (WORKFLOW / "index-input/input.tsv").read_text().splitlines():
        chr_id, seq_id, rel = line.split("\t")
        rows.append(f"{chr_id}\t{seq_id}\t{WORKFLOW / rel}")
        founders[seq_id] = bz2.open(WORKFLOW / rel, "rb").read()
    (tmp / "input.tsv").write_text("\n".join(rows) + "\n")
    index = tmp / "msa-index.npz"
    build_index_from_tsv(str(tmp / "input.tsv"), pipe_command="bzip2 -d -c").save(str(index))
    return index, _rich_sam(founders, n_reads=480, seed=12)


def _call(case, monkeypatch, prof: bool, lane: str = "device"):
    """One call on the CPU: (SAM bytes, statistics, the counters' deltas,
    what the call logged)."""
    index, sam = case
    # log_time binds the standard error of its import; take its lines here
    logged = io.StringIO()
    for module in (port, fastlane):
        monkeypatch.setattr(module, "log_time", lambda msg, file=None: log_time(msg, file=logged))
    for key in SWITCHES:
        monkeypatch.delenv(key, raising=False)
    for key, value in LANES[lane].items():
        monkeypatch.setenv(key, value)
    if prof:
        monkeypatch.setenv("PANVC3_FASTLANE_PROF", "1")
    cfg = port.ProjectConfig(
        msa_index_path=str(index), reference_path=str(GENOME), reference_msa_id="REF",
        ref_id_separator="/", tags=port.TagSpec(rec_idx="XI"), engine="device",
        device_batch_size=32, preserve_tags=("XA",), status_output_interval=0,
    )
    before = dict(fastlane.AGG_DIAG)
    out = io.BytesIO()
    stats = port.run_project_alignments(io.BytesIO(sam), out, cfg, device="cpu")
    delta = {k: fastlane.AGG_DIAG[k] - before[k] for k in before}
    return out.getvalue(), stats, delta, logged.getvalue()


def test_one_prof_line_per_call_that_the_harness_reads(case, monkeypatch):
    prof_stages = _harness_prof_stages()
    for _ in range(2):
        _, _, _, err = _call(case, monkeypatch, prof=True)
        lines = PROF_LINE.findall(err)
        assert len(lines) == 1 and err.count("[fastlane prof]") == 1, err
        body, total = lines[0]
        printed = [re.fullmatch(r"([a-z_0-9]+) ([0-9]+\.[0-9]{3})s", part) for part in body.split(", ")]
        assert all(printed), body
        stages = prof_stages(err)
        assert stages == {m.group(1): float(m.group(2)) for m in printed}
        assert round(sum(stages.values()), 3) == float(total)
        assert "agg_fetch_wall" not in stages and "agg_dispatches" not in stages
        assert "agg_runs" not in stages
        assert {"setup_header", "setup_index_load", "setup_entries", "setup_fasta_open",
                "setup_engine", "setup_event_tables", "bam_read", "scan_mask", "parse_stage",
                "mate_project", "event_geometry", "finalize", "splice_format", "write",
                "writer_idle"} <= set(stages)
        assert "[fastlane diag]" in err


@pytest.mark.parametrize("lane", list(LANES))
def test_each_lane_has_its_stage_and_counts_its_runs(case, monkeypatch, lane):
    _, stats, delta, err = _call(case, monkeypatch, prof=True, lane=lane)
    stages = _harness_prof_stages()(err)
    assert stats.realignment_cells > 0
    assert delta["dp_cells_host"] + delta["dp_cells_dev"] == stats.realignment_cells
    assert delta["dp_runs_host"] + delta["dp_runs_dev"] == stats.realigned_range_count
    diag = json.loads(re.search(r"\[fastlane diag\] (\{.*\})", err).group(1))
    assert diag["dp_runs_host"] == fastlane.AGG_DIAG["dp_runs_host"]
    if lane == "host":
        assert "host_dp" in stages and "realign_stage" not in stages
        assert delta["dp_runs_dev"] == delta["dp_cells_dev_launched"] == 0
    else:
        assert "realign_stage" in stages and "realign_fetch" in stages
        assert "host_dp" not in stages
        assert delta["dp_runs_host"] == 0
        # padding included: the window's rows, R and Q padded
        assert delta["dp_cells_dev_launched"] > delta["dp_cells_dev"]
        assert ("agg_pack_dispatch" in stages) == (lane == "device")
        assert (delta["dispatches"] > 0) == (lane == "device")


@pytest.mark.parametrize("lane", ["host", "device"])
def test_spans_nest_in_their_parents_and_share_their_batch(case, monkeypatch, lane):
    _call(case, monkeypatch, prof=True, lane=lane)
    call = tracing.last_call_spans()
    spans = {s["id"]: s for s in call["spans"]}
    children = [s for s in spans.values() if s["parent"] is not None]
    assert children
    for child in children:
        parent = spans[child["parent"]]
        assert parent["thread"] == child["thread"]
        assert parent["ts"] <= child["ts"]
        assert child["ts"] + child["dur"] <= parent["ts"] + parent["dur"]
    names = {(spans[s["parent"]]["name"], s["name"]) for s in children}
    # the contigs are read, and the flat reference built, where a batch
    # first wants them; the device copy where the writer first dispatches
    assert {("mate_project", "setup_reference_read"), ("mate_project", "setup_reference_flat")} <= names
    assert (("agg_pack_dispatch", "setup_reference_upload") in names) == (lane == "device")
    assert all(call["start"] <= s["ts"] and s["ts"] + s["dur"] <= call["end"]
               for s in spans.values())

    threads: dict[int, dict[str, set]] = {}
    for s in spans.values():
        if s["batch"] is not None:
            threads.setdefault(s["batch"], {}).setdefault(s["name"], set()).add(s["thread"])
    # every batch: parsed on the main thread, written by the writer
    assert len(threads) == sum(s["name"] == "parse_stage" for s in spans.values()) > 1
    dp = "host_dp" if lane == "host" else "realign_stage"
    ran_dp = 0
    for batch, by_name in threads.items():
        assert by_name["parse_stage"] == {"MainThread"}, batch
        assert by_name.get("finalize", set()) <= {f"fastlane-worker_{i}" for i in range(64)}, batch
        assert by_name["write"] == {"fastlane-writer"}, batch
        ran_dp += dp in by_name
        assert not {"host_dp", "realign_stage"} <= set(by_name)
    assert ran_dp > 0


def test_switch_off_keeps_nothing_and_writes_the_same_bytes(case, monkeypatch):
    traced, _, traced_delta, _ = _call(case, monkeypatch, prof=True)
    plain, _, plain_delta, err = _call(case, monkeypatch, prof=False)
    assert plain == traced
    assert "[fastlane prof]" not in err and "[fastlane diag]" not in err
    assert not tracing.enabled() and tracing.last_call_spans()["spans"] == []
    # the counters run either way
    assert plain_delta["dp_runs_dev"] == traced_delta["dp_runs_dev"] > 0


def test_spans_fall_inside_the_profilers_call_event(case, monkeypatch, tmp_path):
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("portbench.call.0"):
            _call(case, monkeypatch, prof=True, lane="device")
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    (event,) = [e for e in trace["traceEvents"] if e.get("name") == "portbench.call.0"]
    call = tracing.last_call_spans(trace["baseTimeNanoseconds"])
    slack_us = 2000.0
    lo, hi = event["ts"] - slack_us, event["ts"] + event["dur"] + slack_us
    assert call["spans"]
    for s in call["spans"]:
        assert lo <= s["ts"] and s["ts"] + s["dur"] <= hi, (s, event)
    assert lo <= call["start"] <= call["end"] <= hi


def test_prof_line_sums_the_seconds_it_prints(monkeypatch):
    monkeypatch.setenv("PANVC3_FASTLANE_PROF", "1")
    assert tracing.begin_call()
    for name, seconds in (("parse_stage", 0.0004), ("parse_stage", 0.0004), ("write", 1.2346),
                          ("setup_header", 0.0015)):
        tracing.add(name, 0, int(seconds * 1e9))
    with tracing.span("bam_read", batch=3) as outer:
        with tracing.span("scan_mask"):
            pass
    line = tracing.end_call()
    assert line.startswith("[fastlane prof] bam_read ")
    assert "parse_stage 0.001s, scan_mask 0.000s, setup_header 0.002s, write 1.235s" in line
    total = sum(float(v) for v in re.findall(r" ([0-9.]+)s(?:,| \()", line))
    assert line.endswith(f" (sum {total:.3f}s)")
    spans = tracing.last_call_spans()["spans"]
    (inner,) = [s for s in spans if s["name"] == "scan_mask"]
    assert inner["parent"] == outer.id and inner["batch"] is None
    monkeypatch.setenv("PANVC3_FASTLANE_PROF", "0")
    assert not tracing.begin_call()
    with tracing.span("bam_read"):
        pass
    assert tracing.span("bam_read") is tracing.span("write")
    assert tracing.stage_seconds() == {} and tracing.last_call_spans()["spans"] == []


def test_spans_from_many_threads_are_all_kept(monkeypatch):
    """Threads record spans at once, switching every microsecond: none is
    lost, ids stay unique and each nests in its own thread's parent."""
    monkeypatch.setenv("PANVC3_FASTLANE_PROF", "1")
    tracing.begin_call()
    n_threads, n_spans = 4 * (os.cpu_count() or 2), 200

    def work(k):
        for i in range(n_spans):
            with tracing.span("outer", batch=k):
                tracing.add("inner", 0, 1, batch=k)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,), name=f"t{k}") for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    spans = tracing.last_call_spans()["spans"]
    assert len(spans) == 2 * n_threads * n_spans
    by_id = {s["id"]: s for s in spans}
    assert len(by_id) == len(spans)
    for s in spans:
        if s["name"] == "inner":
            parent = by_id[s["parent"]]
            assert parent["name"] == "outer" and parent["thread"] == s["thread"] == f"t{s['batch']}"
        else:
            assert s["parent"] is None
    assert tracing.stage_seconds()["inner"] == pytest.approx(n_threads * n_spans * 1e-9)
