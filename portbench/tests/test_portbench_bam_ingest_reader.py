"""The reader of the BAM ingest's span, on hand-built runs: the value
worked out by hand, and nothing where no call printed the span (as a
program without the ingest prints none)."""

from __future__ import annotations

import run as portbench_run

METRIC = "bam_ingest_us_per_rec"


def call(records, prof):
    return {"records": records, "prof": prof, "counters": {}}


def hand_run(calls):
    run = portbench_run.Run()
    run.calls = calls
    return run


def test_reader_gives_the_ingest_seconds_per_record(real_spec):
    run = hand_run([
        call(2_000_000, {"bam_ingest": 1.25, "bam_read": 0.5, "mate_project": 1.0}),
        call(6_000_000, {"bam_ingest": 2.75, "bam_read": 0.25}),
    ])
    assert real_spec.reader(METRIC)(run) == (1.25 + 2.75) / 8e6 * 1e6


def test_reader_gives_nothing_without_the_span(real_spec):
    parent = hand_run([call(2_000_000, {"bam_read": 3.5, "scan_mask": 0.4, "parse_stage": 2.0}),
                       call(2_000_000, None)])
    assert real_spec.reader(METRIC)(parent) is None
    assert real_spec.reader(METRIC)(hand_run([call(1000, None)])) is None
