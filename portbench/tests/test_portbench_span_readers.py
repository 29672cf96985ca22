"""The readers of the program's spans and counters, on a hand-built run:
each gives the value worked out by hand, and nothing where the window's
calls lack what it reads (as a program without those spans and counters
prints no such stage and counts no such run)."""

from __future__ import annotations

import pytest

import run as portbench_run

NEW = ("host_dp_us_per_rec", "call_setup_s", "event_tables_s", "bam_read_us_per_rec",
       "submit_wait_us_per_rec", "writer_idle_us_per_rec", "writer_wait_us_per_rec",
       "device_lane_runs_pct", "dp_cell_fill_pct")


def call(records, prof, counters):
    return {"records": records, "prof": prof, "counters": counters}


def hand_run(calls):
    run = portbench_run.Run()
    run.calls = calls
    return run


RUN = hand_run([
    call(1_000_000,
         {"setup_header": 0.1, "setup_index_load": 0.5, "setup_event_tables": 2.0,
          "setup_reference_read": 0.25, "parse_stage": 1.0, "host_dp": 3.0, "bam_read": 1.5,
          "scan_mask": 0.5, "submit_wait": 0.2, "writer_idle": 4.0, "writer_wait": 1.0},
         {"dp_runs_host": 300, "dp_runs_dev": 100, "dp_cells_host": 9000, "dp_cells_dev": 3000,
          "dp_cells_dev_launched": 12000}),
    call(3_000_000,
         {"setup_header": 0.1, "setup_index_load": 0.7, "setup_event_tables": 3.0,
          "host_dp": 1.0, "bam_read": 2.5, "scan_mask": 1.5, "submit_wait": 0.6,
          "writer_idle": 2.0, "writer_wait": 3.0},
         {"dp_runs_host": 100, "dp_cells_host": 1000}),
    call(4_000_000,
         {"setup_header": 0.2, "setup_index_load": 0.6, "setup_event_tables": 2.5,
          "bam_read": 4.0, "submit_wait": 0.2, "writer_idle": 2.0, "writer_wait": 4.0},
         {"dp_runs_dev": 200, "dp_cells_dev": 6000, "dp_cells_dev_launched": 24000}),
])

BY_HAND = {
    # stage seconds over the window's 8,000,000 records, in microseconds
    "host_dp_us_per_rec": (3.0 + 1.0) / 8e6 * 1e6,
    "bam_read_us_per_rec": (1.5 + 0.5 + 2.5 + 1.5 + 4.0) / 8e6 * 1e6,
    "submit_wait_us_per_rec": (0.2 + 0.6 + 0.2) / 8e6 * 1e6,
    "writer_idle_us_per_rec": (4.0 + 2.0 + 2.0) / 8e6 * 1e6,
    "writer_wait_us_per_rec": (1.0 + 3.0 + 4.0) / 8e6 * 1e6,
    # medians over calls: set-up sums 2.85, 3.8, 3.3; event tables 2.0, 3.0, 2.5
    "call_setup_s": 3.3,
    "event_tables_s": 2.5,
    # counters summed over calls: runs 300 dev of 700; cells 9000 of 36000
    "device_lane_runs_pct": 100.0 * 300 / 700,
    "dp_cell_fill_pct": 100.0 * 9000 / 36000,
}


@pytest.mark.parametrize("metric", NEW)
def test_reader_gives_the_value_by_hand(real_spec, metric):
    assert real_spec.reader(metric)(RUN) == pytest.approx(BY_HAND[metric], rel=1e-12)


# what a program without the spans and counters prints and counts: the
# stages of the [fastlane prof] line before them, and no dp_* counter
PARENT_RUN = hand_run([
    call(2_000_000, {"parse_stage": 1.0, "realign_stage": 0.1, "agg_pack_dispatch": 0.1,
                     "agg_dispatches": 5.0, "agg_runs": 11000.0}, {"dispatches": 5, "wire2": 5}),
    call(2_000_000, {"parse_stage": 1.1, "write": 2.0}, {"dispatches": 4}),
])


@pytest.mark.parametrize("metric", NEW)
def test_reader_gives_nothing_without_its_spans_or_counters(real_spec, metric):
    assert real_spec.reader(metric)(PARENT_RUN) is None
    assert real_spec.reader(metric)(hand_run([call(1000, None, {})])) is None


def test_device_lane_share_reads_zero_where_the_host_took_every_run(real_spec):
    only_host = hand_run([call(1000, {"host_dp": 0.5}, {"dp_runs_host": 40, "dp_cells_host": 900})])
    assert real_spec.reader("device_lane_runs_pct")(only_host) == 0.0
    assert real_spec.reader("dp_cell_fill_pct")(only_host) is None
