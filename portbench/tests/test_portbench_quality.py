"""The ``-q`` cell's readers on hand-built runs (each gives the value
worked out by hand, and nothing where the run lacks what it reads), and a
whole run of the cell on the CPU at a tiny size against its plain
reference."""

from __future__ import annotations

import pytest
from conftest import run_tiny

import run as portbench_run

# K1's kernels as the profiler names them, cut to the harness's 100
# characters: the quality entry and the integer one
K1_QUAL = "void (anonymous namespace)::realign_fused_kernel<1, 4, 12>(unsigned char const*, unsigned char const*, in"
K1_INT = "void (anonymous namespace)::realign_fused_kernel<0, 4, 12>(unsigned char const*, unsigned char const*, in"


def call(records, prof, counters):
    return {"records": records, "prof": prof, "counters": counters}


def hand_run(calls, kernels=None):
    run = portbench_run.Run()
    run.calls = calls
    if kernels is not None:
        run.profile = {"busy_s": 0.01, "window_s": 60.0, "kernels": kernels, "records": 0}
    return run


RUN = hand_run(
    [call(8_000_000, {"host_dp": 1.5, "realign_stage": 0.1},
          {"dp_cells_host": 6_000_000, "dp_cells_dev_launched": 30_000_000}),
     call(8_000_000, {"host_dp": 0.5}, {"dp_cells_host": 4_000_000,
                                       "dp_cells_dev_launched": 10_000_000})],
    {K1_QUAL: 0.004, K1_INT: 1.0, "Memcpy HtoD (Pageable -> Device)": 0.03},
)

BY_HAND = {
    # host_dp seconds over the host lane's cells, in nanoseconds
    "qual_host_dp_ns_per_cell": (1.5 + 0.5) / 10_000_000 * 1e9,
    # 40 M launched cells at 12 operations and 33.5 T op/s (the bytes, at
    # most 76 / 64 a cell at 3.35 TB/s, take less) over 4 ms of the
    # quality entry; the integer entry's time is not its
    "qual_k1_roofline_pct": 100.0 * (12 * 40_000_000 / 33.5e12) / 0.004,
}


@pytest.mark.parametrize("metric", list(BY_HAND))
def test_reader_gives_the_value_by_hand(real_spec, metric):
    assert real_spec.reader(metric)(RUN) == pytest.approx(BY_HAND[metric], rel=1e-12)


@pytest.mark.parametrize("metric", list(BY_HAND))
def test_reader_gives_nothing_from_an_empty_run(real_spec, metric):
    assert real_spec.reader(metric)(hand_run([])) is None
    assert real_spec.reader(metric)(hand_run([call(1000, None, {})], {})) is None


def test_roofline_reads_nothing_without_a_quality_k1():
    """Integer scoring's K1 alone, or no cells launched: nothing."""
    from harness.spec import _load
    from conftest import BENCH

    read = _load(BENCH / "metrics" / "qual_k1_roofline_pct.py", "qual_k1_roofline_pct_test").read
    integer_only = hand_run([call(1000, None, {"dp_cells_dev_launched": 5000})], {K1_INT: 0.001})
    assert read(integer_only) is None
    no_cells = hand_run([call(1000, None, {"dp_cells_host": 5000})], {K1_QUAL: 0.001})
    assert read(no_cells) is None


def test_host_dp_per_cell_reads_nothing_where_the_host_lane_took_no_run(real_spec):
    only_device = hand_run([call(1000, {"host_dp": 0.0, "realign_stage": 0.2},
                                 {"dp_cells_dev": 900, "dp_cells_dev_launched": 9000})])
    assert real_spec.reader("qual_host_dp_ns_per_cell")(only_device) is None


def test_quality_cell_is_correct_at_a_tiny_size(tiny_root):
    """The ``-q`` cell through the harness on the CPU, traced: its plain
    reference finds every sampled line right, and the host lane's reader
    reads its span and counter."""
    rc, result, err = run_tiny(tiny_root, "chr21_f4_q.test_pairs", 2**31 + 4401, 1)
    assert rc == 0, err[-3000:]
    assert result["correct"] is True, err[-3000:]
    assert result["checks"]["sampled_lines_compared"]["value"] > 1000
    assert "qual_host_dp_ns_per_cell" in result["metrics"], result["metrics"]
    assert "qual_bytes_dev" in err and "qual_runs_off_host" in err
