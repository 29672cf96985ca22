"""The reduction of a profiler trace: busy time merged over overlaps, the
idle share's parts, kernel time by name, and gaps named by the host's
work.  A CPU run has no device events, so the trace is written here."""

from __future__ import annotations

import pytest

from harness import profile


def ev(name, cat, start_us, dur_us):
    return {"ph": "X", "name": name, "cat": cat, "ts": start_us, "dur": dur_us}


TRACE = {"traceEvents": [
    ev(profile.WINDOW, "user_annotation", 0, 10_000_000),
    ev(profile.CALL + "0", "user_annotation", 0, 6_000_000),
    ev(profile.CALL + "1", "user_annotation", 6_000_000, 4_000_000),
    ev("Memcpy HtoD", "gpu_memcpy", 3_000_000, 100_000),
    ev("realign_fused_kernel<0, 16, 8>", "kernel", 3_050_000, 200_000),  # overlaps the copy
    ev("realign_fused_kernel<0, 16, 8>", "kernel", 8_000_000, 50_000),
    ev("aten::copy_", "cpu_op", 8_100_000, 1_000_000),
    ev("ignored, no duration", "kernel", 0, 0) | {"ph": "i"},
]}


def test_reduce_merges_busy_time_and_names_gaps():
    out = profile.reduce(TRACE)
    assert out["window_s"] == pytest.approx(10.0)
    assert out["busy_s"] == pytest.approx(0.25 + 0.05)
    assert out["kernels"]["realign_fused_kernel<0, 16, 8>"] == pytest.approx(0.25)
    gaps = out["breakdown"]["idle_gaps"]
    assert [round(t, 3) for _, t in gaps] == [4.75, 3.0, 1.95]
    assert ", calls 0-1, between realign" in gaps[0][0]
    assert "call 0 from the first one's start" in gaps[1][0]
    assert gaps[2][0].startswith("host work outside torch ops, call 1, between")
    assert out["breakdown"]["device_ops"][0][0].startswith("realign_fused_kernel")


def test_reduce_reads_nothing_without_device_events():
    assert profile.reduce({"traceEvents": TRACE["traceEvents"][:3]}) is None
