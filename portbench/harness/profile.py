"""The window of a traced run under ``torch.profiler``, reduced to what the
readers take.

The whole window is traced, and not one call of it: the realign lanes'
controller may send every run of a call to the host lane, and over a
window it still probes the device lane.  The trace's device events
(kernels, copies, fills) give the seconds in which an operation ran on the
card, merged where they overlap, and each kernel's time by name.  The time
between them, from the window's start to its end, is the device's idle
time; each of the longest idle gaps is named by what the host was doing:
the host operation that ran across it, or else the calls it spans (and
whether it starts with a call's set-up) and the device operations around
it.
"""

from __future__ import annotations

import contextlib
import json
import pathlib

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "portbench.window"
CALL = "portbench.call."
TOP = 10
NAME_CHARS = 100  # kernel names carry their whole signature; keep the head
SETUP_SLACK_S = 0.5  # a gap that starts this soon after a call's start is its set-up


def events(trace: dict):
    """(the window's span, the calls' spans, device events, host events) of
    a Chrome trace, each event (name, start, end) in seconds."""
    window, calls, device, host = None, [], [], []
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        span = (ev["name"][:NAME_CHARS], ev["ts"] / 1e6, (ev["ts"] + ev["dur"]) / 1e6)
        cat = ev.get("cat", "")
        if cat in DEVICE_CATEGORIES:
            device.append(span)
        elif ev["name"] == WINDOW:
            window = span[1:]
        elif ev["name"].startswith(CALL):
            calls.append(span)
        elif cat == "cpu_op":
            host.append(span)
    return window, sorted(calls, key=lambda c: c[1]), device, host


def merged(spans) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for start, end in sorted((s, e) for _, s, e in spans):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(s, e) for s, e in out]


def reduce(trace: dict) -> dict | None:
    """``busy_s``, ``window_s``, ``kernels`` (seconds by name) and the
    ``breakdown`` of a traced window; None where the trace holds no device
    event."""
    window, calls, device, host = events(trace)
    if window is None or not device:
        return None
    start, end = window
    busy = merged((n, max(s, start), min(e, end)) for n, s, e in device if e > start and s < end)
    by_name: dict[str, float] = {}
    for name, s, e in device:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    edges = [start] + [x for span in busy for x in span] + [end]
    gaps = sorted(((hi - lo, lo, hi) for lo, hi in zip(edges[0::2], edges[1::2]) if hi > lo),
                  reverse=True)[:TOP]
    return {
        "busy_s": sum(e - s for s, e in busy),
        "window_s": end - start,
        "kernels": by_name,
        "breakdown": {
            "device_ops": sorted(([n, t] for n, t in by_name.items()), key=lambda x: -x[1])[:TOP],
            "idle_gaps": [[_name_gap(lo, hi, calls, host, device), t] for t, lo, hi in gaps],
        },
    }


def _name_gap(lo, hi, calls, host, device) -> str:
    across = [n for n, s, e in host if s <= lo and e >= hi]
    if across:
        return f"host op {across[-1]}"
    spanned = [(name[len(CALL):], s) for name, s, e in calls if s - SETUP_SLACK_S <= hi and e > lo]
    where = "between calls"
    if spanned:
        first, s = spanned[0]
        where = f"call {first}" if len(spanned) == 1 else f"calls {first}-{spanned[-1][0]}"
        if abs(lo - s) < SETUP_SLACK_S:
            where += " from the first one's start (index, event tables, FASTA)"
    before = max(((e, n) for n, s, e in device if e <= lo), default=None)
    after = min(((s, n) for n, s, e in device if s >= hi), default=None)
    left = before[1][:60] if before else "the window's start"
    right = after[1][:60] if after else "the window's end"
    return f"host work outside torch ops, {where}, between {left} and {right}"


@contextlib.contextmanager
def traced(path: pathlib.Path, result: dict):
    """Profile the block as the window; fills ``result`` with ``reduce``'s
    output (or leaves it empty) once the block ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            yield
    prof.export_chrome_trace(str(path))
    reduced = reduce(json.loads(path.read_text()))
    path.unlink()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    if reduced:
        result.update(reduced)


def call_span(n: int):
    """The span of the window's call ``n`` in the trace."""
    from torch.profiler import record_function

    return record_function(f"{CALL}{n}")
