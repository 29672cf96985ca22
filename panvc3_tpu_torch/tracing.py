"""Spans of one ``project_alignments`` call, and the stage totals printed
from them, under ``PANVC3_FASTLANE_PROF=1``.

``begin_call`` reads the switch at the start of each call; it is read
nowhere else.  With it off, ``span`` hands back one shared context that
does nothing and no clock is read.  With it on, each span keeps its name,
the thread it ran on, the span it nests in on that thread, a batch id
(shared by one batch's spans on every thread) and its start and end on
``time.perf_counter_ns``.  One ``(time.time_ns(), perf_counter_ns())``
pair taken at the call's start puts them on the wall clock, which is the
clock of ``torch.profiler``'s Chrome trace (an event's ``ts`` plus the
trace's ``baseTimeNanoseconds`` / 1000): ``last_call_spans`` exports the
last call's spans in those microseconds.

Spans go through no ``torch.profiler.record_function``: the profiler
records those of its own thread only, and each costs many clock reads
even with no profiler running.  The program's threads append finished spans to one
list (an atomic append); the stack of open spans is per thread.
"""

from __future__ import annotations

import itertools
import os
import threading
import time

SWITCH = "PANVC3_FASTLANE_PROF"

_on = False
_spans: list[tuple] = []  # (id, name, thread, parent id, batch, t0 ns, t1 ns)
_anchor = (0, 0)  # (time.time_ns(), perf_counter_ns()) at the call's start
_bounds = [0, 0]  # the call's start and end, perf_counter_ns
_ids = itertools.count()
_local = threading.local()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "batch", "id", "parent", "t0")

    def __init__(self, name: str, batch):
        self.name, self.batch = name, batch

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        stack.append(self.id)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        _stack().pop()
        _spans.append((self.id, self.name, threading.current_thread().name,
                       self.parent, self.batch, self.t0, t1))
        return False


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def begin_call() -> bool:
    """Reads the switch, forgets the last call's spans and takes the clock
    anchor; True where the call is traced."""
    global _on, _spans, _anchor
    _on = os.environ.get(SWITCH) == "1"
    _spans = []
    _local.stack = []
    if _on:
        _anchor = (time.time_ns(), time.perf_counter_ns())
        _bounds[:] = [_anchor[1], _anchor[1]]
    return _on


def enabled() -> bool:
    return _on


def span(name: str, batch=None):
    """A context that records ``name`` over its block, nested in the span
    open on this thread; nothing when the call is not traced."""
    return _Span(name, batch) if _on else _OFF


def add(name: str, t0: int, t1: int, batch=None) -> None:
    """Records a span timed by the caller (``perf_counter_ns``), nested in
    the span open on this thread.  Call it only where ``enabled()``."""
    stack = _stack()
    _spans.append((next(_ids), name, threading.current_thread().name,
                   stack[-1] if stack else None, batch, t0, t1))


def stage_seconds() -> dict[str, float]:
    """The seconds of each span name in the call, summed over threads."""
    out: dict[str, float] = {}
    for _, name, _, _, _, t0, t1 in list(_spans):
        out[name] = out.get(name, 0.0) + (t1 - t0) / 1e9
    return out


def end_call() -> str:
    """Marks the traced call's end and returns its ``[fastlane prof]``
    line: each stage's seconds, then their sum (of the values as
    printed)."""
    _bounds[1] = time.perf_counter_ns()
    shown = [(name, f"{sec:.3f}") for name, sec in sorted(stage_seconds().items())]
    total = sum(float(v) for _, v in shown)
    return ("[fastlane prof] " + ", ".join(f"{name} {v}s" for name, v in shown)
            + f" (sum {total:.3f}s)")


def last_call_spans(base_time_ns: int = 0) -> dict:
    """The last traced call on the wall clock, in microseconds after
    ``base_time_ns`` (a Chrome trace's ``baseTimeNanoseconds`` puts them
    on its ``ts``): ``{"start", "end", "spans"}``, each span a dict of
    ``name``, ``thread``, ``id``, ``parent``, ``batch``, ``ts`` and
    ``dur``."""
    wall, pc = _anchor

    def us(t):
        return (wall + (t - pc) - base_time_ns) / 1000.0

    spans = [
        {"name": name, "thread": thread, "id": sid, "parent": parent, "batch": batch,
         "ts": us(t0), "dur": (t1 - t0) / 1000.0}
        for sid, name, thread, parent, batch, t0, t1 in sorted(_spans, key=lambda s: s[5])
    ]
    return {"start": us(_bounds[0]), "end": us(_bounds[1]), "spans": spans}
