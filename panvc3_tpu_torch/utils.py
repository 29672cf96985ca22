"""Observability: periodic status output and timestamped log lines (copy
of ``panvc3_tpu.utils``, trimmed to what the port calls)."""

from __future__ import annotations

import resource
import sys
import time


def log_time(msg: str, file=sys.stderr) -> None:
    """Timestamped stderr line (libbio lb::log_time convention)."""
    ts = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime())
    print(f"[{ts}] {msg}", file=file, flush=True)


def format_duration(seconds: float) -> str:
    s = int(seconds)
    h, s = divmod(s, 3600)
    m, s = divmod(s, 60)
    if h:
        return f"{h} h {m} min {s} s"
    if m:
        return f"{m} min {s} s"
    return f"{s} s"


class StatusReporter:
    """Interval-based progress reporting from the record loop.

    The reference uses a timer thread; here the hot loop calls ``tick()``
    (cheap clock check) and the report fires when the interval has elapsed.
    ``interval_minutes=0`` disables reporting, like the reference's
    ``--status-output-interval=0``.
    """

    def __init__(self, interval_minutes: int, what: str = "records"):
        self.interval = interval_minutes * 60.0
        self.what = what
        self.start = time.monotonic()
        self.last = self.start
        self.extra_cb = None

    def tick(self, n_processed: int) -> None:
        if not self.interval:
            return
        now = time.monotonic()
        if now - self.last < self.interval:
            return
        self.last = now
        elapsed = now - self.start
        msg = f"Time spent processing: {format_duration(elapsed)}; processed {n_processed} {self.what}"
        if n_processed:
            usecs = elapsed * 1e6 / n_processed
            msg += f" (in {usecs:.2f} µs / record)"
        if self.extra_cb is not None:
            msg += self.extra_cb()
        log_time(msg + ".")

    def final(self, n_processed: int) -> None:
        elapsed = time.monotonic() - self.start
        msg = f"Done; processed {n_processed} {self.what} in {format_duration(elapsed)}"
        if n_processed and elapsed > 0:
            msg += f" ({n_processed / elapsed:.0f} {self.what}/s)"
        log_time(msg + ".")


def log_peak_memory(file=sys.stderr) -> int:
    """Log and return the process's peak resident set size in bytes (the
    role of libbio's log_memory_usage)."""
    kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    print(f"Peak RSS: {kb / 1024:.1f} MiB", file=file, flush=True)
    return kb * 1024
