"""The share of the window's realigned runs that the lane controller sent
to the device lane: the counters ``dp_runs_dev`` over ``dp_runs_dev`` +
``dp_runs_host`` (``fastlane.AGG_DIAG``, per call)."""


def read(run):
    dev = sum(c["counters"].get("dp_runs_dev", 0) for c in run.calls)
    host = sum(c["counters"].get("dp_runs_host", 0) for c in run.calls)
    return 100.0 * dev / (dev + host) if dev + host else None
