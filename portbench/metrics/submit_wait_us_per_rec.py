"""Microseconds per record the main thread waits on the writer: the
``submit_wait`` spans of the window's calls (blocked handing a batch's job
to the full queue, and at the end for the writer to drain)."""


def read(run):
    if not any(c["prof"] and "submit_wait" in c["prof"] for c in run.calls):
        return None
    return run.prof_us_per_record(("submit_wait",))
