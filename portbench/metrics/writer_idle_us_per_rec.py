"""Microseconds per record the writer thread waits for the main thread's
next job: the ``writer_idle`` spans of the window's calls."""


def read(run):
    if not any(c["prof"] and "writer_idle" in c["prof"] for c in run.calls):
        return None
    return run.prof_us_per_record(("writer_idle",))
