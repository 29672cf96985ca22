"""Microseconds per record the writer thread waits on the workers: the
``writer_wait`` spans of the window's calls (blocked on the result of the
job at the head of the ordered drain)."""


def read(run):
    if not any(c["prof"] and "writer_wait" in c["prof"] for c in run.calls):
        return None
    return run.prof_us_per_record(("writer_wait",))
