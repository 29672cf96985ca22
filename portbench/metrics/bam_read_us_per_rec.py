"""Microseconds per record on the main thread reading the input: the
``bam_read`` (BGZF inflate and conversion to SAM text) and ``scan_mask``
(the keep-mask scan) spans of the window's calls."""


def read(run):
    if not any(c["prof"] and "bam_read" in c["prof"] for c in run.calls):
        return None
    return run.prof_us_per_record(("bam_read", "scan_mask"))
