"""Microseconds per record on the BAM ingest's thread: the ``bam_ingest``
span of the window's calls (``[fastlane prof]``), from the compressed
read through BGZF inflate, record decode and the cut to the staged batch.
Nothing where no call printed the stage."""


def read(run):
    if not any(c["prof"] and "bam_ingest" in c["prof"] for c in run.calls):
        return None
    return run.prof_us_per_record(("bam_ingest",))
