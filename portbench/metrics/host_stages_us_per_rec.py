"""Microseconds per record in the fast lane's host stages, summed over its
workers: the ``[fastlane prof]`` seconds of the window's calls.  The
line's counts (``agg_dispatches``, ``agg_runs``) are not seconds and are
left out."""

STAGES = ("parse_stage", "rewrite_dispatch", "mate_project", "event_geometry", "rewrite_fetch",
          "finalize", "splice_format", "write")


def read(run):
    return run.prof_us_per_record(STAGES)
