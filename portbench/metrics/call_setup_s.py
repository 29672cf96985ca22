"""A call's set-up as the program times it: the median over the window's
calls of the sum of their ``setup_*`` spans (``[fastlane prof]``): header,
index load, sequence entries, FASTA, engine, event tables, and the
reference contigs read, flattened and uploaded inside the stream.  The
in-program counterpart of ``call_fixed_s``."""

import statistics


def read(run):
    sums = [sum(v for k, v in c["prof"].items() if k.startswith("setup_"))
            for c in run.calls if c["prof"] and any(k.startswith("setup_") for k in c["prof"])]
    return statistics.median(sums) if sums else None
