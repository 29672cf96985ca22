"""The fixed cost of a call: the median wall time of whole calls on one
record of the cell, run after the window (index load, event tables,
FASTA, the engine's set-up)."""

import statistics


def read(run):
    return statistics.median(run.fixed_call_s) if run.fixed_call_s else None
