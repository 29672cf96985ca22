"""The share of the DP cells the device lane's kernels compute that belong
to a run: the counters ``dp_cells_dev`` (rl x ql of each run) over
``dp_cells_dev_launched`` (each dispatch's rows x padded R x padded Q),
summed over the window's calls."""


def read(run):
    real = sum(c["counters"].get("dp_cells_dev", 0) for c in run.calls)
    launched = sum(c["counters"].get("dp_cells_dev_launched", 0) for c in run.calls)
    return 100.0 * real / launched if launched else None
