"""Nanoseconds per DP cell in the host C DP lane under ``-q``: the
``host_dp`` span of the window's calls (``[fastlane prof]``: the staging
of a batch's runs, the quantised Malde DP and the lane's return) over the
counter ``dp_cells_host`` (rl x ql of each run the host lane realigned,
``fastlane.AGG_DIAG``, per call).  Nothing where no call printed the
stage or the host lane realigned no run."""


def read(run):
    calls = [c for c in run.calls if c["prof"] and "host_dp" in c["prof"]]
    cells = sum(c["counters"].get("dp_cells_host", 0) for c in calls)
    if not cells:
        return None
    return sum(c["prof"]["host_dp"] for c in calls) / cells * 1e9
