"""Microseconds per record in the host C DP lane: the ``host_dp`` span of
the window's calls (``[fastlane prof]``), from the staging of a batch's
runs to the lane's return, summed over the workers.  Nothing where no
call printed the stage."""


def read(run):
    if not any(c["prof"] and "host_dp" in c["prof"] for c in run.calls):
        return None
    return run.prof_us_per_record(("host_dp",))
