"""The share of the traced window's wall time in which no kernel, copy or
fill ran on the card."""


def read(run):
    if not run.profile:
        return None
    return 100.0 * (1.0 - run.profile["busy_s"] / run.profile["window_s"])
