"""Records written per second of the window: every record of every whole
call the window ran, over the window's wall time, so each call's fixed
cost is inside it, as it is for a user."""


def read(run):
    return run.records / run.window_s if run.window_s > 0 and run.records else None
