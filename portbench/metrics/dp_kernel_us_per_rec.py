"""Microseconds per record of the DP kernels on the card (K1
``realign_fused``, K2 ``realign_fill``, the traceback
``realign_traceback``), from the profiler's trace of the window.  Zero
where no run took the device lane; nothing where the trace holds no
device event."""

KERNELS = ("realign_fused", "realign_fill", "realign_traceback")


def read(run):
    if not run.profile:
        return None
    seconds = sum(t for name, t in run.profile["kernels"].items() if any(k in name for k in KERNELS))
    return seconds / run.profile["records"] * 1e6
