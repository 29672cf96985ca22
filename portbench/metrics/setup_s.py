"""Seconds from the run's start to the window's start: imports, the CUDA
context, the kernels (built on a checkout's first run), the inputs and
the warm-up call."""


def read(run):
    return run.setup_s
