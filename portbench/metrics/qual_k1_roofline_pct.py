"""K1's quality entry (``realign_fused_qual``, the kernel
``realign_fused_kernel<1, ...>`` in the trace) against its roofline: the
least time the card could take for the cells the window's device-lane
dispatches launched, over the kernel's device time in the traced window.

The cells are the counter ``dp_cells_dev_launched`` (each dispatch's rows
x padded R x padded Q, ``fastlane.AGG_DIAG``, per call); under ``-q``
every device-lane dispatch launches this entry.  The peaks are the H100's
(SXM, 700 W) as the port's kernel table takes them: 33.5 T f32 op/s (the
published 67 TFLOP/s counts an FMA as two; K1's operations are unfused)
and 3.35 TB/s.  Nothing where the window launched no quality K1."""

KERNEL = "realign_fused_kernel<1,"
OPS_PER_S = 33.5e12
BYTES_PER_S = 3.35e12
# a DP cell: the recurrence's 9 adds and maxes and the compares that
# make its trace bits (realign_fused.cu)
OPS_PER_CELL = 12
# a run of R x Q cells reads ref R, query Q and int32 phreds 4Q bytes and
# two int32 lengths, and writes R + Q op bytes and an int32 count: at
# most 76 bytes for the 64 cells of the smallest pad (8 x 8), so the
# bytes never set the bound
BYTES_PER_CELL = 76 / 64


def operations(cells: int) -> float:
    return OPS_PER_CELL * cells


def bytes_moved(cells: int) -> float:
    return BYTES_PER_CELL * cells


def read(run):
    if not run.profile:
        return None
    seconds = sum(t for name, t in run.profile["kernels"].items() if KERNEL in name)
    cells = sum(c["counters"].get("dp_cells_dev_launched", 0) for c in run.calls)
    if not seconds or not cells:
        return None
    bound = max(operations(cells) / OPS_PER_S, bytes_moved(cells) / BYTES_PER_S)
    return 100.0 * bound / seconds
