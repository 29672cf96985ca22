"""One batched coordinate-projection step over fixed-shape tensors.

Counterpart of ``panvc3_tpu.ops.forward.projection_step``: the rewrite
math over (B, R) reference units, then the realignment DP over given
(B, run_r, run_q) run slices through the split route (the integer
substitution scores, ``fill_dispatch``, which is K2 on the card, and
``traceback_batch``, the traceback kernel on the card), then three global
statistics.  No pipeline calls it;
it is the library's one-call form of the two device stages.
"""

from __future__ import annotations

import torch

from .rank_select import DeviceGapIndex
from .realign_batch import _substitution_scores, fill_dispatch
from .realign_traceback import traceback_batch
from .rewrite_batch import CODE_NONE, as_device, rewrite_math


def projection_step(
    index: DeviceGapIndex,
    ref_flat,        # uint8[Nref]
    src_seq,         # int32[B]
    dst_seq,         # int32[B]
    rec_src_pos,     # int32[B]
    ref_off,         # int32[B]
    ops,             # int8[B, O]
    counts,          # int32[B, O]
    query,           # uint8[B, Lq]
    run_ref,         # uint8[B, run_r] realignment run reference slices
    run_query,       # uint8[B, run_q]
    run_ref_len,     # int32[B]
    run_query_len,   # int32[B]
    go,
    ge,
    R: int,
    run_r: int,
    run_q: int,
):
    """Returns ``(dst_pos, d_run, main_code, realign_ops, realign_counts,
    stats)`` for one batch on the index's device; ``stats`` is int32
    ``[emitted main ops, sum of d_run, sum of realigned op counts]``."""
    dev = index.device
    args = (ref_flat, src_seq, dst_seq, rec_src_pos, ref_off, ops, counts, query)
    dst_pos, d_run, main_code = rewrite_math(index, *(as_device(a, dev) for a in args), R)

    run_ref, run_query, run_ref_len, run_query_len = (
        as_device(a, dev) for a in (run_ref, run_query, run_ref_len, run_query_len)
    )
    sub = _substitution_scores(run_ref, run_query)
    trace = fill_dispatch(sub, run_query_len, run_ref_len, go, ge, run_r, run_q)
    realign_ops, realign_counts = traceback_batch(
        trace, run_ref, run_query, run_query_len, run_ref_len, run_r, run_q
    )
    stats = torch.stack(
        [(main_code != CODE_NONE).sum(), d_run.sum(), realign_counts.sum()]
    ).int()
    return dst_pos, d_run, main_code, realign_ops, realign_counts, stats
