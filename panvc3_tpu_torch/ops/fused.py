"""The v3 fused projection engine: rewrite, indel-run detection and the
realignment DP in one dispatch.

Counterpart of ``panvc3_tpu.ops.fused.fused_projection_kernel``, in plain
PyTorch on the index's device.  In order:

1. the rewrite math over (B, R) reference units (``rewrite_math``);
2. indel-run detection with the checker's semantics: the emitted op
   stream as a token array (B, 2U+1) (each unit contributes its
   inter-position deletion run and its main op, plus a synthetic
   end-of-CIGAR break), runs recovered with prefix sums and a prefix max
   (a maximal I/D stretch between breaks is a run iff it holds both
   kinds);
3. run compaction into a fixed pool of slots (prefix-sum scatter; overflow
   is flagged so the host can fall back);
4. the gather of each run's reference and query slice (reference bytes
   dna5-normalised on the device) and the batched DP (``_dp``: K1, or K2
   and the traceback kernel under ``PANVC3_PALLAS_FUSED=0``).

The host recomputes the run bookkeeping from the collapsed CIGAR and
matches realigned runs one to one by order.  Integer scoring only; ``-q``
takes the split path.

Every lane is int32 as in the JAX version, and wraps where it does: the
packed lanes (``d_run << 4``) rely on it exactly where the overflow flags
fire.  ``torch.cumsum`` and ``torch.sum`` of int32 give int64, so they are
cast back (a modular cast, the same as int32 accumulation).  The
compaction scatter drops the unreported tokens into a spare slot
(``mode="drop"`` in JAX); on pool overflow several runs clip to the last
slot, whose content is then unspecified, and the engine discards the DP
outputs (``flags[0]``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..alphabet import dna5_normalise_device
from ..cigar import D, EQ, I, N, S, X
from .rank_select import DeviceGapIndex
from .realign_batch import _dp
from .rewrite_batch import CODE_NONE, _IS_REF_OP, _table, as_device, expand_by_delta, rewrite_math

# emitted-op classification tables (codes 0..15; the emitted stream holds
# D/I/EQ/X from reference units and I/S/H/P pass-through ops)
_CONS_REF = np.zeros(16, np.int32)
for _c in (0, EQ, X, D, N):
    _CONS_REF[_c] = 1
_CONS_QUERY = np.zeros(16, np.int32)
for _c in (0, EQ, X, I, S):
    _CONS_QUERY[_c] = 1


def _prefix_max_i(x: torch.Tensor, axis_len: int, fill: int) -> torch.Tensor:
    """Prefix max along the last axis by doubling shifts, the shifted-in
    positions holding ``fill`` (the JAX version's formulation)."""
    k = 1
    while k < axis_len:
        pad = torch.full(x.shape[:-1] + (k,), fill, dtype=x.dtype, device=x.device)
        x = torch.maximum(x, torch.cat([pad, x[..., :-k]], dim=-1))
        k <<= 1
    return x


def _i32_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.cumsum(x, dim).int()


def _i32_sum(x: torch.Tensor) -> torch.Tensor:
    return x.sum().int()


def recover_runs(tok_code, tok_len, start_ref):
    """Indel runs of a token stream (the v3 formulation, shared by v4).

    ``tok_code``/``tok_len`` int32 ``(B, T)``, the last column the
    synthetic break; ``start_ref`` int32 ``(B,)``.  Returns ``(report,
    run_start_ref, run_ref_len, run_start_query, run_query_len)``, each
    ``(B, T)``: a run is reported on the break that ends it."""
    T = tok_code.shape[1]
    dev = tok_code.device
    real = tok_len > 0
    is_i = real & (tok_code == I)
    is_d = real & (tok_code == D)
    is_break = real & ~is_i & ~is_d
    is_break[:, -1] = True  # synthetic end-of-CIGAR break

    code = tok_code.long()
    cons_ref = _table(_CONS_REF, dev)[code] * tok_len
    cons_query = _table(_CONS_QUERY, dev)[code] * tok_len
    incl_ref = _i32_cumsum(cons_ref, 1)
    incl_query = _i32_cumsum(cons_query, 1)
    incl_i = _i32_cumsum(is_i.int(), 1)
    incl_d_cnt = _i32_cumsum(is_d.int(), 1)

    # each inclusive sum at the previous break strictly before each token:
    # the sums never decrease, so that is a right-shifted prefix max of the
    # break-masked values
    stacked = torch.stack([incl_i, incl_d_cnt, incl_ref, incl_query], dim=1)
    at_break = torch.where(is_break[:, None, :], stacked, 0)
    shifted = torch.cat([torch.zeros_like(at_break[:, :, :1]), at_break[:, :, :-1]], dim=2)
    prev = _prefix_max_i(shifted, T, 0)
    g_i, g_d, g_ref, g_q = prev[:, 0], prev[:, 1], prev[:, 2], prev[:, 3]

    report = is_break & (incl_i - g_i > 0) & (incl_d_cnt - g_d > 0)
    run_start_ref = start_ref[:, None] + g_ref
    run_ref_len = (incl_ref - cons_ref) - g_ref
    run_query_len = (incl_query - cons_query) - g_q
    return report, run_start_ref, run_ref_len, g_q, run_query_len


def gather_and_align(ref_flat, query, c_sr, c_rl, c_sq, c_ql, c_rec, go, ge, run_r, run_q,
                     rec_base: int = 0):
    """The compacted runs' reference and query slices, and their DP.
    ``query`` holds the records from ``rec_base`` on (a shard's rows) and
    ``c_rec`` their batch-wide ids.  Returns ``(realign_ops,
    realign_counts, len_overflow)``."""
    dev = c_sr.device
    rr = torch.arange(run_r, dtype=torch.int32, device=dev)[None, :]
    rq = torch.arange(run_q, dtype=torch.int32, device=dev)[None, :]
    ref_len = torch.clamp(c_rl, max=run_r)
    query_len = torch.clamp(c_ql, max=run_q)
    len_overflow = _i32_sum((c_rl > run_r) | (c_ql > run_q))

    ref_idx = torch.clamp(c_sr[:, None] + rr, 0, ref_flat.shape[0] - 1)
    ref_slice = dna5_normalise_device(ref_flat[ref_idx.long()])
    ref_slice = torch.where(rr < ref_len[:, None], ref_slice, 0)

    q_idx = torch.clamp(c_sq[:, None] + rq, 0, query.shape[1] - 1)
    rec = torch.clamp(c_rec.long() - rec_base, 0, query.shape[0] - 1)
    q_slice = query[rec[:, None], q_idx.long()]
    q_slice = torch.where(rq < query_len[:, None], q_slice, 0)

    ops, counts = _dp(ref_slice, q_slice, query_len, ref_len, go, ge, run_r, run_q)
    return ops, counts, len_overflow


def _compact(idx: torch.Tensor, vals: torch.Tensor, slot_pool: int, lo: int = 0,
             hi: int | None = None) -> torch.Tensor:
    """``vals`` scattered to ``idx`` in a pool of ``slot_pool`` slots, of
    which slots ``[lo, hi)`` are returned (the whole pool by default, a
    shard's range under a mesh); an index outside them (``slot_pool`` is
    the drop index) is dropped."""
    n = (slot_pool if hi is None else hi) - lo
    idx = idx - lo
    idx = torch.where((idx >= 0) & (idx < n), idx, n)
    out = torch.zeros((n + 1,) + tuple(vals.shape[1:]), dtype=vals.dtype, device=vals.device)
    out[idx] = vals
    return out[:n]


def fused_projection_kernel(
    index: DeviceGapIndex,
    ref_flat,      # uint8[Nref]
    src_seq,       # int32[B]
    dst_seq,       # int32[B]
    rec_src_pos,   # int32[B]
    ref_off,       # int32[B]
    ops,           # int8[B, O]
    counts,        # int32[B, O]
    query,         # uint8[B, Lq]
    go,
    ge,
    R: int,        # max reference units
    U: int,        # max total units (reference units + pass-through ops)
    run_r: int,    # run reference length pad
    run_q: int,    # run query length pad
    slot_pool: int = 0,  # run-slot pool size (0: B)
):
    """One batch on the index's device (inputs are tensors or numpy arrays).
    Returns ``(dst_pos int32[B], d8 uint8[B, R], main_code int8[B, R],
    realign_ops int8[slot_pool, run_r+run_q], realign_counts
    int32[slot_pool], flags int32[3], d_run int32[B, R])``; ``flags`` is
    ``[pool + length + pack overflow, d_run >= 255 count, total runs]``."""
    dev = index.device
    ref_flat, src_seq, dst_seq, rec_src_pos, ref_off, ops, counts, query = (
        as_device(a, dev)
        for a in (ref_flat, src_seq, dst_seq, rec_src_pos, ref_off, ops, counts, query)
    )
    B = src_seq.shape[0]
    dst_pos, d_run, main_code = rewrite_math(
        index, ref_flat, src_seq, dst_seq, rec_src_pos, ref_off, ops, counts, query, R,
    )
    counts = counts.int()

    # ---- the unit stream over all units (reference + pass-through) ----
    is_ref_op = _table(_IS_REF_OP, dev)[ops.long()]
    unit_per_op = torch.where(is_ref_op, counts, 1)
    unit_pref = _i32_cumsum(unit_per_op, 1) - unit_per_op  # exclusive
    total_units = unit_pref[:, -1] + unit_per_op[:, -1]
    ref_counts = torch.where(is_ref_op, counts, 0)
    ref_pref = _i32_cumsum(ref_counts, 1) - ref_counts

    u = torch.arange(U, dtype=torch.int32, device=dev)[None, :]
    u_valid = u < total_units[:, None]

    # the per-op arrays expanded over the unit stream; ops (4 bits) and
    # is_ref (1 bit) share a lane
    per_op = torch.stack([counts, (ops.int() << 1) | is_ref_op.int()], dim=2)
    e = expand_by_delta(per_op, unit_pref, U)
    u_is_ref = ((e[:, :, 1] & 1) == 1) & u_valid
    u_count = e[:, :, 0]
    e_ops = e[:, :, 1] >> 1

    # reference unit r sits at unit position r + (non-reference units
    # before its op), itself an expansion over reference units; d_run
    # (< 2**27, else the pack flag) and main_code (4 bits) share a lane
    offs = expand_by_delta((unit_pref - ref_pref)[:, :, None], ref_pref, R)[:, :, 0]
    u_of_ref = torch.arange(R, dtype=torch.int32, device=dev)[None, :] + offs
    pack_overflow = _i32_sum(d_run >= (1 << 27))
    per_ref = (d_run << 4) | main_code.int()
    w = expand_by_delta(per_ref[:, :, None], u_of_ref, U)[:, :, 0]
    u_d = torch.where(u_is_ref, w >> 4, 0)
    u_main = torch.where(u_is_ref, w & 15, e_ops)
    u_main_len = torch.where(u_is_ref, torch.where(u_main == CODE_NONE, 0, 1), u_count)
    u_main = torch.where(u_valid, u_main, CODE_NONE)
    u_d = torch.where(u_valid, u_d, 0)
    u_main_len = torch.where(u_valid, u_main_len, 0).int()

    # ---- the token stream: [D run, main] per unit + a final break ----
    tok_code = torch.cat(
        [
            torch.stack([torch.full_like(u_main, D), u_main], dim=2).reshape(B, 2 * U),
            torch.full((B, 1), CODE_NONE, dtype=torch.int32, device=dev),
        ],
        dim=1,
    )
    tok_len = torch.cat(
        [
            torch.stack([u_d, u_main_len], dim=2).reshape(B, 2 * U),
            torch.zeros((B, 1), dtype=torch.int32, device=dev),
        ],
        dim=1,
    )
    report, run_start_ref, run_ref_len, run_start_query, run_query_len = recover_runs(
        tok_code, tok_len, dst_pos
    )

    # ---- run compaction into one slot pool, in (record, token) order ----
    if not slot_pool:
        slot_pool = B
    flat_report = report.reshape(-1)
    gslot_incl = _i32_cumsum(flat_report.int(), 0)
    total_runs = gslot_incl[-1]
    pool_overflow = (total_runs > slot_pool).int()
    scatter_idx = torch.where(
        flat_report, torch.clamp(gslot_incl - 1, 0, slot_pool - 1), slot_pool
    ).long()

    # the record's reference offset is folded in: c_sr indexes ref_flat
    rec_b = torch.arange(B, dtype=torch.int32, device=dev)[:, None].expand_as(report)
    compacted = _compact(
        scatter_idx,
        torch.stack(
            [run_start_ref + ref_off[:, None], run_ref_len, run_start_query, run_query_len, rec_b],
            dim=2,
        ).reshape(-1, 5),
        slot_pool,
    )
    c_sr, c_rl, c_sq, c_ql, c_rec = compacted.unbind(1)

    realign_ops, realign_counts, len_overflow = gather_and_align(
        ref_flat, query, c_sr, c_rl, c_sq, c_ql, c_rec, go, ge, run_r, run_q
    )
    d8 = torch.clamp(d_run, max=255).to(torch.uint8)
    d_overflow = _i32_sum(d_run >= 255)
    flags = torch.stack([pool_overflow + len_overflow + pack_overflow, d_overflow, total_runs]).int()
    return dst_pos, d8, main_code, realign_ops, realign_counts, flags, d_run
