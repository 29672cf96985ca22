"""The v4 fused projection engine: event-geometry rewrite, run detection in
segment space and the realignment DP in one dispatch.

Counterpart of ``panvc3_tpu.ops.fused_event._fused_event_body`` and
``make_fused_event_kernel``, in plain PyTorch on the geometry's device.
Nothing in it is proportional to read length but the run slices of the
DP:

1. **rewrite**: the per-pair MSA-difference event tables
   (``DeviceEventGeometry.slots``) give the initial position and each
   record's overlapping gap and deletion events;
2. **run detection**: the emitted op stream is piecewise constant between
   op boundaries and event endpoints, so the indel-run checker runs over
   a merged list of O + 2*KG + K boundaries: they are rank-sorted by one
   comparison-count matrix, the segments' attributes decode by masked
   sums, and the v3 token-stream run recovery (``fused.recover_runs``)
   runs on that short axis;
3. **DP**: per-record then cross-record run compaction, the slice gathers
   and ``_dp``, as the v3 engine (``fused.gather_and_align``).

The =/X comparison is not made on the device: the engine returns the
event wire (dst_pos, gap bitmask, sparse deletion runs) and the host
rebuilds =/X; run detection does not depend on it.

Fallbacks: event-slot or width overflow (``flags[1]``) makes the rewrite
itself invalid, and the engine re-dispatches the batch through the v3
engine; run-pool or length overflow (``flags[0]``) keeps the wire
outputs and realigns on the host path.

The JAX version's ``_stage`` argument (truncate after stage N) serves a
TPU profiling tool and is left out.  Lanes are int32 and wrap as in JAX
(``fused`` says how); the rank-sort scatter has unique indices per row.
"""

from __future__ import annotations

import functools

import torch

from ..cigar import D, EQ, I
from .fused import _compact, _i32_cumsum, _i32_sum, gather_and_align, recover_runs
from .rewrite_batch import CODE_NONE, _IS_MTYPE_OP, _IS_REF_OP, _table, as_device

# boundary tie priorities at one unit position: a gap run ending at u stops
# covering before anything else at u, a gap run starting at u covers
# everything at u, deletion tokens precede the unit's main token, op
# segments come last (zero-length segments make the rest of the order moot)
_PR_GAP_OFF = 0
_PR_GAP_ON = 1
_PR_DEL = 2
_PR_OP = 3

_COUNT_BITS = 26  # op counts pack into attr bits [5, 31)


def _fused_event_body(
    geo,
    ref_flat,      # uint8[Nref] (DP slices only)
    ref_ids,       # int32[B] input reference id per record
    rec_src_pos,   # int32[B]
    n_ref_units,   # int32[B]
    ref_off,       # int32[B]
    ops,           # int8[B, O]
    counts,        # int32[B, O]
    query,         # uint8[B, Lq] dna5-normalised
    go,
    ge,
    R: int,
    run_r: int,
    run_q: int,
    slot_pool: int,
):
    """One batch on ``geo``'s device.  Returns ``(initial int32[B],
    gapbits uint8[B, R/8], d_vals, d_pos8 uint8[B, K], d_n8 uint8[B],
    realign_ops int8[slot_pool, run_r+run_q], realign_counts
    int32[slot_pool], flags int32[3])``; ``flags`` is ``[run pool +
    length + count overflow, event overflow, total runs]``."""
    dev = geo.device
    ref_flat, ref_off, ops, counts, query = (
        as_device(a, dev) for a in (ref_flat, ref_off, ops, counts, query)
    )
    B, O = ops.shape
    counts = counts.int()

    # ---- the event rewrite (fixed-trip searches, no unit gathers) ----
    initial, ga, gb, _gcnt, d_rel, d_len, dcnt, ov_slots = geo.slots(
        ref_ids, rec_src_pos, n_ref_units, R
    )
    ga, gb, d_rel, d_len, dcnt = (t.int() for t in (ga, gb, d_rel, d_len, dcnt))
    # the effective slot widths (geo.effective_slots(R)) size every lattice
    # below
    KG = ga.shape[1]
    K = d_rel.shape[1]
    # the host wire (the split path's layout)
    gapbits = geo.pack_isgap(ga, gb, R)
    d_vals = torch.clamp(d_len, max=255).to(torch.uint8)
    d_pos8 = torch.clamp(d_rel, max=255).to(torch.uint8)
    d_n8 = torch.clamp(dcnt, max=255).to(torch.uint8)
    ev_overflow = (ov_slots + _i32_sum(d_len >= 255) + (1 if R > 255 else 0)).int()

    # ---- boundaries in unit space ----
    code = ops.long()
    is_ref_op = _table(_IS_REF_OP, dev)[code]
    real_op = ops != CODE_NONE
    unit_per_op = torch.where(real_op, torch.where(is_ref_op, counts, 1), 0)
    unit_pref = _i32_cumsum(unit_per_op, 1) - unit_per_op  # exclusive
    total_units = unit_pref[:, -1] + unit_per_op[:, -1]
    ref_counts = torch.where(is_ref_op & real_op, counts, 0)
    ref_pref = _i32_cumsum(ref_counts, 1) - ref_counts

    # unit position of reference rank x: x + the pass-through ops before it
    # (each one unit, before x iff its exclusive reference prefix <= x)
    xs = torch.cat([ga, gb, d_rel], dim=1)  # (B, 2KG+K)
    pass_op = (real_op & ~is_ref_op).int()
    offs = (pass_op[:, None, :] * (ref_pref[:, None, :] <= xs[:, :, None]).int()).sum(2).int()
    gvalid = ga <= gb
    dvalid = d_len > 0
    BIG = R + O + 2  # past every real unit

    pos_on = torch.where(gvalid, ga + offs[:, :KG], BIG)
    pos_off = torch.where(gvalid, gb + offs[:, KG:2 * KG] + 1, BIG)
    pos_del = torch.where(dvalid, d_rel + offs[:, 2 * KG:], BIG)
    pos_op = torch.where(real_op, unit_pref, BIG)

    NB = O + 2 * KG + K

    def lanes(*parts):
        return torch.cat([p.int() for p in parts], dim=1)

    def full(n, v):
        return torch.full((B, n), v, dtype=torch.int32, device=dev)

    pos_all = lanes(pos_op, pos_on, pos_off, pos_del)
    pr_all = lanes(full(O, _PR_OP), full(KG, _PR_GAP_ON), full(KG, _PR_GAP_OFF), full(K, _PR_DEL))
    onoff_all = lanes(full(O, 0), gvalid, -gvalid.int(), full(K, 0))
    dlen_all = lanes(full(O + 2 * KG, 0), torch.where(dvalid, d_len, 0))

    # a stable rank sort by one comparison-count matrix (NB ~ 40)
    keys = pos_all * 4 + pr_all
    tri = torch.ones((NB, NB), dtype=torch.bool, device=dev).tril(-1)
    rank = (
        (keys[:, None, :] < keys[:, :, None])
        | ((keys[:, None, :] == keys[:, :, None]) & tri[None, :, :])
    ).sum(2)
    packed = (pos_all << 2) | (onoff_all + 1)  # position and on/off share a lane
    sorted_packed = torch.zeros_like(packed).scatter_(1, rank, packed)
    sorted_dlen = torch.zeros_like(dlen_all).scatter_(1, rank, dlen_all)
    sorted_pos = sorted_packed >> 2
    sorted_onoff = (sorted_packed & 3) - 1

    covered = torch.cumsum(sorted_onoff, dim=1) > 0

    tu = total_units[:, None]
    seg_s = torch.minimum(sorted_pos, tu)
    seg_e = torch.minimum(torch.cat([sorted_pos[:, 1:], full(1, BIG)], dim=1), tu)
    n_seg = torch.clamp(seg_e - seg_s, min=0)

    # the owning op's attributes by one masked sum; count, op code and
    # is-reference share an int32 lane
    cnt_overflow = _i32_sum(counts >= (1 << _COUNT_BITS))
    attr = torch.where(real_op, (counts << 5) | (ops.int() << 1) | is_ref_op.int(), 0)
    owns = (unit_pref[:, None, :] <= seg_s[:, :, None]) & (
        seg_s[:, :, None] < (unit_pref + unit_per_op)[:, None, :]
    )
    seg_attr = torch.where(owns, attr[:, None, :], 0).sum(2).int()
    seg_cnt = seg_attr >> 5
    seg_opc = (seg_attr >> 1) & 15
    seg_isref = (seg_attr & 1) == 1

    seg_mtype = _table(_IS_MTYPE_OP, dev)[seg_opc.long()] & seg_isref
    # the rewrite per reference unit: M-type -> I on a dst gap, else =/X
    # (EQ stands in: =/X break runs alike and the host rebuilds them); D/N
    # -> dropped on a dst gap, else D
    main_code = torch.where(
        seg_isref,
        torch.where(
            seg_mtype,
            torch.where(covered, I, EQ),
            torch.where(covered, CODE_NONE, D),
        ),
        seg_opc,
    ).int()
    # A pass-through op is gated on its segment's width: a boundary on the
    # op's own unit position makes a zero-length segment that `owns` still
    # gives to the op, and emitting it there would duplicate the op.  The
    # op's own segment always has n_seg >= 1 (_PR_OP sorts last at its
    # position), so exactly one copy survives.
    main_len = torch.where(
        seg_isref,
        torch.where(main_code == CODE_NONE, 0, n_seg),
        torch.where(n_seg > 0, seg_cnt, 0),
    ).int()

    # ---- the token stream and run recovery (the v3 formulation) ----
    tok_code = torch.cat(
        [torch.stack([full(NB, D), main_code], dim=2).reshape(B, 2 * NB), full(1, CODE_NONE)],
        dim=1,
    )
    tok_len = torch.cat(
        [torch.stack([sorted_dlen, main_len], dim=2).reshape(B, 2 * NB), full(1, 0)], dim=1
    )
    T = 2 * NB + 1
    report, run_start_ref, run_ref_len, run_start_query, run_query_len = recover_runs(
        tok_code, tok_len, initial
    )

    # ---- run compaction: a per-record prefix sum plus record offsets ----
    row_incl = _i32_cumsum(report.int(), 1)
    row_counts = row_incl[:, -1]
    rec_off = _i32_cumsum(row_counts, 0) - row_counts  # exclusive
    total_runs = rec_off[-1] + row_counts[-1]
    gslot = rec_off[:, None] + row_incl - 1
    pool_overflow = (total_runs > slot_pool).int()

    # breaks sit only on main-lane tokens and the final column, so the
    # scatter runs over that (B, NB+1) sub-lattice, two 16-bit fields to a
    # lane (incl_ref and incl_query < 2**16 by the R <= 255 event rule and
    # the engine's B, Lq < 2**16 gates)
    def main_lane(buf):
        return torch.cat([buf[:, 1::2], buf[:, -1:]], dim=1)

    scatter_idx = torch.where(
        main_lane(report), torch.clamp(main_lane(gslot), 0, slot_pool - 1), slot_pool
    ).reshape(-1).long()
    rec_b = torch.arange(B, dtype=torch.int32, device=dev)[:, None].expand(B, T)
    vals = torch.stack(
        [
            main_lane(run_start_ref + ref_off[:, None]),
            main_lane((run_ref_len << 16) | rec_b),
            main_lane((run_start_query << 16) | run_query_len),
        ],
        dim=2,
    ).reshape(-1, 3)
    compacted = _compact(scatter_idx, vals, slot_pool)
    c_sr = compacted[:, 0]
    c_rl = compacted[:, 1] >> 16
    c_rec = compacted[:, 1] & 0xFFFF
    c_sq = compacted[:, 2] >> 16
    c_ql = compacted[:, 2] & 0xFFFF

    realign_ops, realign_counts, len_overflow = gather_and_align(
        ref_flat, query, c_sr, c_rl, c_sq, c_ql, c_rec, go, ge, run_r, run_q
    )
    flags = torch.stack(
        [pool_overflow + len_overflow + cnt_overflow, ev_overflow, total_runs]
    ).int()
    return initial, gapbits, d_vals, d_pos8, d_n8, realign_ops, realign_counts, flags


def make_fused_event_kernel(geo):
    """The v4 engine bound to one ``DeviceEventGeometry``'s tables."""
    return functools.partial(_fused_event_body, geo)
