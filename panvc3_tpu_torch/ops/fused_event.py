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

Over a device mesh (``make_fused_event_kernel(geo, mesh)``), stages 1 and
2 run per shard; the run compaction is global across the batch, so the
shards' run totals meet on the host (``all_gather`` across processes),
their exclusive prefix gives each shard its first slot of the one pool,
and each shard runs the DP over its own slots: every output equals the
single-device call's (JAX's SPMD partitioner keeps that by itself).

The JAX version's ``_stage`` argument (truncate after stage N) serves a
TPU profiling tool and is left out.  Lanes are int32 and wrap as in JAX
(``fused`` says how); the rank-sort scatter has unique indices per row.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..cigar import D, EQ, I
from ..parallel.mesh import replicate
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


def _event_runs(geo, ref_ids, rec_src_pos, n_ref_units, ops, counts, R: int):
    """Stages 1 and 2 on the records of a batch, or of one shard of it, on
    ``geo``'s device: every step is per record.  Returns ``(wire,
    ev_overflow, cnt_overflow, runs)``: ``wire`` the five event-wire
    outputs, ``ev_overflow`` the slot and width overruns (the ``R > 255``
    term left to the caller), ``cnt_overflow`` the op counts too wide to
    pack, ``runs`` the run lanes ``(report, run_start_ref, run_ref_len,
    run_start_query, run_query_len)``, each ``(B, T)``."""
    dev = geo.device
    ops, counts = as_device(ops, dev), as_device(counts, dev)
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
    ev_overflow = (ov_slots + _i32_sum(d_len >= 255)).int()

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
    runs = recover_runs(tok_code, tok_len, initial)
    return (initial, gapbits, d_vals, d_pos8, d_n8), ev_overflow, cnt_overflow, runs


def _compact_runs(runs, row_incl, rec_off, ref_off, rec_base: int, slot_base: int,
                  slot_pool: int, lo: int = 0, hi: int | None = None):
    """Scatter the reported runs of records ``rec_base..`` into the slot
    pool (a record's runs from ``slot_base + rec_off``, in token order),
    and return slots ``[lo, hi)`` of it as ``(c_sr, c_rl, c_sq, c_ql,
    c_rec)``.  ``c_rec`` is the batch-wide record id."""
    report, run_start_ref, run_ref_len, run_start_query, run_query_len = runs
    B, T = report.shape
    gslot = slot_base + rec_off[:, None] + row_incl - 1

    # breaks sit only on main-lane tokens and the final column, so the
    # scatter runs over that (B, NB+1) sub-lattice, two 16-bit fields to a
    # lane (incl_ref and incl_query < 2**16 by the R <= 255 event rule and
    # the engine's B, Lq < 2**16 gates)
    def main_lane(buf):
        return torch.cat([buf[:, 1::2], buf[:, -1:]], dim=1)

    scatter_idx = torch.where(
        main_lane(report), torch.clamp(main_lane(gslot), 0, slot_pool - 1), slot_pool
    ).reshape(-1).long()
    rec_b = rec_base + torch.arange(B, dtype=torch.int32, device=report.device)[:, None].expand(B, T)
    vals = torch.stack(
        [
            main_lane(run_start_ref + ref_off[:, None]),
            main_lane((run_ref_len << 16) | rec_b),
            main_lane((run_start_query << 16) | run_query_len),
        ],
        dim=2,
    ).reshape(-1, 3)
    compacted = _compact(scatter_idx, vals, slot_pool, lo, hi)
    return (
        compacted[:, 0], compacted[:, 1] >> 16, compacted[:, 2] >> 16,
        compacted[:, 2] & 0xFFFF, compacted[:, 1] & 0xFFFF,
    )


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
    ref_flat, ref_off, query = (as_device(a, dev) for a in (ref_flat, ref_off, query))
    wire, ev_overflow, cnt_overflow, runs = _event_runs(
        geo, ref_ids, rec_src_pos, n_ref_units, ops, counts, R
    )
    ev_overflow = ev_overflow + (1 if R > 255 else 0)

    # ---- run compaction: a per-record prefix sum plus record offsets ----
    row_incl = _i32_cumsum(runs[0].int(), 1)
    row_counts = row_incl[:, -1]
    rec_off = _i32_cumsum(row_counts, 0) - row_counts  # exclusive
    total_runs = rec_off[-1] + row_counts[-1]
    pool_overflow = (total_runs > slot_pool).int()
    c_sr, c_rl, c_sq, c_ql, c_rec = _compact_runs(runs, row_incl, rec_off, ref_off, 0, 0, slot_pool)

    realign_ops, realign_counts, len_overflow = gather_and_align(
        ref_flat, query, c_sr, c_rl, c_sq, c_ql, c_rec, go, ge, run_r, run_q
    )
    flags = torch.stack(
        [pool_overflow + len_overflow + cnt_overflow, ev_overflow, total_runs]
    ).int()
    return (*wire, realign_ops, realign_counts, flags)


class ShardedV4(NamedTuple):
    """The outputs of v4 over a mesh: the five wire outputs and the two
    pool outputs are lists of this process's shards in order (joined along
    the first dimension they are, on one process, the single-device
    call's outputs); ``flags`` is global, on the first shard's device;
    ``slot_ranges`` holds the pool slots ``[lo, hi)`` of each local
    shard."""

    initial: list
    gapbits: list
    d_vals: list
    d_pos8: list
    d_n8: list
    realign_ops: list
    realign_counts: list
    flags: torch.Tensor
    slot_ranges: list


def _gather_ints(mesh, values: list) -> list[int]:
    """Per-shard scalars (0-d tensors, one per local shard) as host ints in
    global shard order: exchanged with ``all_gather`` across processes."""
    local = torch.stack([v.to(mesh.devices[0]) for v in values]).long()
    if mesh.process_count == 1:
        return local.tolist()
    import torch.distributed as dist

    if dist.get_backend() != "nccl":
        local = local.cpu()
    parts = [torch.empty_like(local) for _ in range(mesh.process_count)]
    dist.all_gather(parts, local)
    return torch.cat(parts).tolist()


def _fused_event_sharded(geos, mesh, ref_flats, ref_ids, rec_src_pos, n_ref_units, ref_off,
                         ops, counts, query, go, ge, R: int, run_r: int, run_q: int,
                         slot_pool: int) -> ShardedV4:
    """v4 over ``mesh``: ``geos`` and ``ref_flats`` are one replica per
    local shard (``replicate``), the batch arrays lists of row blocks
    (``shard_batch_arrays``).  Each shard runs the per-record stages on its
    device; the exclusive prefix of the shards' run totals (gathered to the
    host, across processes too) gives each shard its first slot; each
    shard scatters its runs into its own slots of the global pool and runs
    the DP over them, the last shard also over the empty slots past the
    runs, which hold what a single-device call leaves there.  Every output
    equals the single-device call's on the same global inputs, but for a
    pool overflow's last slot, whose content is unspecified on one device
    too (the engine discards it)."""
    rows = ops[0].shape[0]
    results = [
        _event_runs(geo, *(a[i] for a in (ref_ids, rec_src_pos, n_ref_units, ops, counts)), R)
        for i, geo in enumerate(geos)
    ]
    row_incl = [_i32_cumsum(runs[0].int(), 1) for _, _, _, runs in results]
    row_counts = [r[:, -1] for r in row_incl]
    totals = _gather_ints(mesh, [c.sum() for c in row_counts])
    bases = [sum(totals[:g]) for g in range(mesh.size + 1)]
    total_runs = bases[-1]

    pool_ops, pool_counts, ranges, local_flags = [], [], [], []
    for i, g in enumerate(mesh.local_shards):
        geo, (_, ev_ov, cnt_ov, runs) = geos[i], results[i]
        dev = geo.device
        lo = min(bases[g], slot_pool)
        hi = slot_pool if g == mesh.size - 1 else min(bases[g + 1], slot_pool)
        if hi > lo:
            rec_off = _i32_cumsum(row_counts[i], 0) - row_counts[i]
            compacted = _compact_runs(
                runs, row_incl[i], rec_off, as_device(ref_off[i], dev), g * rows, bases[g],
                slot_pool, lo, hi,
            )
            r_ops, r_counts, len_ov = gather_and_align(
                ref_flats[i], as_device(query[i], dev), *compacted, go, ge, run_r, run_q,
                rec_base=g * rows,
            )
        else:
            r_ops = torch.empty((0, run_r + run_q), dtype=torch.int8, device=dev)
            r_counts = torch.empty(0, dtype=torch.int32, device=dev)
            len_ov = torch.zeros((), dtype=torch.int32, device=dev)
        pool_ops.append(r_ops)
        pool_counts.append(r_counts)
        ranges.append((lo, hi))
        local_flags.append(torch.stack([len_ov + cnt_ov, ev_ov]).int().to(mesh.devices[0]))

    reduced = torch.stack(local_flags).sum(0).int()
    if mesh.process_count > 1:
        import torch.distributed as dist

        on_host = dist.get_backend() != "nccl"
        buf = reduced.cpu() if on_host else reduced
        dist.all_reduce(buf)
        reduced = buf.to(mesh.devices[0])
    flags = torch.stack([
        reduced[0] + int(total_runs > slot_pool),
        reduced[1] + (1 if R > 255 else 0),
        torch.tensor(total_runs, dtype=torch.int32, device=mesh.devices[0]),
    ]).int()
    wire = [[res[0][k] for res in results] for k in range(5)]
    return ShardedV4(*wire, pool_ops, pool_counts, flags, ranges)


def make_fused_event_kernel(geo, mesh=None):
    """The v4 engine bound to one ``DeviceEventGeometry``'s tables; over
    ``mesh``, bound to its replicas (``geo`` is copied once to each
    device) and taking the sharded inputs of ``_fused_event_sharded``."""
    if mesh is None:
        return functools.partial(_fused_event_body, geo)
    return functools.partial(_fused_event_sharded, replicate(mesh, geo), mesh)
