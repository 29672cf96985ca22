"""Batched CIGAR rewriting on tensors.

Counterpart of ``panvc3_tpu.ops.rewrite_batch``.  A batch of records
ships to the device as compact op-level arrays (op codes and counts); the
device expands them to per-base "reference units" with prefix sums and
runs the coordinate math (select0/rank0/bit over the ``DeviceGapIndex``,
and in ``rewrite_math`` the query/reference character comparison); the
host interleaves the results with the pass-through ops and RLE-collapses
them (``finalize_rewrite``).

- ``rewrite_math`` (and its wire-packed ``rewrite_device_kernel_packed``)
  is the full rewrite; ``rewrite_batch`` runs it end to end;
- the gap kernel (``_gap_math``, ``rewrite_gap_kernel_packed``,
  ``rewrite_gap_kernel_wire``) computes only the gap geometry: per unit
  the inter-position deletion run and whether the destination column is a
  gap.  The =/X comparison stays on the host (``reconstruct_main_code``,
  or the native ``finalize_reconstruct`` of the fast lane).

Plain PyTorch: no hand-written kernel.  XLA's scatter drops an index that
is out of range after wrapping a negative one once; here such indices go
to a spare column that is sliced off (``_drop_index``).  ``torch.cumsum``
and ``torch.sum`` of int32 give int64, so results are cast back to the JAX
version's dtypes.  The result is bit-identical to
:func:`panvc3_tpu_torch.rewrite.rewrite_cigar`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..cigar import CODE_TO_OP, D, EQ, I, M, N, OP_TO_CODE, S, X, Cigar
from ..parallel.mesh import shard_batch_arrays
from .rank_select import DeviceGapIndex, take

CODE_NONE = 15  # emitted-op code for "nothing"

_IS_REF_OP = np.zeros(16, dtype=bool)
for _c in (M, EQ, X, D, N):
    _IS_REF_OP[_c] = True
_IS_MTYPE_OP = np.zeros(16, dtype=bool)
for _c in (M, EQ, X):
    _IS_MTYPE_OP[_c] = True
_IS_QUERY_OP = np.zeros(16, dtype=bool)
for _c in (I, S):
    _IS_QUERY_OP[_c] = True

#: non-zero deletion runs per record in the packed outputs (more -> the
#: caller fetches the full int32 runs)
D_SPARSE_SLOTS = 8


def as_device(x, device: torch.device) -> torch.Tensor:
    """``x`` (a tensor or a numpy array) as a tensor on ``device``, its
    dtype kept."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.require(x, requirements=["C", "W"])).to(device)


def _drop_index(idx: torch.Tensor, size: int) -> torch.Tensor:
    """Scatter indices along a dimension of ``size`` with XLA's
    ``mode="drop"``: a negative index wraps once, and whatever is still out
    of range goes to the spare slot ``size``."""
    idx = idx.long()
    idx = torch.where(idx < 0, idx + size, idx)
    return torch.where((idx >= 0) & (idx < size), idx, size)


def expand_by_delta(values, starts, out_len: int):
    """Gather-free monotone run-length expansion.

    ``out[b, u, ...] = values[b, j, ...]`` for the largest ``j`` with
    ``starts[b, j] <= u`` (zero where no such ``j``): a scatter-add of
    first differences and one prefix sum.  ``starts`` must be
    non-decreasing per row; out-of-range starts are dropped."""
    B = values.shape[0]
    prev = torch.cat([torch.zeros_like(values[:, :1]), values[:, :-1]], dim=1)
    deltas = values - prev
    idx = _drop_index(starts, out_len)
    idx = idx.reshape(idx.shape + (1,) * (values.dim() - 2)).expand_as(values)
    z = torch.zeros(
        (B, out_len + 1) + tuple(values.shape[2:]), dtype=values.dtype,
        device=values.device,
    )
    z.scatter_add_(1, idx, deltas)
    return torch.cumsum(z[:, :out_len], dim=1).to(values.dtype)


@dataclass
class RewriteBatch:
    """Host-side staging of one batch of records for the rewrite kernel."""

    # per record (shipped to device)
    src_seq: np.ndarray       # int32[B]
    dst_seq: np.ndarray       # int32[B]
    rec_src_pos: np.ndarray   # int32[B]
    ref_off: np.ndarray       # int32[B] offset of the record's output ref in ref_flat
    ops: np.ndarray           # int8[B, O] CIGAR op codes (CODE_NONE padding)
    counts: np.ndarray        # int32[B, O]
    query: np.ndarray         # uint8[B, Lq] dna5-normalised, 0-padded
    # host-only bookkeeping for the RLE merge
    n_ref_units: np.ndarray   # int32[B]
    unit_op: np.ndarray       # int8[total_units] flat unit stream
    unit_count: np.ndarray    # int32[total_units]
    unit_rec: np.ndarray      # int32[total_units]
    pad_ref_units: int        # R


def expand_cigars(
    cigars: list[Cigar],
    src_positions: list[int],
    queries: list[bytes],
    src_seq_ids: list[int],
    dst_seq_ids: list[int],
    ref_offsets: list[int],
    pad_ops: int | None = None,
    pad_ref_units: int | None = None,
    pad_query: int | None = None,
) -> RewriteBatch:
    """Stage a batch: op-level device arrays + flat host unit stream."""
    b = len(cigars)

    n_ops = np.fromiter((len(c) for c in cigars), dtype=np.int64, count=b)
    total_ops = int(n_ops.sum())
    ops_flat = np.empty(total_ops, dtype=np.int8)
    counts_flat = np.empty(total_ops, dtype=np.int64)
    k = 0
    for cig in cigars:
        for count, op_char in cig:
            ops_flat[k] = OP_TO_CODE[op_char]
            counts_flat[k] = count
            k += 1
    op_rec = np.repeat(np.arange(b), n_ops)

    is_ref_op = _IS_REF_OP[ops_flat]
    ref_per_rec = np.bincount(
        op_rec, weights=np.where(is_ref_op, counts_flat, 0), minlength=b
    ).astype(np.int64)

    # flat unit stream (one unit per base for ref ops, one per op otherwise)
    rep = np.where(is_ref_op, counts_flat, 1)
    unit_op = np.repeat(ops_flat, rep)
    unit_rec = np.repeat(op_rec, rep).astype(np.int32)
    unit_count = np.repeat(np.where(is_ref_op, 1, counts_flat), rep).astype(np.int32)

    o = pad_ops if pad_ops is not None else max(1, int(n_ops.max(initial=0)))
    r = pad_ref_units if pad_ref_units is not None else max(1, int(ref_per_rec.max(initial=0)))
    lq = pad_query if pad_query is not None else max(1, max((len(q) for q in queries), default=1))

    ops_2d = np.full((b, o), CODE_NONE, dtype=np.int8)
    counts_2d = np.zeros((b, o), dtype=np.int32)
    op_start = np.concatenate([[0], np.cumsum(n_ops)[:-1]])
    col = np.arange(total_ops) - op_start[op_rec]
    ops_2d[op_rec, col] = ops_flat
    counts_2d[op_rec, col] = counts_flat

    query_2d = np.zeros((b, lq), dtype=np.uint8)
    qlens = np.fromiter((len(q) for q in queries), dtype=np.int64, count=b)
    if b and qlens.max(initial=0):
        qflat = np.frombuffer(b"".join(queries), dtype=np.uint8)
        qrec = np.repeat(np.arange(b), qlens)
        qstart = np.concatenate([[0], np.cumsum(qlens)[:-1]])
        qcol = np.arange(len(qflat)) - qstart[qrec]
        query_2d[qrec, qcol] = qflat

    return RewriteBatch(
        src_seq=np.asarray(src_seq_ids, dtype=np.int32),
        dst_seq=np.asarray(dst_seq_ids, dtype=np.int32),
        rec_src_pos=np.asarray(src_positions, dtype=np.int32),
        ref_off=np.asarray(ref_offsets, dtype=np.int32),
        ops=ops_2d,
        counts=counts_2d,
        query=query_2d,
        n_ref_units=ref_per_rec.astype(np.int32),
        unit_op=unit_op,
        unit_count=unit_count,
        unit_rec=unit_rec,
        pad_ref_units=r,
    )


def _table(mask: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(mask).to(device)


def rewrite_math(
    index: DeviceGapIndex,
    ref_flat: torch.Tensor,    # uint8[Nref] concatenated output reference bytes
    src_seq: torch.Tensor,     # int32[B]
    dst_seq: torch.Tensor,     # int32[B]
    rec_src_pos: torch.Tensor,  # int32[B]
    ref_off: torch.Tensor,     # int32[B]
    ops: torch.Tensor,         # int8[B, O]
    counts: torch.Tensor,      # int32[B, O]
    query: torch.Tensor,       # uint8[B, Lq]
    R: int,
):
    """Per-base expansion + coordinate math on the index's device.

    Returns (dst_pos int32[B], d_run int32[B, R], main_code int8[B, R])."""
    dev = index.device
    code = ops.long()
    is_ref_op = _table(_IS_REF_OP, dev)[code]
    is_mtype_op = _table(_IS_MTYPE_OP, dev)[code]
    is_query_op = _table(_IS_QUERY_OP, dev)[code]
    counts = counts.int()

    ref_counts = torch.where(is_ref_op, counts, 0)
    pref = torch.cumsum(ref_counts, dim=1).int() - ref_counts  # exclusive
    total_ref = pref[:, -1] + ref_counts[:, -1]

    q_counts = torch.where(is_mtype_op | is_query_op, counts, 0)
    qpref = torch.cumsum(q_counts, dim=1).int() - q_counts

    r = torch.arange(R, dtype=torch.int32, device=dev)[None, :]
    valid = r < total_ref[:, None]

    is_mtype = (
        expand_by_delta(is_mtype_op.int()[:, :, None], pref, R)[:, :, 0] == 1
    ) & valid

    # query chars placed onto the ref units that consume them: expand each
    # op's (ref prefix - query prefix) offset over query space, then one
    # scatter of the query bytes to r = q + offset (I/S and padding
    # positions drop out)
    B, Lq = query.shape
    q_ax = torch.arange(Lq, dtype=torch.int32, device=dev)[None, :]
    qlane = ((pref - qpref) << 1) | is_mtype_op.int()
    eq_q = expand_by_delta(qlane[:, :, None], qpref, Lq)[:, :, 0]
    r_of_q = torch.where((eq_q & 1) == 1, q_ax + (eq_q >> 1), R)
    qchar = torch.zeros((B, R + 1), dtype=torch.int32, device=dev)
    qchar.scatter_add_(1, _drop_index(r_of_q, R), query.int())
    qchar = (qchar[:, :R] & 0xFF).to(torch.uint8)

    d = dst_seq[:, None]
    # consecutive ranks: one zsel slice per record; entries beyond
    # total_ref are tail-pad garbage, masked by every consumer
    aligned = index.select0_consecutive(src_seq, rec_src_pos.long() + 1, R)
    excess, isgap = index.rank0_and_bit(d, aligned)
    initial = index.rank0(dst_seq, aligned[:, 0])

    nongap = 1 - isgap
    prev_excess = torch.cat([initial[:, None], (excess + nongap)[:, :-1]], dim=1)
    d_run = torch.where(valid, torch.clamp(excess - prev_excess, min=0), 0).int()

    dst_char = take(ref_flat, ref_off.long()[:, None] + excess)
    eq = qchar == dst_char

    main_code = torch.where(
        valid,
        torch.where(
            is_mtype,
            torch.where(isgap == 1, I, torch.where(eq, EQ, X)),
            torch.where(isgap == 1, CODE_NONE, D),
        ),
        CODE_NONE,
    ).to(torch.int8)
    return initial.int(), d_run, main_code


def rewrite_device_kernel(index, ref_flat, src_seq, dst_seq, rec_src_pos,
                          ref_off, ops, counts, query, R: int):
    """``rewrite_math`` on tensors or numpy arrays, moved to the index's
    device."""
    dev = index.device
    args = (ref_flat, src_seq, dst_seq, rec_src_pos, ref_off, ops, counts, query)
    return rewrite_math(index, *(as_device(a, dev) for a in args), R)


# ---------------------------------------------------------------------------
# Wire packing: queries ship as 4-bit dna5 codes; the results come back as
# nibble-packed op codes plus a sparse list of the (rare) non-zero deletion
# run lengths.
# ---------------------------------------------------------------------------

_QUERY_CODE = np.full(256, 5, dtype=np.uint8)  # 5 == padding / other
for _i, _c in enumerate(b"ACGTN"):
    _QUERY_CODE[_c] = _i
_QUERY_DECODE = np.array([65, 67, 71, 84, 78, 0, 0, 0], dtype=np.uint8)  # "ACGTN" + pad


def pack_query(query: np.ndarray) -> np.ndarray:
    """uint8 (B, Lq) query bytes -> 4-bit codes packed (B, Lq/2)."""
    codes = _QUERY_CODE[query]
    return (codes[:, 0::2] | (codes[:, 1::2] << 4)).astype(np.uint8)


def _unpack_query(packed: torch.Tensor, lq: int) -> torch.Tensor:
    lo = packed & 0xF
    hi = (packed >> 4) & 0xF
    codes = torch.stack([lo, hi], dim=2).reshape(packed.shape[0], lq)
    return take(_table(_QUERY_DECODE, packed.device), codes)


def _pack_bits8(isgap: torch.Tensor) -> torch.Tensor:
    """Little-endian bitmask u8[B, R/8] of a 0/1 (B, R) tensor."""
    B, R = isgap.shape
    bits = isgap.int().reshape(B, R // 8, 8)
    weights = (1 << torch.arange(8, dtype=torch.int32, device=isgap.device))[None, None, :]
    return (bits * weights).sum(dim=2).to(torch.uint8)


def _rewrite_math_packed(index, ref_flat, src_seq, dst_seq, rec_src_pos,
                         ref_off, ops, counts, query_packed, R: int, Lq: int):
    """rewrite_math with wire-packed inputs/outputs.

    Returns (dst_pos, code_packed (B, R/2) u8 nibbles, d_vals (B, K) u8,
    d_pos (B, K) u8 unit indices, d_n (B,) i32, overflow i32, d_run full).
    ``overflow`` counts records whose sparse slots or u8 value range ran
    out; the host then fetches the full int32 d_run."""
    query = _unpack_query(query_packed, Lq)
    dst_pos, d_run, main_code = rewrite_math(
        index, ref_flat, src_seq, dst_seq, rec_src_pos, ref_off, ops, counts,
        query, R,
    )
    mc = main_code.to(torch.uint8) & 0xF
    code_packed = mc[:, 0::2] | (mc[:, 1::2] << 4)

    B = d_run.shape[0]
    K = D_SPARSE_SLOTS
    nz = d_run > 0
    slot = torch.cumsum(nz.int(), dim=1) - 1
    d_n = nz.sum(dim=1).int()
    # the JAX version scatters every non-zero run to min(slot, K-1) and the
    # last write wins; only the last of those that share slot K-1 is kept
    keep = nz & ((slot < K - 1) | (slot == d_n[:, None] - 1))
    scatter_to = torch.where(keep, slot.clamp(0, K - 1), K).long()
    d_vals = torch.zeros((B, K + 1), dtype=torch.int32, device=d_run.device)
    d_vals.scatter_(1, scatter_to, torch.clamp(d_run, max=255))
    r_ax = torch.arange(R, dtype=torch.int32, device=d_run.device)[None, :].expand(B, R)
    d_pos = torch.zeros((B, K + 1), dtype=torch.int32, device=d_run.device)
    d_pos.scatter_(1, scatter_to, r_ax & 0xFF)
    overflow = (
        (d_n > K).sum() + (d_run >= 255).sum() + (1 if R > 255 else 0)
    ).int()
    return (
        dst_pos, code_packed, d_vals[:, :K].to(torch.uint8),
        d_pos[:, :K].to(torch.uint8), d_n, overflow, d_run,
    )


def rewrite_device_kernel_packed(index, ref_flat, src_seq, dst_seq,
                                 rec_src_pos, ref_off, ops, counts,
                                 query_packed, R: int, Lq: int):
    """``_rewrite_math_packed`` on tensors or numpy arrays, moved to the
    index's device."""
    dev = index.device
    args = (ref_flat, src_seq, dst_seq, rec_src_pos, ref_off, ops, counts, query_packed)
    return _rewrite_math_packed(index, *(as_device(a, dev) for a in args), R, Lq)


def _host(t) -> np.ndarray:
    """``t`` on the host: a tensor, an array, or a list of tensors (a
    mesh's shards) joined along the first dimension."""
    if isinstance(t, list):
        return np.concatenate([_host(p) for p in t])
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def fetch_rewrite_outputs(out, R: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fetch (dst_pos, d_run, main_code) from a packed-kernel result,
    fetching the full int32 deletion runs only on overflow."""
    dst_pos, code_packed, d_vals, d_pos, d_n, overflow = (_host(t) for t in out[:6])
    b = dst_pos.shape[0]
    main_code = np.empty((b, R), dtype=np.int8)
    main_code[:, 0::2] = code_packed & 0xF
    main_code[:, 1::2] = (code_packed >> 4) & 0xF
    if int(overflow):
        d_run = _host(out[6])
    else:
        d_run = np.zeros((b, R), dtype=np.int32)
        k = np.arange(D_SPARSE_SLOTS)[None, :]
        valid = k < d_n[:, None]
        rows = np.broadcast_to(np.arange(b)[:, None], valid.shape)[valid]
        d_run[rows, d_pos[valid].astype(np.int64)] = d_vals[valid]
    return dst_pos, d_run, main_code


def finalize_rewrite(
    batch: RewriteBatch,
    dst_pos: np.ndarray,
    d_run: np.ndarray,
    main_code: np.ndarray,
) -> tuple[list[int], list[Cigar]]:
    """Merge device results into per-record rewritten CIGARs (one flat RLE
    pass: adjacent equal ops merge within a record, runs break at record
    boundaries)."""
    total_units = len(batch.unit_op)
    b = len(batch.src_seq)

    is_ref = _IS_REF_OP[batch.unit_op]

    # device rows -> flat per-record ref-unit stream (row-major order of the
    # valid region matches unit order)
    R = batch.pad_ref_units
    valid = np.arange(R)[None, :] < batch.n_ref_units[:, None]
    dev_d = d_run[valid]
    dev_code = main_code[valid]

    out_ops = np.empty((total_units, 2), dtype=np.int16)
    out_lens = np.zeros((total_units, 2), dtype=np.int32)
    out_ops[:, 0] = CODE_NONE
    out_ops[:, 1] = batch.unit_op
    out_lens[:, 1] = batch.unit_count
    out_ops[is_ref, 0] = D
    out_lens[is_ref, 0] = dev_d
    out_ops[is_ref, 1] = dev_code
    out_lens[is_ref, 1] = np.where(dev_code == CODE_NONE, 0, 1)

    flat_ops = out_ops.reshape(-1)
    flat_lens = out_lens.reshape(-1)
    flat_rec = np.repeat(batch.unit_rec, 2)

    keep = flat_lens > 0
    ops_k = flat_ops[keep]
    lens_k = flat_lens[keep]
    rec_k = flat_rec[keep]

    positions = [int(p) for p in dst_pos]
    if len(ops_k) == 0:
        return positions, [[] for _ in range(b)]

    boundary = np.empty(len(ops_k), dtype=bool)
    boundary[0] = True
    np.logical_or(ops_k[1:] != ops_k[:-1], rec_k[1:] != rec_k[:-1], out=boundary[1:])
    starts = np.flatnonzero(boundary)
    run_lens = np.add.reduceat(lens_k, starts)
    run_ops = ops_k[starts]
    run_rec = rec_k[starts]

    runs_per_rec = np.bincount(run_rec, minlength=b)
    run_off = np.concatenate([[0], np.cumsum(runs_per_rec)])
    ops_list = run_ops.tolist()
    lens_list = run_lens.tolist()
    cigars: list[Cigar] = []
    for i in range(b):
        lo, hi = run_off[i], run_off[i + 1]
        cigars.append(
            [(lens_list[j], CODE_TO_OP[ops_list[j]]) for j in range(lo, hi)]
        )
    return positions, cigars


# ---------------------------------------------------------------------------
# The gap kernel: per ref unit only the inter-position deletion run and
# whether the destination column is a gap.  Neither the query nor the
# reference ships to the device.  Inputs per record: src/dst sequence ids,
# source position, ref-unit count.  Outputs: dst_pos, isgap bitmask (R/8
# B), sparse deletion runs.
# ---------------------------------------------------------------------------


def _gap_math(index, src_seq, dst_seq, rec_src_pos, n_ref_units, R: int):
    """(initial dst positions, d_run int32[B, R], isgap int32[B, R]).

    The R units of a record are consecutive source positions, so select0
    loads one contiguous ``zsel`` slice per record and rank0_and_bit is one
    combined-table gather per unit; values beyond ``n_ref_units`` are
    garbage and masked here."""
    dev = index.device
    r = torch.arange(R, dtype=torch.int32, device=dev)[None, :]
    valid = r < n_ref_units[:, None]
    aligned = index.select0_consecutive(src_seq, rec_src_pos.long() + 1, R)
    excess, isgap = index.rank0_and_bit(dst_seq[:, None], aligned)
    # aligned[:, 0] == select0(src, pos + 1) independent of n_ref_units
    initial = index.rank0(dst_seq, aligned[:, 0])
    isgap = torch.where(valid, isgap, 0)
    nongap = torch.where(valid, 1 - isgap, 0)
    prev_excess = torch.cat([initial[:, None], (excess + nongap)[:, :-1]], dim=1)
    d_run = torch.where(valid, torch.clamp(excess - prev_excess, min=0), 0).int()
    return initial.int(), d_run, isgap.int()


def _gap_math_packed(index, src_seq, dst_seq, rec_src_pos, n_ref_units, R: int):
    """Gap kernel with wire-packed outputs: isgap as a bitmask and the
    (rare) non-zero deletion runs as per-record sparse slots.  Returns
    (initial, gapbits, d_vals, d_pos, d_n8, overflow, d_run)."""
    initial, d_run, isgap = _gap_math(
        index, src_seq, dst_seq, rec_src_pos, n_ref_units, R
    )
    B = d_run.shape[0]
    gapbits = _pack_bits8(isgap)

    K = D_SPARSE_SLOTS
    nz = d_run > 0
    slot = torch.cumsum(nz.int(), dim=1) - 1
    d_n = nz.sum(dim=1).int()
    # the first K non-zero runs, each in its slot (the JAX version's
    # one-hot reduction); the rest drop
    to = torch.where(nz & (slot < K), slot, K).long()
    d_vals = torch.zeros((B, K + 1), dtype=torch.int32, device=d_run.device)
    d_vals.scatter_(1, to, torch.clamp(d_run, max=255))
    r_ax = torch.arange(R, dtype=torch.int32, device=d_run.device)[None, :].expand(B, R)
    d_pos = torch.zeros((B, K + 1), dtype=torch.int32, device=d_run.device)
    d_pos.scatter_(1, to, r_ax & 0xFF)
    overflow = (
        (d_n > K).sum() + (d_run >= 255).sum() + (1 if R > 255 else 0)
    ).int()
    # wire-packed count: valid (<= R <= 255) whenever overflow == 0
    d_n8 = torch.clamp(d_n, max=255).to(torch.uint8)
    return (
        initial, gapbits, d_vals[:, :K].to(torch.uint8),
        d_pos[:, :K].to(torch.uint8), d_n8, overflow, d_run,
    )


def rewrite_gap_kernel_packed(index, src_seq, dst_seq, rec_src_pos,
                              n_ref_units, R: int):
    """``_gap_math_packed`` on tensors or numpy arrays, moved to the
    index's device."""
    dev = index.device
    args = (src_seq, dst_seq, rec_src_pos, n_ref_units)
    return _gap_math_packed(index, *(as_device(a, dev) for a in args), R)


def rewrite_gap_kernel_sharded(mesh, indexes, src_seq, dst_seq, rec_src_pos,
                               n_ref_units, R: int):
    """The gap kernel over a mesh: the batch (its rows a multiple of
    ``mesh.size``) is cut into the mesh's row blocks and each block runs
    ``rewrite_gap_kernel_packed`` on its shard's device, over that
    device's replica in ``indexes`` (``replicate(mesh, index)``).  Returns
    the seven outputs of one call, each row output a list of this
    process's shards in order (``DeviceFetch`` and ``fetch_gap_outputs``
    join them), the overflow count summed on the first shard's device."""
    shards = shard_batch_arrays(mesh, {
        "src_seq": src_seq, "dst_seq": dst_seq,
        "rec_src_pos": rec_src_pos, "n_ref_units": n_ref_units,
    })
    outs = [
        rewrite_gap_kernel_packed(index, *(a[i] for a in shards.values()), R)
        for i, index in enumerate(indexes)
    ]
    rows = [[o[k] for o in outs] for k in range(7)]
    dev0 = mesh.devices[0]
    rows[5] = sum(o.to(dev0) for o in rows[5])
    return rows


# ---------------------------------------------------------------------------
# Single-buffer wire format: one u8 array each way.  Input row (10
# B/record): [pos i32 LE | n_units u16 LE | src u16 LE | dst u16 LE].
# Output row (5 + R/8 + 2K B): [dst_pos i32 LE | d_n u8 | gapbits R/8 |
# d_pos K | d_vals K].
# ---------------------------------------------------------------------------

GAP_WIRE_IN = 10


def pack_gap_wire_input(
    pos: np.ndarray, n_units: np.ndarray, src: np.ndarray, dst: np.ndarray
) -> np.ndarray:
    b = len(pos)
    out = np.empty((b, GAP_WIRE_IN), dtype=np.uint8)
    out[:, 0:4] = pos.astype("<i4").view(np.uint8).reshape(b, 4)
    out[:, 4:6] = n_units.astype("<u2").view(np.uint8).reshape(b, 2)
    out[:, 6:8] = src.astype("<u2").view(np.uint8).reshape(b, 2)
    out[:, 8:10] = dst.astype("<u2").view(np.uint8).reshape(b, 2)
    return out


def pos_bytes(initial: torch.Tensor) -> torch.Tensor:
    """int32 (B,) -> its four little-endian bytes, u8 (B, 4)."""
    v = initial.long()
    return torch.stack([((v >> k) & 0xFF) for k in (0, 8, 16, 24)], dim=1).to(torch.uint8)


def _gap_math_wire(index, packed_in, R: int):
    p = packed_in.long()
    pos = p[:, 0] | (p[:, 1] << 8) | (p[:, 2] << 16) | (p[:, 3] << 24)
    pos = torch.where(pos >= 1 << 31, pos - (1 << 32), pos)  # i32 LE
    n_units = p[:, 4] | (p[:, 5] << 8)
    src = p[:, 6] | (p[:, 7] << 8)
    dst = p[:, 8] | (p[:, 9] << 8)
    initial, gapbits, d_vals, d_pos, d_n8, overflow, d_run = _gap_math_packed(
        index, src, dst, pos, n_units, R
    )
    wire = torch.cat(
        [pos_bytes(initial), d_n8[:, None], gapbits, d_pos, d_vals], dim=1
    )
    return wire, overflow, d_run


def rewrite_gap_kernel_wire(index, packed_in, R: int):
    """The gap kernel on one packed input buffer (``pack_gap_wire_input``):
    returns (wire u8[B, gap_wire_row_bytes(R)], overflow, d_run)."""
    return _gap_math_wire(index, as_device(packed_in, index.device), R)


def unpack_gap_wire(wire: np.ndarray, R: int):
    """Split a fetched wire buffer back into (dst_pos i32, d_n u8,
    gapbits u8[B, R/8], d_pos u8[B, K], d_vals u8[B, K]); all contiguous."""
    b = wire.shape[0]
    K = D_SPARSE_SLOTS
    dst_pos = np.ascontiguousarray(wire[:, 0:4]).view("<i4").reshape(b)
    d_n = np.ascontiguousarray(wire[:, 4])
    gapbits = np.ascontiguousarray(wire[:, 5:5 + R // 8])
    d_pos = np.ascontiguousarray(wire[:, 5 + R // 8:5 + R // 8 + K])
    d_vals = np.ascontiguousarray(wire[:, 5 + R // 8 + K:5 + R // 8 + 2 * K])
    return dst_pos, d_n, gapbits, d_pos, d_vals


def fetch_gap_outputs(out, R: int):
    """(dst_pos, d_run int32[B, R], isgap uint8[B, R]) from the packed gap
    kernel (or the v4 fused engine's wire, whose sparse deletion slots are
    its effective width); fetches the full deletion-run array only on
    overflow."""
    dst_pos, gapbits, d_vals, d_pos, d_n, overflow = (_host(t) for t in out[:6])
    b = dst_pos.shape[0]
    isgap = np.unpackbits(gapbits, axis=1, bitorder="little", count=R)
    if int(overflow):
        d_run = _host(out[6])
    else:
        d_run = np.zeros((b, R), dtype=np.int32)
        k = np.arange(d_vals.shape[1])[None, :]
        valid = k < d_n[:, None]
        rows = np.broadcast_to(np.arange(b)[:, None], valid.shape)[valid]
        d_run[rows, d_pos[valid].astype(np.int64)] = d_vals[valid]
    return dst_pos, d_run, isgap


def reconstruct_main_code(
    unit_op: np.ndarray,     # int8[total_units] flat unit stream
    unit_count: np.ndarray,  # int32[total_units]
    unit_rec: np.ndarray,    # int32[total_units]
    b: int,
    R: int,
    dst_pos: np.ndarray,     # int32[B]
    d_run: np.ndarray,       # int32[B, R]
    isgap: np.ndarray,       # uint8[B, R] (zero beyond the valid region)
    query2d: np.ndarray,     # uint8[B, Lq] dna5-normalised
    ref_flat: np.ndarray,    # uint8[] raw host reference bytes (concat)
    ref_off: np.ndarray,     # int32[B] per-record offset into ref_flat
    ref_len: np.ndarray | None = None,  # int64[B] per-record contig length
) -> np.ndarray:
    """Host-side emitted-op reconstruction (the character-comparison half
    of the rewrite): given the device's gap geometry, compare query and
    reference bytes locally and emit =/X/I/D/CODE_NONE per ref unit.
    Matches ``rewrite_math``'s main_code on the valid region for
    well-formed records (a record whose query-consuming CIGAR length
    exceeds its query is rejected before either runs)."""
    unit_op = np.asarray(unit_op)
    unit_count = np.asarray(unit_count, dtype=np.int64)
    unit_rec = np.asarray(unit_rec)
    is_ref = _IS_REF_OP[unit_op]
    is_m = _IS_MTYPE_OP[unit_op]
    is_q = _IS_QUERY_OP[unit_op]

    # per-unit exclusive query prefix within each record
    qc = np.where(is_m | is_q, unit_count, 0)
    cq = np.cumsum(qc)
    excl_q = cq - qc
    if len(unit_rec):
        starts = np.r_[0, np.flatnonzero(np.diff(unit_rec)) + 1]
        present = unit_rec[starts]
        first_q = np.zeros(b, dtype=np.int64)
        first_q[present] = excl_q[starts]
        qpos_flat = excl_q - first_q[unit_rec]
        # within-record ref-unit column
        isr = is_ref.astype(np.int64)
        cr = np.cumsum(isr)
        excl_r = cr - isr
        first_r = np.zeros(b, dtype=np.int64)
        first_r[present] = excl_r[starts]
        col_flat = excl_r - first_r[unit_rec]
    else:
        qpos_flat = np.zeros(0, dtype=np.int64)
        col_flat = np.zeros(0, dtype=np.int64)

    rows = unit_rec[is_ref]
    col = col_flat[is_ref]
    mtype_u = is_m[is_ref]
    qpos_u = qpos_flat[is_ref]

    # reference position per unit: dst_pos + cum(d_run) + shifted
    # cum(nongap) (the prev_excess recurrence of rewrite_math)
    cum_d = np.cumsum(d_run, axis=1, dtype=np.int64)
    ng = (1 - isgap).astype(np.int64)
    cum_ng = np.concatenate(
        [np.zeros((b, 1), np.int64), np.cumsum(ng, axis=1)[:, :-1]], axis=1
    )
    excess = dst_pos[:, None].astype(np.int64) + cum_d + cum_ng

    refpos = excess[rows, col]
    # clamp within the record's contig (as the native finalize_reconstruct)
    ref_flat = np.asarray(ref_flat)
    if ref_len is not None:
        refpos = np.clip(refpos, 0, np.maximum(ref_len[rows] - 1, 0))
    idx = np.clip(
        ref_off[rows].astype(np.int64) + refpos, 0, max(0, len(ref_flat) - 1)
    )
    dst_char = ref_flat[idx]
    lq = query2d.shape[1]
    qchar = query2d[rows, np.minimum(qpos_u, lq - 1)]
    gap = isgap[rows, col].astype(bool)
    eq = qchar == dst_char
    code_u = np.where(
        mtype_u,
        np.where(gap, I, np.where(eq, EQ, X)),
        np.where(gap, CODE_NONE, D),
    ).astype(np.int8)
    main_code = np.full((b, R), CODE_NONE, np.int8)
    main_code[rows, col] = code_u
    return main_code


def rewrite_batch(
    index: DeviceGapIndex,
    ref_flat,
    batch: RewriteBatch,
) -> tuple[list[int], list[Cigar]]:
    """Run the full batched rewrite (host stage -> device -> host RLE)."""
    out = rewrite_device_kernel(
        index, ref_flat, batch.src_seq, batch.dst_seq, batch.rec_src_pos,
        batch.ref_off, batch.ops, batch.counts, batch.query,
        batch.pad_ref_units,
    )
    dst_pos, d_run, main_code = (_host(t) for t in out)
    return finalize_rewrite(batch, dst_pos, d_run, main_code)
