"""Batched affine-gap global realignment on tensors, and its wire formats.

Counterpart of ``panvc3_tpu.ops.realign_batch`` on its integer scoring
path:

- ``_substitution_scores``, ``_fill_batch`` and ``_traceback_batch`` are
  the plain PyTorch DP (the reference for the CUDA kernel, and the CPU
  path), with the same recurrences and tie order (diag >= vert > horiz,
  open >= extend) as the TPU scans; ``torch.cummax`` gives the row's
  horizontal-gap prefix maximum;
- ``realign_device_kernel`` and the three wire functions
  (``_realign_wire``, ``_realign_wire_refgather``,
  ``_realign_wire_refgather2``) decode their input, gather reference rows,
  run the DP through ``realign_pallas_fused.realign_fused`` and pack the
  ops;
- the numpy host helpers and tables are copies of the originals (which
  live in a module that imports JAX).

Scores are small integers, exact in f32, so every implementation is
byte-identical.
"""

from __future__ import annotations

import numpy as np
import torch

from ..alphabet import dna5_normalise_device
from .realign_pallas_fused import realign_fused

NEG = -1e30

_TR_DIAG = 0
_TR_VERT = 1
_TR_HORIZ = 2

# op codes the traceback emits (panvc3_tpu.cigar: = 7, X 8, I 1, D 2)
_EQ, _X, _I, _D = 7, 8, 1, 2


def _substitution_scores(ref, query):
    """s[b, i, j] for query i vs ref j, integer scheme: 0 on a match,
    -1 otherwise.  ref/query are uint8 (B, R)/(B, Q)."""
    eq = query[:, :, None] == ref[:, None, :]
    return torch.where(eq, 0.0, -1.0).to(torch.float32)


def _fill_batch(sub, m, n, go, ge, R: int, Q: int):
    """DP fill.  sub: (B, Q, R) f32; m/n: (B,) query/ref lengths.
    Returns the packed trace (B, Q+1, R+1) uint8 (move 2 bits: 0 diag,
    1 vert, 2 horiz; bit 2 vopen; bit 3 hopen)."""
    B = sub.shape[0]
    dev = sub.device
    f32 = torch.float32
    go = torch.tensor(float(go), dtype=f32, device=dev)
    ge = torch.tensor(float(ge), dtype=f32, device=dev)
    cols = torch.arange(R + 1, device=dev)[None, :]
    colsf = cols.to(f32)
    col_valid = cols <= n[:, None]
    neg_col = torch.full((B, 1), NEG, dtype=f32, device=dev)
    neg = torch.tensor(NEG, dtype=f32, device=dev)

    best = torch.where(cols == 0, 0.0, go + ge * colsf).to(f32).expand(B, R + 1)
    best = torch.where(col_valid, best, neg)
    vert = torch.full((B, R + 1), NEG, dtype=f32, device=dev)
    tr0 = torch.where(cols == 0, 0, _TR_HORIZ) | torch.where(cols == 1, 8, 0)
    rows = [tr0.to(torch.uint8).expand(B, R + 1)]

    for i in range(1, Q + 1):
        srow = sub[:, i - 1, :]
        row_valid = (i <= m)[:, None]

        v_open = best + go + ge
        v_ext = vert + ge
        vopen_bit = v_open >= v_ext
        vnew = torch.maximum(v_open, v_ext)

        diag = torch.cat([neg_col, best[:, :-1] + srow], dim=1)
        diag = torch.where(cols == 0, neg, diag)
        a = torch.maximum(diag, vnew)
        border = go + ge * float(i)
        a[:, 0] = border
        vnew[:, 0] = border

        shifted = a + go - ge * colsf
        run = torch.cat([neg_col, shifted[:, :-1]], dim=1)
        run = torch.cummax(run, dim=1).values
        horiz = run + ge * colsf
        horiz = torch.where(cols == 0, neg, horiz)
        bnew = torch.maximum(a, horiz)

        h_prev = torch.cat([neg_col, horiz[:, :-1]], dim=1)
        b_prev = torch.cat([neg_col, bnew[:, :-1]], dim=1)
        hopen_bit = b_prev + go >= h_prev

        tr = torch.where(diag >= vnew, _TR_DIAG, _TR_VERT)
        tr = torch.where(horiz > a, _TR_HORIZ, tr)
        tr = torch.where(cols == 0, _TR_VERT, tr)
        packed = (tr | vopen_bit.to(torch.int64) * 4 | hopen_bit.to(torch.int64) * 8)
        bnew = torch.where(col_valid, bnew, neg)
        vnew = torch.where(col_valid, vnew, neg)

        best = torch.where(row_valid, bnew, best)
        vert = torch.where(row_valid, vnew, vert)
        rows.append(torch.where(row_valid, packed, 0).to(torch.uint8))
    return torch.stack(rows, dim=1)


def _traceback_batch(trace, ref, query, m, n, R: int, Q: int):
    """Batched traceback from (m, n).  trace: (B, Q+1, R+1).  Returns
    (ops int8 (B, R+Q), count int32 (B,)): op k is emitted at step k, and
    steps past the end of the walk emit the 127 filler."""
    B = trace.shape[0]
    dev = trace.device
    stride = R + 1
    flat = trace.reshape(B, -1).to(torch.int64)
    i = m.to(torch.int64)
    j = n.to(torch.int64)
    state = torch.zeros(B, dtype=torch.int64, device=dev)
    k = torch.zeros(B, dtype=torch.int64, device=dev)
    qpad = torch.cat([query, torch.zeros((B, 1), dtype=query.dtype, device=dev)], 1)
    rpad = torch.cat([ref, torch.zeros((B, 1), dtype=ref.dtype, device=dev)], 1)
    emits = []
    for _ in range(R + Q):
        done = (i == 0) & (j == 0)
        cell = flat.gather(1, (i * stride + j)[:, None])[:, 0]
        tr = cell & 3
        vopen = (cell >> 2) & 1
        hopen = (cell >> 3) & 1

        in_m = state == 0
        eff = torch.where(in_m, tr, state)
        eff = torch.where(in_m & (i == 0) & (j > 0), _TR_HORIZ, eff)
        eff = torch.where(in_m & (j == 0) & (i > 0), _TR_VERT, eff)

        is_diag = (eff == _TR_DIAG) & ~done
        is_vert = (eff == _TR_VERT) & ~done
        is_horiz = (eff == _TR_HORIZ) & ~done

        # a diagonal step always has i, j >= 1; elsewhere the index -1
        # wraps to the zero padding column and the compare is unused
        qc = qpad.gather(1, ((i - 1) % (Q + 1))[:, None])[:, 0]
        rc = rpad.gather(1, ((j - 1) % (R + 1))[:, None])[:, 0]
        op = torch.where(
            is_diag,
            torch.where(qc == rc, _EQ, _X),
            torch.where(is_vert, _I, _D),
        )
        emits.append(torch.where(done, 127, op))
        k = torch.where(done, k, k + 1)

        ni = torch.where(is_diag | is_vert, i - 1, i)
        nj = torch.where(is_diag | is_horiz, j - 1, j)
        ns = torch.where(
            is_diag,
            0,
            torch.where(
                is_vert,
                torch.where(vopen == 1, 0, 1),
                torch.where(hopen == 1, 0, 2),
            ),
        )
        state = torch.where(done, state, ns)
        i = torch.where(done, i, ni)
        j = torch.where(done, j, nj)
    if emits:
        ops = torch.stack(emits, dim=1).to(torch.int8)
    else:
        ops = torch.zeros((B, 0), dtype=torch.int8, device=dev)
    return ops, k.to(torch.int32)


def realign_device_kernel(
    ref, query, ref_len, query_len, go, ge, ref_qual, query_qual,
    use_quality: bool, R: int, Q: int,
):
    """Unwired DP dispatch: ref/query uint8 (B, R)/(B, Q), lengths int32
    (B,).  Integer scoring only."""
    if use_quality:
        raise NotImplementedError(
            "realign_device_kernel: quality scoring (-q) is ROADMAP Queue 1 "
            "item 1"
        )
    return realign_fused(ref, query, query_len, ref_len, go, ge, R, Q)


# ---------------------------------------------------------------------------
# Wire formats (see panvc3_tpu.ops.realign_batch): one uint8 array each way.
# Classic input row (R+Q+4 B): [ref R | query Q | ref_len u16 LE |
# query_len u16 LE]; output ((R+Q)/2 + 1 B): ops nibble-packed + count.
# ---------------------------------------------------------------------------


def pack_realign_wire_input(
    ref: np.ndarray, query: np.ndarray, rl: np.ndarray, ql: np.ndarray
) -> np.ndarray:
    s, r = ref.shape
    q = query.shape[1]
    out = np.empty((s, r + q + 4), dtype=np.uint8)
    out[:, :r] = ref
    out[:, r:r + q] = query
    out[:, r + q:r + q + 2] = rl.astype("<u2").view(np.uint8).reshape(s, 2)
    out[:, r + q + 2:] = ql.astype("<u2").view(np.uint8).reshape(s, 2)
    return out


def _u16(lo, hi):
    return lo.to(torch.int32) | (hi.to(torch.int32) << 8)


def _u32(t):
    t = t.to(torch.int64)
    return t[:, 0] | (t[:, 1] << 8) | (t[:, 2] << 16) | (t[:, 3] << 24)


def _realign_wire(packed_in, go, ge, R: int, Q: int):
    p = packed_in
    ref = p[:, :R].contiguous()
    query = p[:, R:R + Q].contiguous()
    rl = _u16(p[:, R + Q], p[:, R + Q + 1])
    ql = _u16(p[:, R + Q + 2], p[:, R + Q + 3])
    ops, count = realign_fused(ref, query, ql, rl, go, ge, R, Q)
    nib = ops.view(torch.uint8) & 0xF
    packed_ops = nib[:, 0::2] | (nib[:, 1::2] << 4)
    return torch.cat(
        [packed_ops, count.clamp(max=255).to(torch.uint8)[:, None]], dim=1
    )


# ---------------------------------------------------------------------------
# Ref-gather wire: reference rows are gathered on the device from the
# resident flat reference; the query ships as 4-bit match-equivalence codes.
# Input row (Q/2 + 8 B): [codes | ref start u32 | ref_len u16 | query_len
# u16]; output (steps/4 + 1 B): the ops 2-bit packed plus the count byte.
# ---------------------------------------------------------------------------

# byte -> match-equivalence code
QUERY_CODE = np.full(256, 5, dtype=np.uint8)  # OTHER
for _i, _c in enumerate(b"ACGTN"):
    QUERY_CODE[_c] = _i
QUERY_CODE[0] = 6  # PAD (stays NUL)
# code -> canonical byte (OTHER -> 0x01: never equals a dna5 ref byte or 0)
QUERY_DECODE = np.frombuffer(b"ACGTN\x01\x00\x00", dtype=np.uint8).copy()

_TB_OPS = (7, 8, 1, 2)  # =, X, I, D — the only ops a traceback emits


def pack_realign_refgather_input(
    query: np.ndarray, start: np.ndarray, rl: np.ndarray, ql: np.ndarray
) -> np.ndarray:
    s, q = query.shape
    codes = QUERY_CODE[query]
    out = np.empty((s, q // 2 + 8), dtype=np.uint8)
    out[:, : q // 2] = codes[:, 0::2] | (codes[:, 1::2] << 4)
    out[:, q // 2: q // 2 + 4] = (
        start.astype("<u4").view(np.uint8).reshape(s, 4)
    )
    out[:, q // 2 + 4: q // 2 + 6] = (
        rl.astype("<u2").view(np.uint8).reshape(s, 2)
    )
    out[:, q // 2 + 6:] = ql.astype("<u2").view(np.uint8).reshape(s, 2)
    return out


def unpack_realign_refgather_wire(wire: np.ndarray, steps: int):
    """(ops int8[S, steps], count int32[S]) from a fetched ref-gather wire
    buffer (2-bit op codes); entries past ``count`` are never read
    downstream."""
    s = wire.shape[0]
    quarter = steps // 4
    lut = np.asarray(_TB_OPS, dtype=np.int8)
    ops = np.empty((s, steps), dtype=np.int8)
    body = wire[:, :quarter]
    ops[:, 0::4] = lut[body & 3]
    ops[:, 1::4] = lut[(body >> 2) & 3]
    ops[:, 2::4] = lut[(body >> 4) & 3]
    ops[:, 3::4] = lut[body >> 6]
    count = wire[:, quarter].astype(np.int32)
    return ops, count


def unpack_realign_wire(wire: np.ndarray, steps: int):
    """(ops int8[S, steps], count int32[S]) from a fetched classic wire
    buffer.  Nibble 15 decodes from the int8 padding byte 127; entries past
    ``count`` are never read downstream."""
    s = wire.shape[0]
    half = steps // 2
    ops = np.empty((s, steps), dtype=np.int8)
    ops[:, 0::2] = (wire[:, :half] & 0xF).astype(np.int8)
    ops[:, 1::2] = (wire[:, :half] >> 4).astype(np.int8)
    count = wire[:, half].astype(np.int32)
    return ops, count


def _gather_ref(ref_flat, start, rl, R: int):
    """Reference rows from the flat reference, dna5-normalised and zeroed
    past each run's length (the staged rows of stage_realign_runs)."""
    lane = torch.arange(R, dtype=torch.int64, device=ref_flat.device)[None, :]
    idx = (start[:, None] + lane).clamp(0, ref_flat.shape[0] - 1)
    ref = dna5_normalise_device(ref_flat[idx])
    return torch.where(lane < rl[:, None], ref, torch.zeros_like(ref))


def _decode_query_codes(packed_q, Q: int):
    """4-bit match-equivalence codes -> canonical query bytes (codes 6-15
    decode to NUL)."""
    codes = torch.empty((packed_q.shape[0], Q), dtype=torch.uint8, device=packed_q.device)
    codes[:, 0::2] = packed_q & 0xF
    codes[:, 1::2] = packed_q >> 4
    table = np.zeros(16, dtype=np.uint8)
    table[:6] = QUERY_DECODE[:6]
    return torch.from_numpy(table).to(packed_q.device)[codes.long()]


def _realign_wire_refgather(packed_in, ref_flat, go, ge, R: int, Q: int):
    p = packed_in
    half = Q // 2
    query = _decode_query_codes(p[:, :half], Q)
    tail = p[:, half:]
    start = _u32(tail[:, 0:4])
    rl = _u16(tail[:, 4], tail[:, 5])
    ql = _u16(tail[:, 6], tail[:, 7])
    ref = _gather_ref(ref_flat, start, rl, R)
    ops, count = realign_fused(ref, query, ql, rl, go, ge, R, Q)
    return _pack_ops_2bit(ops, count)


# ---------------------------------------------------------------------------
# 2-bit ref-gather wire: N-free windows ship the query as 2-bit codes and
# the lengths as single bytes.  Input row (Q/4 + 6 B): [codes 2-bit |
# ref start u32 | ref_len u8 | query_len u8]; output as the 4-bit wire.
# ---------------------------------------------------------------------------

QUERY_CODE2 = np.full(256, 255, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    QUERY_CODE2[_c] = _i
_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8).copy()


def query_wire2_eligible(query: np.ndarray, ql: np.ndarray) -> bool:
    """True iff every in-length byte of every row is one of A/C/G/T (rows
    are zero-padded past ql by construction, so padding never disqualifies)."""
    if query.shape[1] % 4:
        return False
    codes = QUERY_CODE2[query]
    in_len = np.arange(query.shape[1], dtype=np.int32)[None, :] < ql[:, None]
    return bool(np.all(codes[in_len] <= 3)) if in_len.any() else True


def pack_realign_refgather2_input(
    query: np.ndarray, start: np.ndarray, rl: np.ndarray, ql: np.ndarray
) -> np.ndarray:
    s, q = query.shape
    codes = QUERY_CODE2[query] & 3  # pad bytes (0) encode as 'A'; masked on device
    quarter = q // 4
    out = np.empty((s, quarter + 6), dtype=np.uint8)
    out[:, :quarter] = (
        codes[:, 0::4]
        | (codes[:, 1::4] << 2)
        | (codes[:, 2::4] << 4)
        | (codes[:, 3::4] << 6)
    )
    out[:, quarter:quarter + 4] = (
        start.astype("<u4").view(np.uint8).reshape(s, 4)
    )
    out[:, quarter + 4] = rl.astype(np.uint8)
    out[:, quarter + 5] = ql.astype(np.uint8)
    return out


def _decode_query_codes2(packed_q, Q: int, ql):
    """2-bit codes -> A/C/G/T bytes, zero past ql (the staged rows'
    padding)."""
    dev = packed_q.device
    codes = torch.empty((packed_q.shape[0], Q), dtype=torch.uint8, device=dev)
    codes[:, 0::4] = packed_q & 3
    codes[:, 1::4] = (packed_q >> 2) & 3
    codes[:, 2::4] = (packed_q >> 4) & 3
    codes[:, 3::4] = packed_q >> 6
    query = torch.from_numpy(_ACGT).to(dev)[codes.long()]
    lane = torch.arange(Q, dtype=torch.int32, device=dev)[None, :]
    return torch.where(lane < ql[:, None], query, torch.zeros_like(query))


def _realign_wire_refgather2(packed_in, ref_flat, go, ge, R: int, Q: int):
    p = packed_in
    quarter = Q // 4
    tail = p[:, quarter:]
    start = _u32(tail[:, 0:4])
    rl = tail[:, 4].to(torch.int32)
    ql = tail[:, 5].to(torch.int32)
    query = _decode_query_codes2(p[:, :quarter], Q, ql)
    ref = _gather_ref(ref_flat, start, rl, R)
    ops, count = realign_fused(ref, query, ql, rl, go, ge, R, Q)
    return _pack_ops_2bit(ops, count)


def _pack_ops_2bit(ops, count):
    """2-bit encode (= 0, X 1, I 2, D 3); anything past count is padding
    and encodes as 0 (downstream never reads it)."""
    o = ops.view(torch.uint8)
    code2 = (
        (o == _X).to(torch.uint8)
        | ((o == _I).to(torch.uint8) << 1)
        | ((o == _D).to(torch.uint8) * 3)
    )
    packed_ops = (
        code2[:, 0::4]
        | (code2[:, 1::4] << 2)
        | (code2[:, 2::4] << 4)
        | (code2[:, 3::4] << 6)
    )
    return torch.cat(
        [packed_ops, count.clamp(max=255).to(torch.uint8)[:, None]], dim=1
    )
