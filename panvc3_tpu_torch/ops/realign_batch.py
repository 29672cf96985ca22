"""Batched affine-gap global realignment on tensors, and its wire formats.

Counterpart of ``panvc3_tpu.ops.realign_batch``:

- ``_substitution_scores``, ``_fill_batch`` and ``_traceback_batch`` are
  the plain PyTorch DP (the reference for the CUDA kernels, and the CPU
  path), with the same recurrences and tie order (diag >= vert > horiz,
  open >= extend) as the TPU scans; ``torch.cummax`` gives the row's
  horizontal-gap prefix maximum;
- ``_dp`` routes one batch: K1, the fused kernel
  (``realign_pallas_fused.realign_fused``), or, under
  ``PANVC3_PALLAS_FUSED=0``, the split route: the substitution scores,
  K2's fill (``fill_dispatch``) and the traceback kernel
  (``realign_traceback.traceback_batch``), whose plain version on CPU
  tensors is ``_traceback_batch``;
- ``realign_device_kernel`` and the wire functions (three integer, three
  quality ``_q``) decode their input, gather reference rows, run ``_dp``
  and pack the ops;
- ``realign_batch``/``realign_batch_start``/``realign_batch_finish`` align
  lists of byte strings (host C DP for small batches, else ``_dp``),
  with pinned or explicit reference qualities;
- the numpy host helpers and tables are copies of the originals (which
  live in a module that imports JAX); the Malde tables come from the
  port's ``align``.

Scores are integers exact in f32 (the quality scheme in 1/``MALDE_SCALE``
units, gap costs scaled to match, while R+Q <= 5461), so every
implementation is byte-identical.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from .. import resolve_device
from ..align import MALDE_SCALE, malde_tables
from ..alphabet import PHRED42_MAX, dna5_normalise_device
from ..cigar import CODE_TO_OP, Cigar
from .realign_pallas import fill_batch
from .realign_pallas_fused import realign_fused
from .realign_traceback import traceback_batch

NEG = -1e30

_TR_DIAG = 0
_TR_VERT = 1
_TR_HORIZ = 2

# op codes the traceback emits (panvc3_tpu.cigar: = 7, X 8, I 1, D 2)
_EQ, _X, _I, _D = 7, 8, 1, 2

#: longest run (R+Q) the quantised quality scores keep exact in f32
#: (panvc3_tpu.align.MALDE_SHIFT)
QUAL_MAX_STEPS = 5461


@functools.lru_cache(maxsize=None)
def _malde(device: str):
    """The quantised Malde tables as f32 tensors on ``device``: (match
    (64, 64), mismatch (64, 64)), indexed [ref phred, query phred]."""
    mt, xt = malde_tables()
    return tuple(torch.from_numpy(t.astype(np.float32)).to(device) for t in (mt, xt))


def malde_rows(device) -> tuple[torch.Tensor, torch.Tensor]:
    """The match and mismatch rows at the pinned reference quality
    (phred42 max, the reference's rule), f32 ``(64,)`` on ``device``."""
    mt, xt = _malde(str(device))
    return mt[PHRED42_MAX], xt[PHRED42_MAX]


def _qual_scores(ref, query, qq, mrow, xrow):
    """Pinned-quality scores: s[b, i, j] = mrow[qq[b, i]] on a match,
    xrow[qq[b, i]] otherwise; a phred outside 0..63 scores 0 (the TPU
    kernel's one-hot decode)."""
    ok = (qq >= 0) & (qq < 64)
    idx = qq.long().clamp(0, 63)
    sm = torch.where(ok, mrow[idx], 0.0)[:, :, None]
    sx = torch.where(ok, xrow[idx], 0.0)[:, :, None]
    return torch.where(query[:, :, None] == ref[:, None, :], sm, sx)


def _substitution_scores(ref, query, ref_qual=None, query_qual=None, use_quality=False):
    """s[b, i, j] for query i vs ref j; ref/query are uint8 (B, R)/(B, Q).
    Integer scheme: 0 on a match, -1 otherwise.  Quality scheme: the
    quantised Malde tables gathered at [ref phred, query phred], with
    ``ref_qual=None`` meaning every reference phred pinned to phred42 max."""
    eq = query[:, :, None] == ref[:, None, :]
    if not use_quality:
        return torch.where(eq, 0.0, -1.0).to(torch.float32)
    if ref_qual is None:
        return _qual_scores(ref, query, query_qual, *malde_rows(ref.device))
    mt, xt = _malde(str(ref.device))
    idx = ref_qual[:, None, :].long() * mt.shape[1] + query_qual[:, :, None].long()
    return torch.where(eq, mt.reshape(-1)[idx], xt.reshape(-1)[idx])


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
    steps past the end of the walk emit the 127 filler.  The plain version
    of the traceback kernel (``realign_traceback.traceback_batch``), which
    runs it on CPU tensors, and the reference for it on the card.

    As the scan's one-hot sums, an index outside the run reads 0: a flat
    cell index outside ``[0, (Q+1)*(R+1))`` (a column past R aliases into
    the next row), a query index outside ``[0, Q)`` and a reference index
    outside ``[0, R)``.  The split route's lengths never reach them; a
    trace of arbitrary bytes, or ``m``, ``n`` outside the run, do."""
    B = trace.shape[0]
    dev = trace.device
    stride = R + 1
    cells = (Q + 1) * stride
    zero = torch.zeros((B, 1), dtype=torch.uint8, device=dev)
    # each row padded with one 0, the value every index outside it reads
    flat = torch.cat([trace.reshape(B, -1), zero], 1).to(torch.int64)
    qpad = torch.cat([query, zero], 1)
    rpad = torch.cat([ref, zero], 1)

    def inside(idx, size: int):
        return torch.where((idx >= 0) & (idx < size), idx, size)[:, None]

    i = m.to(torch.int64)
    j = n.to(torch.int64)
    state = torch.zeros(B, dtype=torch.int64, device=dev)
    k = torch.zeros(B, dtype=torch.int64, device=dev)
    emits = []
    for _ in range(R + Q):
        done = (i == 0) & (j == 0)
        cell = flat.gather(1, inside(i * stride + j, cells))[:, 0]
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

        qc = qpad.gather(1, inside(i - 1, Q))[:, 0]
        rc = rpad.gather(1, inside(j - 1, R))[:, 0]
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


def fill_dispatch(sub, m, n, go, ge, R: int, Q: int):
    """DP fill of the split route: K2 (``realign_pallas.fill_batch``) on
    CUDA tensors, the plain ``_fill_batch`` on CPU tensors.  The port does
    not read ``PANVC3_PALLAS_FILL``: that opt-in guards a TPU compiler
    stall."""
    return fill_batch(sub, m, n, go, ge, R, Q)


def _use_fused_pallas() -> bool:
    """``PANVC3_PALLAS_FUSED=0`` selects the split route (K2's fill, then
    the traceback kernel); unset or ``1`` selects K1."""
    return os.environ.get("PANVC3_PALLAS_FUSED") != "0"


def _dp(ref, query, m, n, go, ge, R: int, Q: int, sub=None, qual=None):
    """One batch of runs through K1, or through the split route under
    ``PANVC3_PALLAS_FUSED=0``; scoring as ``realign_fused`` takes it
    (integer, ``qual=(qq, mrow, xrow)`` or ``sub``).  Returns (ops, count)."""
    if _use_fused_pallas():
        return realign_fused(ref, query, m, n, go, ge, R, Q, sub=sub, qual=qual)
    if sub is None:
        sub = _qual_scores(ref, query, *qual) if qual is not None else _substitution_scores(ref, query)
    trace = fill_dispatch(sub, m, n, go, ge, R, Q)
    return traceback_batch(trace, ref, query, m, n, R, Q)


def _qual_dp(ref, query, qq, ql, rl, go, ge, R: int, Q: int):
    """Quality-scored DP with pinned reference qualities (gap costs arrive
    scaled by ``MALDE_SCALE``)."""
    rows = malde_rows(ref.device)
    return _dp(ref, query, ql, rl, go, ge, R, Q, qual=(qq.to(torch.int32).contiguous(), *rows))


def realign_device_kernel(
    ref, query, ref_len, query_len, go, ge, ref_qual, query_qual,
    use_quality: bool, R: int, Q: int,
):
    """Unwired DP dispatch: ref/query uint8 (B, R)/(B, Q), lengths int32
    (B,).  Quality scoring with ``ref_qual=None`` (the reference's pinned
    rule) runs K1's quality entry; an explicit ``ref_qual`` (B, R) runs its
    substitution entry at any R, Q."""
    if use_quality and ref_qual is None:
        return _qual_dp(ref, query, query_qual, query_len, ref_len, go, ge, R, Q)
    sub = (
        _substitution_scores(ref, query, ref_qual, query_qual, True).contiguous()
        if use_quality
        else None
    )
    return _dp(ref, query, query_len, ref_len, go, ge, R, Q, sub=sub)


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
    ops, count = _dp(ref, query, ql, rl, go, ge, R, Q)
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
    ops, count = _dp(ref, query, ql, rl, go, ge, R, Q)
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
    ops, count = _dp(ref, query, ql, rl, go, ge, R, Q)
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


# ---------------------------------------------------------------------------
# Quality (-q) wires: the layouts of their integer twins plus the query
# phreds (reference qualities are pinned to phred42 max, so none ship).
# Output is the 2-bit packed traceback (steps % 4 == 0 and steps < 256).
# Gap costs arrive scaled by MALDE_SCALE.  Input rows:
#   classic    (R + 2Q + 4 B): [ref R | query Q | qq u8 Q | rl u16 | ql u16]
#   ref-gather (Q/2 + Q + 8 B): [query codes | qq u8 | start u32 | rl | ql]
#   2-bit      (Q/4 + 3Q/4 + 6 B): [codes 2-bit | qq 6-bit packed | start
#              u32 | rl u8 | ql u8]
# ---------------------------------------------------------------------------


def pack_realign_wire_input_q(
    ref: np.ndarray, query: np.ndarray, rl: np.ndarray, ql: np.ndarray,
    qq: np.ndarray,
) -> np.ndarray:
    s, r = ref.shape
    q = query.shape[1]
    out = np.empty((s, r + 2 * q + 4), dtype=np.uint8)
    out[:, :r] = ref
    out[:, r:r + q] = query
    out[:, r + q:r + 2 * q] = qq
    out[:, r + 2 * q:r + 2 * q + 2] = (
        rl.astype("<u2").view(np.uint8).reshape(s, 2)
    )
    out[:, r + 2 * q + 2:] = ql.astype("<u2").view(np.uint8).reshape(s, 2)
    return out


def _realign_wire_q(packed_in, go, ge, R: int, Q: int):
    p = packed_in
    ref = p[:, :R].contiguous()
    query = p[:, R:R + Q].contiguous()
    qq = p[:, R + Q:R + 2 * Q]
    rl = _u16(p[:, R + 2 * Q], p[:, R + 2 * Q + 1])
    ql = _u16(p[:, R + 2 * Q + 2], p[:, R + 2 * Q + 3])
    ops, count = _qual_dp(ref, query, qq, ql, rl, go, ge, R, Q)
    return _pack_ops_2bit(ops, count)


def pack_realign_refgather_input_q(
    query: np.ndarray, start: np.ndarray, rl: np.ndarray, ql: np.ndarray,
    qq: np.ndarray,
) -> np.ndarray:
    s, q = query.shape
    codes = QUERY_CODE[query]
    half = q // 2
    out = np.empty((s, half + q + 8), dtype=np.uint8)
    out[:, :half] = codes[:, 0::2] | (codes[:, 1::2] << 4)
    out[:, half:half + q] = qq
    out[:, half + q:half + q + 4] = (
        start.astype("<u4").view(np.uint8).reshape(s, 4)
    )
    out[:, half + q + 4:half + q + 6] = (
        rl.astype("<u2").view(np.uint8).reshape(s, 2)
    )
    out[:, half + q + 6:] = ql.astype("<u2").view(np.uint8).reshape(s, 2)
    return out


def _realign_wire_refgather_q(packed_in, ref_flat, go, ge, R: int, Q: int):
    p = packed_in
    half = Q // 2
    query = _decode_query_codes(p[:, :half], Q)
    qq = p[:, half:half + Q]
    tail = p[:, half + Q:]
    start = _u32(tail[:, 0:4])
    rl = _u16(tail[:, 4], tail[:, 5])
    ql = _u16(tail[:, 6], tail[:, 7])
    ref = _gather_ref(ref_flat, start, rl, R)
    ops, count = _qual_dp(ref, query, qq, ql, rl, go, ge, R, Q)
    return _pack_ops_2bit(ops, count)


def pack_realign_refgather2_input_q(
    query: np.ndarray, start: np.ndarray, rl: np.ndarray, ql: np.ndarray,
    qq: np.ndarray,
) -> np.ndarray:
    """Query phreds are 6-bit (the Malde tables have 64 rows), so four
    pack into three bytes; the caller checks every phred is < 64."""
    s, q = query.shape
    codes = QUERY_CODE2[query] & 3
    quarter = q // 4
    out = np.empty((s, quarter + 3 * quarter + 6), dtype=np.uint8)
    out[:, :quarter] = (
        codes[:, 0::4]
        | (codes[:, 1::4] << 2)
        | (codes[:, 2::4] << 4)
        | (codes[:, 3::4] << 6)
    )
    v = qq.astype(np.uint8)
    v0, v1, v2, v3 = v[:, 0::4], v[:, 1::4], v[:, 2::4], v[:, 3::4]
    out[:, quarter + 0:quarter + 3 * quarter:3] = v0 | (v1 << 6)
    out[:, quarter + 1:quarter + 3 * quarter:3] = (v1 >> 2) | (v2 << 4)
    out[:, quarter + 2:quarter + 3 * quarter:3] = (v2 >> 4) | (v3 << 2)
    out[:, 4 * quarter:4 * quarter + 4] = (
        start.astype("<u4").view(np.uint8).reshape(s, 4)
    )
    out[:, 4 * quarter + 4] = rl.astype(np.uint8)
    out[:, 4 * quarter + 5] = ql.astype(np.uint8)
    return out


def _realign_wire_refgather2_q(packed_in, ref_flat, go, ge, R: int, Q: int):
    p = packed_in
    quarter = Q // 4
    tail = p[:, 4 * quarter:]
    start = _u32(tail[:, 0:4])
    rl = tail[:, 4].to(torch.int32)
    ql = tail[:, 5].to(torch.int32)
    query = _decode_query_codes2(p[:, :quarter], Q, ql)
    # 6-bit phreds, four in three bytes; lanes past ql decode to 0
    qb = p[:, quarter:4 * quarter].to(torch.int32)
    b0, b1, b2 = qb[:, 0::3], qb[:, 1::3], qb[:, 2::3]
    qq = torch.empty((p.shape[0], Q), dtype=torch.int32, device=p.device)
    qq[:, 0::4] = b0 & 63
    qq[:, 1::4] = (b0 >> 6) | ((b1 & 15) << 2)
    qq[:, 2::4] = (b1 >> 4) | ((b2 & 3) << 4)
    qq[:, 3::4] = b2 >> 2
    lane = torch.arange(Q, dtype=torch.int32, device=p.device)[None, :]
    qq = torch.where(lane < ql[:, None], qq, 0)
    ref = _gather_ref(ref_flat, start, rl, R)
    ops, count = _qual_dp(ref, query, qq, ql, rl, go, ge, R, Q)
    return _pack_ops_2bit(ops, count)


# ---------------------------------------------------------------------------
# Batch realignment of byte strings (the library entry point).
# ---------------------------------------------------------------------------

#: Sentinel for ``ref_quals``: reference qualities pinned to phred42 max
#: (the production rule) without per-run arrays.
PINNED_REF_QUALS = object()


def realign_batch(
    refs: list[bytes],
    queries: list[bytes],
    gap_opening: int,
    gap_extension: int,
    ref_quals=None,
    query_quals=None,
    pad_ref: int | None = None,
    pad_query: int | None = None,
    *,
    device="cuda",
) -> list[Cigar]:
    """Align each (ref, query) pair on ``device`` (``'cuda'``, the default,
    raises without a card; ``'cpu'`` runs the plain versions); returns
    collapsed per-run CIGARs."""
    return realign_batch_finish(
        realign_batch_start(
            refs, queries, gap_opening, gap_extension, ref_quals,
            query_quals, pad_ref, pad_query, device=device,
        )
    )


def realign_batch_start(
    refs: list[bytes],
    queries: list[bytes],
    gap_opening: int,
    gap_extension: int,
    ref_quals=None,
    query_quals=None,
    pad_ref: int | None = None,
    pad_query: int | None = None,
    *,
    device="cuda",
):
    """Dispatch one batch; finish with :func:`realign_batch_finish`.
    ``ref_quals`` (per-run phred arrays, or ``PINNED_REF_QUALS``) turns on
    quality scoring with ``query_quals``.  Small batches run the host C DP
    (``PANVC3_HOST_DP``, ``PANVC3_HOST_DP_CELLS``); the others go to
    ``device``: K1's quality entry when every reference phred is pinned,
    its substitution entry for explicit ones.  ``device`` as for
    :func:`realign_batch`; it is resolved first, so a missing card raises
    whichever lane the batch would take."""
    dev = resolve_device(device)
    b = len(refs)
    if b == 0:
        return None
    R = pad_ref if pad_ref is not None else max(1, max(len(r) for r in refs))
    Q = pad_query if pad_query is not None else max(1, max(len(q) for q in queries))
    ref_arr = np.zeros((b, R), dtype=np.uint8)
    q_arr = np.zeros((b, Q), dtype=np.uint8)
    use_quality = ref_quals is not None
    rq_pinned = ref_quals is PINNED_REF_QUALS
    rq = np.full((b, R), PHRED42_MAX, dtype=np.int32)
    qq = np.zeros((b, Q), dtype=np.int32)
    rl = np.zeros(b, dtype=np.int32)
    ql = np.zeros(b, dtype=np.int32)
    for i, (r, q) in enumerate(zip(refs, queries)):
        ref_arr[i, :len(r)] = np.frombuffer(r, dtype=np.uint8)
        q_arr[i, :len(q)] = np.frombuffer(q, dtype=np.uint8)
        rl[i] = len(r)
        ql[i] = len(q)
        if use_quality:
            if not rq_pinned:
                rq[i, :len(r)] = ref_quals[i]
            if query_quals is not None:
                qq[i, :len(q)] = query_quals[i]
    if use_quality and R + Q > QUAL_MAX_STEPS:
        raise ValueError(
            f"quality-scored realignment run too long for the exact "
            f"quantised path (R+Q={R + Q} > {QUAL_MAX_STEPS})"
        )
    gscale = MALDE_SCALE if use_quality else 1.0
    threshold = _host_dp_threshold(gap_opening, gap_extension)
    if threshold and int(rl.astype(np.int64) @ ql.astype(np.int64)) <= threshold:
        from ..native import get_native

        extra = ()
        if use_quality:
            mt, xt = malde_tables()
            extra = (rq.tobytes(), qq.tobytes(), mt.tobytes(), xt.tobytes())
        ops_b, cnt_b = get_native().realign_runs_host(
            ref_arr.tobytes(), q_arr.tobytes(), rl.tobytes(), ql.tobytes(),
            R, Q, float(gap_opening) * gscale, float(gap_extension) * gscale,
            *extra,
        )
        return (
            np.frombuffer(ops_b, np.int8).reshape(b, R + Q),
            np.frombuffer(cnt_b, np.int32),
        )
    ref_t, q_t, rl_t, ql_t = (torch.from_numpy(a).to(dev) for a in (ref_arr, q_arr, rl, ql))
    rq_t = qq_t = None
    if use_quality:
        qq_t = torch.from_numpy(qq).to(dev)
        if not (rq == PHRED42_MAX).all():
            rq_t = torch.from_numpy(rq).to(dev)
    return realign_device_kernel(
        ref_t, q_t, rl_t, ql_t,
        np.float32(gap_opening * gscale), np.float32(gap_extension * gscale),
        rq_t, qq_t, use_quality, R, Q,
    )


def _host_dp_threshold(gap_opening, gap_extension) -> int:
    """Real-cell count up to which the host C DP replaces the device
    dispatch; 0 when the host DP is off (``PANVC3_HOST_DP=0``) or the gap
    costs are not integral."""
    if os.environ.get("PANVC3_HOST_DP") == "0":
        return 0
    if not (float(gap_opening).is_integer() and float(gap_extension).is_integer()):
        return 0
    return int(os.environ.get("PANVC3_HOST_DP_CELLS", "4000000"))


def realign_batch_finish(out) -> list[Cigar]:
    """Fetch and decode the CIGARs of a ``realign_batch_start`` dispatch."""
    if out is None:
        return []
    ops, counts = (a.cpu().numpy() if isinstance(a, torch.Tensor) else a for a in out)
    res: list[Cigar] = []
    for i in range(ops.shape[0]):
        cig: Cigar = []
        for code in ops[i, :int(counts[i])][::-1].tolist():
            ch = CODE_TO_OP[int(code)]
            if cig and cig[-1][1] == ch:
                cig[-1] = (cig[-1][0] + 1, ch)
            else:
                cig.append((1, ch))
        res.append(cig)
    return res
