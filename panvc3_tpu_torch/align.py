"""Affine-gap global alignment with SeqAn3-compatible traceback (the host
oracle) and the quantised Malde quality tables (copy of
``panvc3_tpu.align``, trimmed to what the port calls).

Gapped columns become per-character CIGAR ops: a gap in seq1 (the
reference slice) is I, a gap in seq2 (the query slice) D, equal characters
=, differing ones X.  Scoring is match 0 / mismatch -1, or the Malde (2008)
base-quality scheme in 1/``MALDE_SCALE`` units (unquantised float64 under
``PANVC3_MALDE_EXACT=1``, which only this host oracle honours).  A
length-g gap costs ``open + g * extend``.  Ties prefer diagonal >
vertical (I) > horizontal (D), and opening over extending.  The batched DP
of ``panvc3_tpu_torch.ops.realign_batch`` and its kernels match it
exactly.
"""

from __future__ import annotations

import math
import os

import numpy as np

from .alphabet import PHRED42_MAX
from .cigar import Cigar, CigarBuffer

NEG_INF = -1e30

# Trace codes for the best-score matrix.
_TR_DIAG = 0
_TR_VERT = 1  # consume seq2 (query)  -> 'I'
_TR_HORIZ = 2  # consume seq1 (ref)   -> 'D'
_TR_NONE = 3


def malde_score(matches: bool, lhs_phred: int, rhs_phred: int) -> float:
    """Malde (2008) combined-error score (the reference's align.hh)."""
    lhs_e = 1.0 / (10.0 ** (lhs_phred / 10.0))
    rhs_e = 1.0 / (10.0 ** (rhs_phred / 10.0))
    combined_e = lhs_e + rhs_e - lhs_e / 3.0 * rhs_e * 4.0
    if matches:
        return 2.0 + math.log2(1.0 - combined_e)
    return 2.0 - math.log2(3.0) + math.log2(combined_e)


# The quality (-q) scheme quantises Malde scores to 1/2**MALDE_SHIFT units so
# the whole affine DP runs on (small) integers: host float64 and device
# float32 arithmetic are then both exact and the two paths are byte-identical
# (the integer default scheme already has this property).  Per-base
# quantisation error is <= 2**-(MALDE_SHIFT+1), so a chosen path's true
# float64 Malde score is within (R+Q)/2**(MALDE_SHIFT+1) of the reference's
# double-DP optimum — at most co-optimal-adjacent near exact ties, the same
# deviation class as the reference's own platform-dependent double rounding.
# Bound: |score| < 12 per base, so sums stay exact in float32 for
# R+Q <= 2**24/(12*2**MALDE_SHIFT) = 5461 columns per realigned run.
MALDE_SHIFT = 8
MALDE_SCALE = float(1 << MALDE_SHIFT)
_PHRED_RANGE = 64  # phred42 values are 0..41; leave headroom


def malde_tables() -> tuple[np.ndarray, np.ndarray]:
    """Quantised (match, mismatch) score tables indexed [lhs_phred,
    rhs_phred], int32, in units of 1/MALDE_SCALE.  Computed once in float64
    (host) so device kernels gather the exact same integers."""
    global _MALDE_TABLES
    if _MALDE_TABLES is None:
        q = np.arange(_PHRED_RANGE, dtype=np.float64)
        e = 10.0 ** (-q / 10.0)
        ce = e[:, None] + e[None, :] - e[:, None] / 3.0 * e[None, :] * 4.0
        match = 2.0 + np.log2(1.0 - ce)
        mismatch = 2.0 - np.log2(3.0) + np.log2(ce)
        _MALDE_TABLES = (
            np.round(match * MALDE_SCALE).astype(np.int32),
            np.round(mismatch * MALDE_SCALE).astype(np.int32),
        )
    return _MALDE_TABLES


_MALDE_TABLES: tuple[np.ndarray, np.ndarray] | None = None


def malde_exact() -> bool:
    """PANVC3_MALDE_EXACT=1: validation-only host mode that scores the
    quality (-q) DP in unquantised float64 — the reference's exact
    arithmetic — instead of the 1/MALDE_SCALE fixed-point tables.  Only
    the host oracle honours it (device/C engines stay fixed-point); away
    from exact score ties the chosen alignment is identical."""
    return os.environ.get("PANVC3_MALDE_EXACT") == "1"


def _malde_exact_matrix(eq: np.ndarray, q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    """Float64 Malde substitution scores s[i, j] for seq2[i] vs seq1[j],
    computed with the reference's formula (no quantisation)."""
    e1 = 10.0 ** (-np.asarray(q1, np.float64) / 10.0)
    e2 = 10.0 ** (-np.asarray(q2, np.float64) / 10.0)
    ce = e1[None, :] + e2[:, None] - e1[None, :] / 3.0 * e2[:, None] * 4.0
    match = 2.0 + np.log2(1.0 - ce)
    mismatch = 2.0 - np.log2(3.0) + np.log2(ce)
    return np.where(eq, match, mismatch)


def _score_matrix(
    seq1: bytes,
    seq2: bytes,
    quals1: np.ndarray | None,
    quals2: np.ndarray | None,
) -> np.ndarray:
    """Pairwise substitution scores s[i, j] for seq2[i] vs seq1[j]."""
    a1 = np.frombuffer(seq1, dtype=np.uint8)
    a2 = np.frombuffer(seq2, dtype=np.uint8)
    eq = a2[:, None] == a1[None, :]
    if quals1 is None:
        return np.where(eq, 0.0, -1.0)
    if malde_exact():
        return _malde_exact_matrix(eq, quals1, quals2)
    # quantised Malde scheme (see malde_tables): s[i, j] in 1/MALDE_SCALE
    # units; the caller scales the gap costs to match
    mt, xt = malde_tables()
    q1 = np.asarray(quals1, dtype=np.int64)
    q2 = np.asarray(quals2, dtype=np.int64)
    match_s = mt[q1[None, :], q2[:, None]]
    mismatch_s = xt[q1[None, :], q2[:, None]]
    return np.where(eq, match_s, mismatch_s).astype(np.float64)


def align_global(
    seq1: str | bytes,
    seq2: str | bytes,
    gap_opening: int,
    gap_extension: int,
    quals1: np.ndarray | None = None,
    quals2: np.ndarray | None = None,
    destination: CigarBuffer | None = None,
) -> tuple[float, Cigar]:
    """Globally align seq1 (reference slice) and seq2 (query slice).

    When ``quals1``/``quals2`` are given, uses the Malde base-quality scheme
    (callers pin the reference qualities to the maximum by passing an
    array of PHRED42_MAX).

    Returns ``(score, cigar)`` where cigar uses per-run collapsed I/D/=/X ops.
    """
    if isinstance(seq1, str):
        seq1 = seq1.encode("latin1")
    if isinstance(seq2, str):
        seq2 = seq2.encode("latin1")
    n = len(seq1)  # horizontal, consumed by 'D'
    m = len(seq2)  # vertical, consumed by 'I'

    dst = destination if destination is not None else CigarBuffer()
    dst.clear()

    # quality mode works in quantised 1/MALDE_SCALE units throughout the DP
    # (integral values, exact in float64); the returned score is unscaled.
    # PANVC3_MALDE_EXACT=1 instead runs the DP directly in float64 Malde
    # units (validation mode — gap costs then stay unscaled).
    scale = (
        MALDE_SCALE if quals1 is not None and not malde_exact() else 1.0
    )
    go = float(gap_opening) * scale
    ge = float(gap_extension) * scale

    if n == 0 and m == 0:
        dst.finish()
        return 0.0, dst.operations
    if n == 0:
        dst.push_back("I", m)
        dst.finish()
        return (go + m * ge) / scale, dst.operations
    if m == 0:
        dst.push_back("D", n)
        dst.finish()
        return (go + n * ge) / scale, dst.operations

    s = _score_matrix(seq1, seq2, quals1, quals2)

    # DP matrices over (m+1) x (n+1); row i, col j.
    best = np.full((m + 1, n + 1), NEG_INF)
    vert = np.full((m + 1, n + 1), NEG_INF)
    horiz = np.full((m + 1, n + 1), NEG_INF)
    tr = np.full((m + 1, n + 1), _TR_NONE, dtype=np.int8)
    vert_open = np.zeros((m + 1, n + 1), dtype=bool)
    horiz_open = np.zeros((m + 1, n + 1), dtype=bool)

    best[0, 0] = 0.0
    for j in range(1, n + 1):
        horiz[0, j] = go + j * ge
        best[0, j] = horiz[0, j]
        tr[0, j] = _TR_HORIZ
        horiz_open[0, j] = j == 1
    for i in range(1, m + 1):
        vert[i, 0] = go + i * ge
        best[i, 0] = vert[i, 0]
        tr[i, 0] = _TR_VERT
        vert_open[i, 0] = i == 1

    for i in range(1, m + 1):
        for j in range(1, n + 1):
            v_open = best[i - 1, j] + go + ge
            v_ext = vert[i - 1, j] + ge
            if v_open >= v_ext:  # tie prefers opening
                vert[i, j] = v_open
                vert_open[i, j] = True
            else:
                vert[i, j] = v_ext
            h_open = best[i, j - 1] + go + ge
            h_ext = horiz[i, j - 1] + ge
            if h_open >= h_ext:
                horiz[i, j] = h_open
                horiz_open[i, j] = True
            else:
                horiz[i, j] = h_ext
            diag = best[i - 1, j - 1] + s[i - 1, j - 1]
            # tie priority: diagonal > vertical > horizontal
            b = diag
            t = _TR_DIAG
            if vert[i, j] > b:
                b = vert[i, j]
                t = _TR_VERT
            if horiz[i, j] > b:
                b = horiz[i, j]
                t = _TR_HORIZ
            best[i, j] = b
            tr[i, j] = t

    score = best[m, n]

    # Traceback.
    ops_rev: list[str] = []
    i, j = m, n
    state = "M"
    while i > 0 or j > 0:
        if state == "M":
            if i == 0:
                state = "H"
                continue
            if j == 0:
                state = "V"
                continue
            t = tr[i, j]
            if t == _TR_DIAG:
                ops_rev.append("=" if seq2[i - 1] == seq1[j - 1] else "X")
                i -= 1
                j -= 1
            elif t == _TR_VERT:
                state = "V"
            else:
                state = "H"
        elif state == "V":
            ops_rev.append("I")
            was_open = vert_open[i, j]
            i -= 1
            if was_open:
                state = "M"
        else:  # "H"
            ops_rev.append("D")
            was_open = horiz_open[i, j]
            j -= 1
            if was_open:
                state = "M"

    for op in reversed(ops_rev):
        dst.push_back(op, 1)
    dst.finish()
    return float(score) / scale, dst.operations


def max_quality_array(length: int) -> np.ndarray:
    """Array of maximal phred42 qualities (used for reference slices)."""
    return np.full(length, PHRED42_MAX, dtype=np.int32)
