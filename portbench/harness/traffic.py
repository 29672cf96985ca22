"""The record pool of a traffic mix, made from a seed.

A mix (``portbench/traffic/<name>.json``) describes read pairs as the
source's test reads were simulated, with every number taken from those
reads (``workflows/test-workflow/data/reads``): the read length, the
fragment lengths (each the outer length of a pair both of whose mates the
simulator mapped), the sequencing errors a read carries (the simulator's
``XE`` counts: substitutions only, no indels) and the reads' quality
strings (a file of the mix's own).

Each pair is drawn from a founder row, the rows taken evenly, at an even
place along it, forward or reverse in equal numbers.  It is then placed as
``bowtie2 -k K`` in end-to-end mode reports it: on every MSA row where
both mates align, each mate by the alignment the MSA implies (a base over
a gap of that row is an insertion, bases of that row between two of the
read's columns a deletion), scored by bowtie2's defaults (mismatch 2 to 6
by base quality, a gap of k bases 5 + 3k on either side), kept where each
mate scores at least ``-0.6 - 0.6 * read length`` and the fragment is at
most 500 bases, the best pair score first (ties in an order drawn from
the seed), at most K of them, the first primary and the rest secondary
(0x100).  Each record carries bowtie2's tags but ``MD``: ``AS``, ``XS``
(the best score of the mate's other placements, where it has one),
``XN``, ``XM``, ``XO``, ``XG``, ``NM``, ``YS`` and ``YT:Z:CP``.  The pool
is a fixed number of records, the placements of as many pairs as fill it
(the last pair's lowest placements left out), position-sorted as the
workflows' ``samtools sort`` leaves it.
"""

from __future__ import annotations

import concurrent.futures as cf
import pathlib

import numpy as np

from .msa import ACGT, Msa

FLAG_PAIRED, FLAG_PROPER, FLAG_REVERSE, FLAG_MATE_REVERSE = 0x1, 0x2, 0x10, 0x20
FLAG_FIRST, FLAG_SECOND, FLAG_SECONDARY = 0x40, 0x80, 0x100
OPS = np.frombuffer(b"MID", np.uint8)  # op codes 0, 1, 2 of the pool's CIGARs
M, I, D = 0, 1, 2


class Rows:
    """What placing reads needs of each MSA row: its gaps, its bases
    (0-3), the column of each of its bases, and the number of its bases
    before each column."""

    def __init__(self, msa: Msa):
        self.gap, self.base, self.cols, self.rank = [], [], [], []
        for r in range(msa.n_rows):
            gap = msa.gap(r)
            self.gap.append(gap)
            self.base.append(msa.base_index(r))
            self.cols.append(np.flatnonzero(~gap).astype(np.int32))
            self.rank.append((np.cumsum(~gap, dtype=np.int32) - ~gap).astype(np.int32))

    @property
    def lengths(self) -> np.ndarray:
        return np.array([len(c) for c in self.cols])


def _even(rng, values, n: int) -> np.ndarray:
    """``n`` of ``values``, each taken equally often (to one), shuffled."""
    return rng.permutation(np.resize(np.asarray(values), n))


def qualities(mix: dict, traffic_dir: pathlib.Path) -> np.ndarray:
    """(reads, length) uint8: the mix's quality strings."""
    text = (traffic_dir / mix["qualities"]).read_bytes().split(b"\n")
    out = np.stack([np.frombuffer(q, np.uint8) for q in text if q])
    if out.shape[1] != int(mix["read_length"]):
        raise ValueError("the quality strings are not read_length long")
    return out


def run_length(op: np.ndarray, count: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Each row's tokens (op, count) with the zero counts left out and
    neighbours of one op merged: (ops, counts), (n, K), zero counts past
    each row's end."""
    n, w = op.shape
    keep = count > 0
    last = np.maximum.accumulate(np.where(keep, np.arange(w)[None, :], -1), axis=1)
    prev = np.concatenate([np.full((n, 1), -1), last[:, :-1]], axis=1)
    prev_op = np.where(prev >= 0, np.take_along_axis(op, np.maximum(prev, 0), axis=1), 255)
    new = keep & (op != prev_op)
    run = np.cumsum(new, axis=1) - 1
    k = max(int(new.sum(axis=1).max()), 1)
    flat = (np.arange(n)[:, None] * k + run)[keep]
    counts = np.bincount(flat, weights=count[keep], minlength=n * k).astype(np.int32).reshape(n, k)
    ops = np.zeros(n * k, np.uint8)
    ops[(np.arange(n)[:, None] * k + run)[new]] = op[new]
    return ops.reshape(n, k), counts


def place(rows: Rows, j: int, col: np.ndarray, read: np.ndarray, phred: np.ndarray,
          aligner: dict) -> dict:
    """Every read (its bases' columns ``col``, bases ``read`` as 0-3,
    qualities ``phred``) on row ``j`` by the alignment the MSA implies."""
    gap = rows.gap[j][col]
    rank = rows.rank[j][col]
    dele = rank[:, 1:] - rank[:, :-1] - (~gap[:, :-1])
    n, length = col.shape
    mx, mn = aligner["mismatch"]
    pen = mn + np.floor((mx - mn) * np.minimum(phred, 40) / 40.0 + 0.5).astype(np.int32)
    mism = ~gap & (read != rows.base[j][col])
    gap_open, gap_extend = aligner["gap"]
    # an insertion opens where a gap base follows a base or a deletion
    opens = gap.copy()
    opens[:, 1:] &= ~gap[:, :-1] | (dele > 0)
    n_open = opens.sum(axis=1) + (dele > 0).sum(axis=1)
    gap_bases = gap.sum(axis=1) + dele.sum(axis=1)
    score = -((pen * mism).sum(axis=1) + gap_open * n_open + gap_extend * gap_bases)
    lo, per_base = aligner["min_score"]
    fits = ~gap[:, 0] & ~gap[:, -1] & (score >= lo + per_base * length)
    # the CIGAR: length M where nothing is a gap; else the tokens, a base
    # (M or I) and the deletion after it, merged
    ops = np.zeros((n, 1), np.uint8)
    counts = np.full((n, 1), length, np.int32)
    some = np.flatnonzero(fits & (n_open > 0))
    if len(some):
        tok_op = np.empty((len(some), 2 * length - 1), np.uint8)
        tok_count = np.empty((len(some), 2 * length - 1), np.int32)
        tok_op[:, 0::2] = np.where(gap[some], I, M)
        tok_count[:, 0::2] = 1
        tok_op[:, 1::2] = D
        tok_count[:, 1::2] = dele[some]
        some_ops, some_counts = run_length(tok_op, tok_count)
        width = some_ops.shape[1]
        ops = np.pad(ops, ((0, 0), (0, width - 1)))
        counts = np.pad(counts, ((0, 0), (0, width - 1)))
        ops[some], counts[some] = some_ops, some_counts
    n_mism = mism.sum(axis=1)
    # carried to the reference row, a base over a gap of this row or of the
    # reference is an insertion; the reference's bases between two of the
    # read's columns, and under a base this row lacks, are deletions; the
    # tool realigns where an insertion and a deletion meet
    ref_gap = rows.gap[0][col]
    ref_rank = rows.rank[0][col]
    inserted = gap | ref_gap
    between = ref_rank[:, 1:] - ref_rank[:, :-1] - (~ref_gap[:, :-1])
    realigns = (gap & ~ref_gap).any(axis=1) | (
        (between > 0) & (inserted[:, :-1] | inserted[:, 1:])).any(axis=1)
    return {
        "fits": fits, "pos": rank[:, 0].astype(np.int64), "ops": ops, "counts": counts,
        "AS": score.astype(np.int64), "XM": n_mism, "XO": n_open, "XG": gap_bases,
        "NM": n_mism + gap_bases, "span": length - gap.sum(axis=1) + dele.sum(axis=1),
        "realigns": realigns,
    }


def _pairs(rng, rows: Rows, mix: dict, quals: np.ndarray, n_pairs: int, k: int):
    """``n_pairs`` pairs and where they are reported: (the reads, each
    row's placements, each pair's rows in report order (its first ``k``),
    which of those it is reported on, the rows it is reported on, the
    fragment's outer length on each row)."""
    length = int(mix["read_length"])
    founders = np.arange(1, len(rows.cols))
    src = _even(rng, founders, n_pairs)
    frag = _even(rng, mix["fragment_lengths"], n_pairs)
    reverse = _even(rng, [False, True], n_pairs)
    room = rows.lengths[src] - frag + 1
    start = (rng.random(n_pairs) * room).astype(np.int64)
    # reads 2i (left) and 2i + 1 (right) of pair i
    read_src = np.repeat(src, 2)
    spos = np.stack([start, start + frag - length], axis=1).reshape(-1)
    col = np.empty((2 * n_pairs, length), np.int32)
    base = np.empty((2 * n_pairs, length), np.uint8)
    t = np.arange(length)
    for r in founders.tolist():
        sel = np.flatnonzero(read_src == r)
        col[sel] = rows.cols[r][spos[sel, None] + t[None, :]]
        base[sel] = rows.base[r][col[sel]]
    errors = np.repeat(np.array([int(e) for e in mix["errors_per_read"]]),
                       np.array(list(mix["errors_per_read"].values())))
    n_err = _even(rng, errors, 2 * n_pairs)
    most = int(errors.max())
    draw = rng.random((2 * n_pairs, length))
    if most:
        kth = np.sort(np.partition(draw, most - 1, axis=1)[:, :most], axis=1)
        where = (n_err[:, None] > 0) & (draw <= kth[np.arange(len(draw)), np.maximum(n_err, 1) - 1][:, None])
    else:
        where = np.zeros(draw.shape, bool)
    base = np.where(where, (base + rng.integers(1, 4, base.shape, dtype=np.uint8)) & 3, base)
    qual = quals[_even(rng, np.arange(len(quals)), 2 * n_pairs)]
    phred = qual.astype(np.int64) - 33
    with cf.ThreadPoolExecutor(len(rows.cols)) as pool:
        placed = list(pool.map(lambda j: place(rows, j, col, base, phred, mix["aligner"]),
                               range(len(rows.cols))))

    n_rows = len(placed)
    left, right = slice(0, None, 2), slice(1, None, 2)
    fits = np.stack([p["fits"][left] & p["fits"][right] for p in placed], axis=1)
    outer = np.stack([p["pos"][right] + p["span"][right] - p["pos"][left] for p in placed], axis=1)
    fits &= outer <= int(mix["aligner"]["max_fragment"])
    total = np.stack([p["AS"][left] + p["AS"][right] for p in placed], axis=1)
    tie = rng.random((n_pairs, n_rows))
    order = _row_order(tie, total, fits)[:, :k]
    kept = np.take_along_axis(fits, order, axis=1)
    on = np.zeros((n_pairs, n_rows), bool)
    np.put_along_axis(on, order, kept, axis=1)
    reads = {"seq": ACGT[base], "qual": qual, "reverse": reverse}
    return reads, placed, order, kept, on, outer


def _row_order(tie: np.ndarray, total: np.ndarray, fits: np.ndarray) -> np.ndarray:
    """Each pair's rows in report order: those it fits on first, the best
    pair score first, ties by ``tie``."""
    key = np.where(fits, -total.astype(np.float64), np.inf) + tie * 0.5
    return np.argsort(key, axis=1, kind="stable")


def make_pool(seed: int, mix: dict, rows: Rows, k: int, traffic_dir: pathlib.Path) -> dict:
    """The pool's records as arrays, in position order.  Keys: ``row``,
    ``pos`` (0-based), ``ops`` and ``counts`` (the CIGAR, ops 0-2 for M, I,
    D, zero counts past its end), ``n_ops``, ``flag``, ``mate_pos``,
    ``tlen``, ``pair``, ``AS``, ``XS`` (where ``has_XS``), ``XM``, ``XO``,
    ``XG``, ``NM``, ``YS``, ``seq`` and ``qual`` (ASCII, one row a
    record), ``span`` (reference bases) and ``realigns`` (whether the
    projection writes a run that the tool realigns)."""
    n = int(mix["pool_records"])
    if n <= 0 or n % 2:
        raise ValueError(f"pool_records must be a positive even number, not {n}")
    rng = np.random.default_rng([seed, 2])
    quals = qualities(mix, traffic_dir)
    need = n // 2  # placements: two records each
    chunk = max(need // 2, 16)
    parts, got, first_pair = [], 0, 0
    while got < need:
        pairs = _pairs(rng, rows, mix, quals, chunk, k)
        part = _records(*pairs, first_pair)
        take = min(len(part["row"]) // 2, need - got)
        parts.append({key: value[: 2 * take] for key, value in part.items()})
        got += take
        first_pair += chunk
        # the next chunk sized by the placements a pair has had so far
        chunk = max(int((need - got) * first_pair / got * 1.05) + 16, 16)
    width = max(p["ops"].shape[1] for p in parts)
    for p in parts:
        for key in ("ops", "counts"):
            p[key] = np.pad(p[key], ((0, 0), (0, width - p[key].shape[1])))
    pool = {key: np.concatenate([p[key] for p in parts]) for key in parts[0]}
    order = np.lexsort((np.arange(n), pool["pos"], pool["row"]))
    return {key: value[order] for key, value in pool.items()}


def _records(reads, placed, order, kept, on, outer, first_pair) -> dict:
    """The two records of each kept placement, in report order: pair by
    pair, its placements best first, the left mate first."""
    pair_idx, rank = np.nonzero(kept)
    row = order[pair_idx, rank]
    m = len(pair_idx)
    mate = np.tile([0, 1], m)
    p_rep = np.repeat(pair_idx, 2)
    r_rep = np.repeat(row, 2)
    read = 2 * p_rep + mate
    keys = ("pos", "AS", "XM", "XO", "XG", "NM", "span", "realigns")
    out = {key: np.empty(2 * m, np.int64) for key in keys + ("mate_pos", "YS")}
    out["realigns"] = np.empty(2 * m, bool)
    width = max(p["ops"].shape[1] for p in placed)
    out["ops"] = np.zeros((2 * m, width), np.uint8)
    out["counts"] = np.zeros((2 * m, width), np.int32)
    for j, p in enumerate(placed):
        sel = np.flatnonzero(r_rep == j)
        rd = read[sel]
        for key in keys:
            out[key][sel] = p[key][rd]
        out["mate_pos"][sel] = p["pos"][rd ^ 1]
        out["YS"][sel] = p["AS"][rd ^ 1]
        w = p["ops"].shape[1]
        out["ops"][sel, :w] = p["ops"][rd]
        out["counts"][sel, :w] = p["counts"][rd]
    out["n_ops"] = (out["counts"] > 0).sum(axis=1)
    # XS: the best score of the read's placements on the pair's other rows
    scores = np.stack([p["AS"] for p in placed], axis=1)[read]
    others = on[p_rep].copy()
    others[np.arange(2 * m), r_rep] = False
    out["has_XS"] = others.any(axis=1)
    out["XS"] = np.where(others, scores, np.iinfo(np.int64).min).max(axis=1)
    out["XS"][~out["has_XS"]] = 0
    reverse = reads["reverse"][p_rep]
    # forward fragments: the left mate is the first (99, 147); reverse: the
    # right one is (163, 83)
    first = (mate == 0) != reverse
    flag = (FLAG_PAIRED | FLAG_PROPER | np.where(first, FLAG_FIRST, FLAG_SECOND)
            | np.where(mate == 1, FLAG_REVERSE, FLAG_MATE_REVERSE)
            | np.where(np.repeat(rank, 2) > 0, FLAG_SECONDARY, 0))
    out["flag"] = flag.astype(np.int64)
    span = outer[p_rep, r_rep]
    out["tlen"] = np.where(mate == 0, span, -span)
    out["row"] = r_rep.astype(np.int64)
    out["pair"] = (first_pair + p_rep).astype(np.int64)
    out["seq"] = reads["seq"][read]
    out["qual"] = reads["qual"][read]
    return out

