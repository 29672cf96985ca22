"""Plain reference of ``project_alignments --use-read-base-qualities``
(``-q``) for the benchmark's records.

It imports NumPy, the benchmark's generators and the plain reference of
integer scoring (``project_alignments.py`` beside it), and nothing of the
program.  Every field and tag of a line is that reference's, the CIGAR
too, but for the runs it realigns: under ``-q`` each maximal run of
insertions and deletions that holds both is aligned again, globally,
with affine gaps, scored by the base qualities as the reference tool
scores them (``include/panvc3/align.hh``): Malde (2008)'s combined error
of the two bases' error rates,

    e = 10 ** (-phred / 10),  c = e_ref + e_query - e_ref / 3 * e_query * 4,
    match 2 + log2(1 - c),  mismatch 2 - log2(3) + log2(c),

with the reference bases' qualities pinned at phred42's maximum (41) and
the query bases' the record's own QUAL, clamped to 0..41.  The
configuration states those scores quantised to 1/256 units: each one
computed here in float64, times 256, rounded to the nearest integer; a
gap of g bases costs ``(open + g * extend) * 256``.  Ties go diagonal,
then insertion, then deletion, and opening before extending.  With
``shift=None`` the scores stay in float64, unrounded, as the upstream
tool adds them: the departure the configuration states, measured by
``portbench/control_q.py``.

Run as a script (``python3 portbench/reference/project_alignments_q.py
JOB``), it judges the lines that the run kept and prints one JSON line.
"""

from __future__ import annotations

import json
import pathlib
import sys

import numpy as np

if __package__ in (None, ""):
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from harness import traffic  # noqa: E402
from harness.modules import PROGRAM, forbidden_loaded  # noqa: E402
from reference import project_alignments as base  # noqa: E402

QUALITY_FLAG = "--use-read-base-qualities"
MALDE_SHIFT = 8  # the configuration's quantisation: 1/256 units
PHRED_ROWS = 64  # the tables' rows and columns, phreds 0..63
PINNED = 41  # phred42's maximum: every reference base's quality
NEG = -(1 << 40)


def malde_tables(shift: int | None = MALDE_SHIFT) -> tuple[np.ndarray, np.ndarray]:
    """The (match, mismatch) scores of every pair of phreds, [reference
    phred, query phred], in 1/2**shift units: the formula in float64,
    rounded to the nearest integer; with ``shift=None``, the formula's
    float64 values."""
    phred = np.arange(PHRED_ROWS, dtype=np.float64)
    lhs_e = (1.0 / 10.0 ** (phred / 10.0))[:, None]
    rhs_e = (1.0 / 10.0 ** (phred / 10.0))[None, :]
    combined = lhs_e + rhs_e - lhs_e / 3.0 * rhs_e * 4.0
    match = 2.0 + np.log2(1.0 - combined)
    mismatch = 2.0 - np.log2(3.0) + np.log2(combined)
    if shift is None:
        return match, mismatch
    scale = float(1 << shift)
    return np.round(match * scale).astype(np.int64), np.round(mismatch * scale).astype(np.int64)


def align_runs(refs: list[bytes], queries: list[bytes], phreds: list[np.ndarray],
               gap_open: int, gap_extend: int, match_row: np.ndarray,
               mismatch_row: np.ndarray) -> list[list[tuple[int, str]]]:
    """Global affine-gap alignment of each (ref, query) pair, all pairs in
    one DP padded to the longest: a query base scores ``match_row`` or
    ``mismatch_row`` at its phred, a gap of g bases ``gap_open + g *
    gap_extend``, added in the rows' type (integers, or float64).  The
    ops of each pair, ``I`` a query base against a gap, ``D`` a reference
    base against one; ties diagonal, insertion, deletion, and opening
    before extending."""
    k = len(refs)
    if k == 0:
        return []
    # cells past a pair's own lengths hold padding; no cell within them
    # reads one, so the padding's values do not matter
    m_len = np.array([len(q) for q in queries])
    n_len = np.array([len(r) for r in refs])
    m, n = int(m_len.max()), int(n_len.max())
    q = np.zeros((k, m), np.int16)
    r = np.zeros((k, n), np.int16)
    kind = match_row.dtype
    on_match = np.zeros((k, m), kind)
    on_mismatch = np.zeros((k, m), kind)
    for i, (ref, qry, phred) in enumerate(zip(refs, queries, phreds)):
        q[i, :len(qry)] = np.frombuffer(qry, np.uint8)
        r[i, :len(ref)] = np.frombuffer(ref, np.uint8)
        on_match[i, :len(qry)] = match_row[phred]
        on_mismatch[i, :len(qry)] = mismatch_row[phred]
    go, ge = kind.type(gap_open), kind.type(gap_extend)
    best = np.full((m + 1, n + 1, k), NEG, kind)
    vert = np.full((m + 1, n + 1, k), NEG, kind)
    horiz = np.full((m + 1, n + 1, k), NEG, kind)
    trace = np.zeros((m + 1, n + 1, k), np.int8)
    v_open = np.zeros((m + 1, n + 1, k), bool)
    h_open = np.zeros((m + 1, n + 1, k), bool)
    best[0, 0] = 0
    for j in range(1, n + 1):
        horiz[0, j] = best[0, j] = go + j * ge
        trace[0, j] = base.HORIZ
        h_open[0, j] = j == 1
    for i in range(1, m + 1):
        vert[i, 0] = best[i, 0] = go + i * ge
        trace[i, 0] = base.VERT
        v_open[i, 0] = i == 1
    for i in range(1, m + 1):
        qi = q[:, i - 1]
        for j in range(1, n + 1):
            vo, ve = best[i - 1, j] + go + ge, vert[i - 1, j] + ge
            ho, he = best[i, j - 1] + go + ge, horiz[i, j - 1] + ge
            v_open[i, j] = vo >= ve
            h_open[i, j] = ho >= he
            v = vert[i, j] = np.maximum(vo, ve)
            h = horiz[i, j] = np.maximum(ho, he)
            b = best[i - 1, j - 1] + np.where(qi == r[:, j - 1], on_match[:, i - 1],
                                              on_mismatch[:, i - 1])
            t = np.zeros(k, np.int8)
            pick = v > b
            b, t = np.where(pick, v, b), np.where(pick, base.VERT, t)
            pick = h > b
            b, t = np.where(pick, h, b), np.where(pick, base.HORIZ, t)
            best[i, j] = b
            trace[i, j] = t
    out = []
    for x in range(k):
        i, j = int(m_len[x]), int(n_len[x])
        rev: list[str] = []
        state = "M"
        while i > 0 or j > 0:
            if state == "M":
                if i == 0:
                    state = "H"
                elif j == 0:
                    state = "V"
                elif trace[i, j, x] == base.DIAG:
                    rev.append("=" if queries[x][i - 1] == refs[x][j - 1] else "X")
                    i, j = i - 1, j - 1
                else:
                    state = "V" if trace[i, j, x] == base.VERT else "H"
            elif state == "V":
                rev.append("I")
                state = "M" if v_open[i, j, x] else "V"
                i -= 1
            else:
                rev.append("D")
                state = "M" if h_open[i, j, x] else "H"
                j -= 1
        ops: list = []
        for op in reversed(rev):
            base._push(ops, op, 1)
        out.append(ops)
    return out


def options(argv: list[str]) -> dict:
    """The configuration's options, as the integer reference reads them;
    without ``--use-read-base-qualities`` this reference does not apply,
    and any other option that reference does not model is refused."""
    if QUALITY_FLAG not in argv:
        raise ValueError(f"this reference models {QUALITY_FLAG} only")
    return base.options([a for a in argv if a != QUALITY_FLAG])


def realigned_runs(inputs: base.Inputs, records: int):
    """Of the first ``records`` records of ``inputs``: each one's CIGAR as
    the tool rewrites it and its runs to realign, and the (reference
    bases, query bases, query phreds) of every run, in order."""
    p = inputs.pool
    rewritten, runs, refs, queries, phreds = [], [], [], [], []
    for i in range(records):
        cigar = [(int(c), chr(traffic.OPS[o]))
                 for o, c in zip(p["ops"][i].tolist(), p["counts"][i].tolist()) if c]
        read = p["seq"][i].tobytes()
        ops = base.rewrite(cigar, read, inputs.ref_seq, inputs.excess[i], inputs.ref_gap[i])
        rewritten.append(ops)
        runs.append(base.indel_runs(ops, int(inputs.excess[i, 0])))
        phred = np.clip(p["qual"][i].astype(np.int64) - 33, 0, PINNED)
        for _, _, r0, rl, q0, ql, _ in runs[-1]:
            refs.append(inputs.ref_seq[r0:r0 + rl].tobytes())
            queries.append(read[q0:q0 + ql])
            phreds.append(phred[q0:q0 + ql])
    return rewritten, runs, refs, queries, phreds


def expected_lines(inputs: base.Inputs, config: dict, traffic_mix: dict, record_index: np.ndarray,
                   shift: int | None = MALDE_SHIFT) -> list[tuple[list[str], set[str]]]:
    """(fields 1-11, tags) of the line the tool writes for each sampled
    record; ``record_index[i]`` is its place in the call's input.  The
    scores are quantised to 1/2**``shift`` units (the configuration
    states 8), or with ``shift=None`` kept in float64."""
    opts = options(config["tool_argv"])
    integer = dict(config, tool_argv=[a for a in config["tool_argv"] if a != QUALITY_FLAG])
    lines = base.expected_lines(inputs, integer, traffic_mix, record_index)
    rewritten, runs, refs, queries, phreds = realigned_runs(inputs, len(record_index))
    match, mismatch = malde_tables(shift)
    scale = 1 if shift is None else 1 << shift
    aligned = iter(align_runs(refs, queries, phreds, int(opts["gap-opening-cost"]) * scale,
                              int(opts["gap-extension-cost"]) * scale, match[PINNED], mismatch[PINNED]))
    for (fields, _), ops, record_runs in zip(lines, rewritten, runs):
        if not record_runs:
            continue
        final: list = []
        cut = 0
        for lo, hi, *_ in record_runs:
            for c, op in ops[cut:lo]:
                base._push(final, op, c)
            for c, op in next(aligned):
                base._push(final, op, c)
            cut = hi
        for c, op in ops[cut:]:
            base._push(final, op, c)
        fields[5] = "".join(f"{c}{op}" for c, op in final)
    return lines


def main(argv: list[str]) -> int:
    job = json.loads(pathlib.Path(argv[0]).read_text())
    kept = json.loads(pathlib.Path(job["kept"]).read_text())
    positions = np.array([at for _, at, _ in kept["lines"]], np.int64)
    unique = np.unique(positions)
    pool_index = unique % int(job["traffic"]["pool_records"])
    inputs = base.Inputs(job["seed"], job["config"], job["traffic"], pool_index, pathlib.Path(job["bench"]))
    exp = expected_lines(inputs, job["config"], job["traffic"], unique)
    expected = dict(zip(unique.tolist(), exp))
    compared, wrong, first = base.judge([line for _, _, line in kept["lines"]], positions, expected)
    problems = base.header_problems(kept["header"], job["config"], inputs.row_lengths[0])
    bad = forbidden_loaded((PROGRAM,))
    print(json.dumps({
        "compared": compared, "wrong": wrong, "first_wrong": first,
        "header_problems": problems, "forbidden_modules": bad,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
