"""Plain reference of ``project_alignments`` for the benchmark's records.

It imports NumPy and the benchmark's own generators and nothing of the
program.  From the seed it makes again the MSA rows and the record pool
that the run's set-up made, and for each sampled record works out the
line the tool has to write, field by field:

- RNAME and POS: the chromosome, and the record's first aligned base
  carried from its founder row to the reference row through the MSA
  columns (the number of reference bases before that column);
- the CIGAR: walked base by base through the columns.  A base where the
  reference row has a gap becomes an insertion; a reference base skipped
  between two consecutive source bases becomes a deletion; a deleted
  source base over a reference gap is dropped.  Each maximal run of
  insertions and deletions that holds both is aligned again, globally,
  with affine gaps (match 0, mismatch -1, a gap of g bases costs
  ``open + g * extend``), ties going diagonal, then insertion, then
  deletion, and opening before extending;
- RNEXT and PNEXT: the mate's position carried to the reference row the
  same way; TLEN, FLAG, MAPQ, SEQ and QUAL as they came;
- the tags: the kept ones (``AS`` and those of ``--preserve-tag``), ``OA``
  with the original alignment, the original reference and positions
  (``XR``, ``XP``, ``YR``, ``YP``), the realigned query and reference
  ranges (``XB``, ``YB``: each range's reference start is where the
  operation after the run ends, as the reference tool records it) and
  the record index (``--record-index-tag``), which is the index of the
  first record of its group of four: the reference tool projects records
  in tasks of four, and tags each with its task's first index.

Run as a script (``python3 portbench/reference/project_alignments.py
JOB``), it judges the lines that the run kept and prints one JSON line.
"""

from __future__ import annotations

import json
import pathlib
import sys

import numpy as np

if __package__ in (None, ""):
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from harness import msa, traffic  # noqa: E402
from harness.modules import PROGRAM, forbidden_loaded  # noqa: E402

NEG = -(1 << 30)
# trace codes
DIAG, VERT, HORIZ = 0, 1, 2
# the tie rules the configuration states; the control breaks them
FROZEN = "frozen"
BROKEN = "deletion_first"
TASK = 4  # records per task of the reference tool
ALWAYS_KEPT = frozenset({
    "AM", "AS", "BC", "BZ", "CB", "CO", "CR", "CS", "CT", "CY", "E2", "FZ", "LB", "MI",
    "ML", "MM", "OA", "OQ", "OX", "PG", "PU", "QT", "QX", "RX", "TS",
})


def _push(ops: list, op: str, count: int) -> None:
    if count <= 0:
        return
    if ops and ops[-1][1] == op:
        ops[-1] = (ops[-1][0] + count, op)
    else:
        ops.append((count, op))


def align_runs(refs: list[bytes], queries: list[bytes], gap_open: int, gap_extend: int,
               ties: str = FROZEN) -> list[list[tuple[int, str]]]:
    """Global affine-gap alignment of each (ref, query) pair, all pairs in
    one DP padded to the longest: the ops of each, ``I`` a query base
    against a gap, ``D`` a reference base against one.  ``ties`` is
    ``FROZEN`` (diagonal, insertion, deletion; open before extend) or
    ``BROKEN`` (deletion before insertion, and extend before open)."""
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
    for i, (ref, qry) in enumerate(zip(refs, queries)):
        q[i, :len(qry)] = np.frombuffer(qry, np.uint8)
        r[i, :len(ref)] = np.frombuffer(ref, np.uint8)
    go, ge = int(gap_open), int(gap_extend)
    best = np.full((m + 1, n + 1, k), NEG, np.int32)
    vert = np.full((m + 1, n + 1, k), NEG, np.int32)
    horiz = np.full((m + 1, n + 1, k), NEG, np.int32)
    trace = np.zeros((m + 1, n + 1, k), np.int8)
    v_open = np.zeros((m + 1, n + 1, k), bool)
    h_open = np.zeros((m + 1, n + 1, k), bool)
    best[0, 0] = 0
    for j in range(1, n + 1):
        horiz[0, j] = best[0, j] = go + j * ge
        trace[0, j] = HORIZ
        h_open[0, j] = j == 1
    for i in range(1, m + 1):
        vert[i, 0] = best[i, 0] = go + i * ge
        trace[i, 0] = VERT
        v_open[i, 0] = i == 1
    extend_first = ties == BROKEN
    for i in range(1, m + 1):
        qi = q[:, i - 1]
        for j in range(1, n + 1):
            vo, ve = best[i - 1, j] + go + ge, vert[i - 1, j] + ge
            ho, he = best[i, j - 1] + go + ge, horiz[i, j - 1] + ge
            v_open[i, j] = vo > ve if extend_first else vo >= ve
            h_open[i, j] = ho > he if extend_first else ho >= he
            v = vert[i, j] = np.maximum(vo, ve)
            h = horiz[i, j] = np.maximum(ho, he)
            diag = best[i - 1, j - 1] - (qi != r[:, j - 1])
            b = diag.copy()
            t = np.zeros(k, np.int8)
            if extend_first:
                pick = h > b
                b, t = np.where(pick, h, b), np.where(pick, HORIZ, t)
                pick = v > b
                b, t = np.where(pick, v, b), np.where(pick, VERT, t)
            else:
                pick = v > b
                b, t = np.where(pick, v, b), np.where(pick, VERT, t)
                pick = h > b
                b, t = np.where(pick, h, b), np.where(pick, HORIZ, t)
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
                elif trace[i, j, x] == DIAG:
                    rev.append("=" if queries[x][i - 1] == refs[x][j - 1] else "X")
                    i, j = i - 1, j - 1
                else:
                    state = "V" if trace[i, j, x] == VERT else "H"
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
            _push(ops, op, 1)
        out.append(ops)
    return out


def rewrite(cigar, query: bytes, ref_seq: np.ndarray, excess: np.ndarray, ref_gap: np.ndarray):
    """The CIGAR carried to the reference row.  ``excess[k]`` is the
    number of reference bases before the column of the record's k-th
    reference-consuming founder base, ``ref_gap[k]`` whether the reference
    row has a gap there."""
    ops: list = []
    prev = int(excess[0])
    k = qpos = 0
    for count, op in cigar:
        if op == "I":
            _push(ops, "I", count)
            qpos += count
            continue
        for _ in range(count):
            e = int(excess[k])
            _push(ops, "D", e - prev)
            if op in "M=":
                if ref_gap[k]:
                    _push(ops, "I", 1)
                    prev = e
                else:
                    _push(ops, "=" if query[qpos] == ref_seq[e] else "X", 1)
                    prev = e + 1
                qpos += 1
            else:  # D
                if not ref_gap[k]:
                    _push(ops, "D", 1)
                    prev = e + 1
                else:
                    prev = e
            k += 1
    return ops


def indel_runs(ops, ref_pos: int):
    """(op start, op end, ref start, ref length, query start, query length,
    ref position after the next operation) of each maximal run of I and D
    operations that holds both."""
    runs = []
    i, qpos = 0, 0
    while i < len(ops):
        if ops[i][1] not in "ID":
            ref_pos += ops[i][0] if ops[i][1] in "=XD" else 0
            qpos += ops[i][0] if ops[i][1] in "=XI" else 0
            i += 1
            continue
        j, r0, q0 = i, ref_pos, qpos
        while j < len(ops) and ops[j][1] in "ID":
            ref_pos += ops[j][0] if ops[j][1] == "D" else 0
            qpos += ops[j][0] if ops[j][1] == "I" else 0
            j += 1
        kinds = {op for _, op in ops[i:j]}
        if kinds == {"I", "D"}:
            after = ref_pos + (ops[j][0] if j < len(ops) and ops[j][1] in "=XD" else 0)
            runs.append((i, j, r0, ref_pos - r0, q0, qpos - q0, after))
        i = j
    return runs


class Inputs:
    """What the reference needs of the run's inputs, made again from the
    seed: the sampled pool records, the places of their reference-consuming
    bases' columns on the reference row, and the reference row's
    sequence.  ``bench`` is the benchmark's folder."""

    def __init__(self, seed: int, config: dict, traffic_mix: dict, pool_index: np.ndarray,
                 bench: pathlib.Path):
        made = msa.Msa(seed, config, bench / "configs")
        rows = traffic.Rows(made)
        pool = traffic.make_pool(seed, traffic_mix, rows, int(config["aligner_k"]), bench / "traffic")
        self.pool = {key: value[pool_index] for key, value in pool.items()}
        self.name_width = len(str(int(pool["pair"].max())))
        self.row_lengths = rows.lengths.tolist()
        sub = self.pool
        width = int(sub["span"].max())
        ref_open = ~rows.gap[0]
        ref_rank = rows.rank[0]
        self.ref_seq = traffic.ACGT[rows.base[0][ref_open]]
        self.excess = np.zeros((len(pool_index), width), np.int64)
        self.ref_gap = np.zeros((len(pool_index), width), bool)
        self.mate_excess = np.zeros(len(pool_index), np.int64)
        for r in np.unique(sub["row"]).tolist():
            sel = np.flatnonzero(sub["row"] == r)
            cols = rows.cols[r]
            at = sub["pos"][sel, None] + np.arange(width)[None, :]
            col = cols[np.minimum(at, len(cols) - 1)]
            self.excess[sel] = ref_rank[col]
            self.ref_gap[sel] = rows.gap[0][col]
            self.mate_excess[sel] = ref_rank[cols[sub["mate_pos"][sel]]]


# the tool's options the reference reads, with the CLI's defaults
DEFAULTS = {
    "original-rname-tag": "XR", "original-pos-tag": "XP", "original-rnext-tag": "YR",
    "original-pnext-tag": "YP", "realigned-query-ranges-tag": "XB",
    "realigned-ref-ranges-tag": "YB", "record-index-tag": None,
    "gap-opening-cost": "0", "gap-extension-cost": "-1",
}
# options that name inputs or places and change no line
PLACES = frozenset({
    "device", "alignments", "msa-index", "reference", "reference-msa-id", "ref-id-separator",
    "reference-order-input", "output-path", "engine",
})


def options(argv: list[str]) -> dict:
    """The configuration's ``project_alignments`` options (``--name=value``
    only), with the CLI's defaults; an option the reference does not
    model is refused, so that no configuration is judged by rules it does
    not follow."""
    opts = dict(DEFAULTS, **{"preserve-tag": []})
    for arg in argv[1:]:
        name, _, value = arg.removeprefix("--").partition("=")
        if not arg.startswith("--") or not _:
            raise ValueError(f"the reference takes --name=value options only, not {arg!r}")
        if name == "preserve-tag":
            opts[name].append(value)
        elif name in DEFAULTS:
            opts[name] = value
        elif name not in PLACES:
            raise ValueError(f"the reference does not model {arg!r}")
    return opts


def expected_lines(inputs: Inputs, config: dict, traffic_mix: dict, record_index: np.ndarray,
                   ties: str = FROZEN) -> list[tuple[list[str], set[str]]]:
    """(fields 1-11, tags) of the line the tool writes for each sampled
    record; ``record_index[i]`` is its place in the call's input."""
    p = inputs.pool
    ids = msa.row_ids(config)
    chrom = config["chromosome"]
    sep = config["ref_id_separator"]
    opts = options(config["tool_argv"])
    mapq = int(traffic_mix["mapq"])
    n = len(record_index)
    width = inputs.name_width
    rewritten, dst_pos, cigars = [], [], []
    for i in range(n):
        cigar = [(int(c), chr(traffic.OPS[o])) for o, c in zip(p["ops"][i].tolist(), p["counts"][i].tolist()) if c]
        cigars.append(cigar)
        rewritten.append(rewrite(cigar, p["seq"][i].tobytes(), inputs.ref_seq,
                                 inputs.excess[i], inputs.ref_gap[i]))
        dst_pos.append(int(inputs.excess[i, 0]))
    runs = [indel_runs(ops, dst_pos[i]) for i, ops in enumerate(rewritten)]
    refs, queries = [], []
    for i, record_runs in enumerate(runs):
        read = p["seq"][i].tobytes()
        for _, _, r0, rl, q0, ql, _ in record_runs:
            refs.append(inputs.ref_seq[r0:r0 + rl].tobytes())
            queries.append(read[q0:q0 + ql])
    aligned = iter(align_runs(refs, queries, int(opts["gap-opening-cost"]),
                              int(opts["gap-extension-cost"]), ties))
    out = []
    for i in range(n):
        ops = rewritten[i]
        final: list = []
        cut = 0
        for lo, hi, *_ in runs[i]:
            for c, op in ops[cut:lo]:
                _push(final, op, c)
            for c, op in next(aligned):
                _push(final, op, c)
            cut = hi
        for c, op in ops[cut:]:
            _push(final, op, c)
        row = int(p["row"][i])
        src_pos = int(p["pos"][i])
        read = p["seq"][i].tobytes().decode()
        cig_in = "".join(f"{c}{op}" for c, op in cigars[i])
        fields = [
            f"p{int(p['pair'][i]):0{width}d}", str(int(p["flag"][i])), chrom, str(dst_pos[i] + 1),
            str(mapq), "".join(f"{c}{op}" for c, op in final), "=",
            str(int(inputs.mate_excess[i]) + 1), str(int(p["tlen"][i])), read,
            p["qual"][i].tobytes().decode(),
        ]
        strand = "-" if int(p["flag"][i]) & 0x10 else "+"
        tags = {
            f"AS:i:{int(p['AS'][i])}",
            f"OA:Z:{chrom}{sep}{ids[row]},{src_pos},{strand},{cig_in},{mapq},{int(p['NM'][i])};",
            f"{opts['original-rname-tag']}:i:{row}", f"{opts['original-pos-tag']}:i:{src_pos}",
            f"{opts['original-rnext-tag']}:i:{row}",
            f"{opts['original-pnext-tag']}:i:{int(p['mate_pos'][i])}",
        }
        if opts["record-index-tag"]:
            first = int(record_index[i]) - int(record_index[i]) % TASK
            tags.add(f"{opts['record-index-tag']}:i:{first}")
        kept = ALWAYS_KEPT | set(opts["preserve-tag"])
        written = {name: int(p[name][i]) for name in ("XM", "XO", "XG", "NM", "YS")}
        written["XN"] = 0
        if p["has_XS"][i]:
            written["XS"] = int(p["XS"][i])
        for name, value in written.items():
            if name in kept:
                tags.add(f"{name}:i:{value}")
        if "YT" in kept:
            tags.add("YT:Z:CP")
        if runs[i]:
            q_ranges = ",".join(f"{q0},{q0 + ql}" for *_, q0, ql, _ in runs[i])
            r_ranges = ",".join(f"{after},{after + rl}" for _, _, _, rl, _, _, after in runs[i])
            tags.add(f"{opts['realigned-query-ranges-tag']}:B:I,{q_ranges}")
            tags.add(f"{opts['realigned-ref-ranges-tag']}:B:I,{r_ranges}")
        out.append((fields, tags))
    return out


def judge(lines: list[str], positions: np.ndarray, expected: dict[int, tuple[list[str], set[str]]]):
    """(lines compared, lines that differ, the first difference or None)."""
    wrong, first = 0, None
    for line, at in zip(lines, positions.tolist()):
        cols = line.rstrip("\n").split("\t")
        fields, tags = expected[at]
        if cols[:11] != fields or set(cols[11:]) != tags or len(cols[11:]) != len(tags):
            wrong += 1
            if first is None:
                first = {"record": at, "written": line.rstrip("\n")[:600],
                         "expected": "\t".join(fields + sorted(tags))[:600]}
    return len(lines), wrong, first


def header_problems(header: list[str], config: dict, ref_length: int) -> list[str]:
    """What is wrong with the header the tool wrote."""
    want = ["@HD\tVN:1.6", f"@SQ\tSN:{config['chromosome']}\tLN:{ref_length}"]
    got = [h for h in header if not h.startswith("@PG")]
    problems = [] if got == want else [f"header {got!r}, expected {want!r}"]
    if not any(h.startswith("@PG\tID:panvc3.project-alignments") for h in header):
        problems.append("no @PG line of project_alignments")
    return problems


def main(argv: list[str]) -> int:
    job = json.loads(pathlib.Path(argv[0]).read_text())
    kept = json.loads(pathlib.Path(job["kept"]).read_text())
    positions = np.array([at for _, at, _ in kept["lines"]], np.int64)
    unique = np.unique(positions)
    pool_index = unique % int(job["traffic"]["pool_records"])
    inputs = Inputs(job["seed"], job["config"], job["traffic"], pool_index, pathlib.Path(job["bench"]))
    exp = expected_lines(inputs, job["config"], job["traffic"], unique, job.get("ties", FROZEN))
    expected = dict(zip(unique.tolist(), exp))
    compared, wrong, first = judge([line for _, _, line in kept["lines"]], positions, expected)
    problems = header_problems(kept["header"], job["config"], inputs.row_lengths[0])
    bad = forbidden_loaded((PROGRAM,))
    print(json.dumps({
        "compared": compared, "wrong": wrong, "first_wrong": first,
        "header_problems": problems, "forbidden_modules": bad,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
