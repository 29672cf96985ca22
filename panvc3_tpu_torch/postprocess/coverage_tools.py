"""Coverage post-processing: histogram, ordered merge, VCF-site filter
(copy of ``panvc3_tpu.postprocess.coverage_tools``; the C TSV codec comes
from the port's build, which always exists, so the copy drops the
original's no-extension half; ``PANVC3_COVTOOLS_FAST=0`` runs the Python
loops).

Own implementations of the behaviour of the reference's
``coverage_histogram.py``, ``merge_coverages.py`` and ``filter_with_vcf.py``
(alignment-statistics/)."""

from __future__ import annotations

import bisect
import os
import sys
from collections import defaultdict

from ..native import get_native


def _read_pos_cov_columns(fp):
    """Consume a whole POSITION/COVERAGE stream (header already read) via
    the C TSV codec; returns (pos, cov) int64 arrays, or None under
    PANVC3_COVTOOLS_FAST=0 or for a stream without ``read``."""
    if os.environ.get("PANVC3_COVTOOLS_FAST") == "0" or not hasattr(fp, "read"):
        return None
    import numpy as np

    data = fp.read()
    if isinstance(data, str):
        data = data.encode("latin1")
    pos_b, cov_b, n = get_native().parse_pos_cov(data)
    return (
        np.frombuffer(pos_b, np.int64)[:n],
        np.frombuffer(cov_b, np.int64)[:n],
    )


def coverage_histogram(
    fp,
    out=sys.stdout,
    *,
    max_length: int = 0,
    count_missing: bool = False,
) -> dict[int, int]:
    """Histogram of a POSITION/COVERAGE stream; optionally count positions
    absent from the input as zero coverage."""
    next(fp)  # header
    cols = _read_pos_cov_columns(fp)
    if cols is not None and len(cols[0]) and int(cols[1].min()) < 0:
        # negative coverage: bincount inapplicable; replay the parsed
        # columns through the streaming loop (fp is already consumed)
        fp = (
            f"{p}\t{c}" for p, c in zip(cols[0].tolist(), cols[1].tolist())
        )
        cols = None
    if cols is not None:
        import numpy as np

        pos, cov = cols
        n = len(pos)
        max_cov = int(cov.max()) if n else 0
        counts = (
            np.bincount(cov, minlength=max_cov + 1)
            if n
            else np.zeros(1, np.int64)
        )
        hist = {i: int(counts[i]) for i in range(max_cov + 1)}
        prev_pos_1 = int(pos[-1]) + 1 if n else 0
        if count_missing and n:
            hist[0] += int(pos[0]) + int(np.sum(pos[1:] - pos[:-1] - 1))
        if count_missing and max_length > 0:
            hist[0] += 1 + max_length - prev_pos_1
        out.write("COVERAGE\tCOUNT\n")
        for i in range(max_cov + 1):
            out.write(f"{i}\t{hist[i]}\n")
        return hist
    hist: dict[int, int] = defaultdict(int)
    prev_pos_1 = 0
    max_cov = 0
    for raw in fp:
        pos_s, cov_s = raw.rstrip("\n").split("\t")
        pos, cov = int(pos_s), int(cov_s)
        hist[cov] += 1
        if count_missing:
            hist[0] += pos - prev_pos_1
        prev_pos_1 = pos + 1
        max_cov = max(max_cov, cov)
    if count_missing and max_length > 0:
        hist[0] += 1 + max_length - prev_pos_1

    out.write("COVERAGE\tCOUNT\n")
    for i in range(max_cov + 1):
        out.write(f"{i}\t{hist[i]}\n")
    return dict(hist)


def merge_coverages(lhs_fp, rhs_fp, out=sys.stdout) -> None:
    """Ordered merge of two POSITION/COVERAGE streams, summing coverage at
    shared positions."""
    next(lhs_fp)
    next(rhs_fp)
    lcols = _read_pos_cov_columns(lhs_fp)
    if lcols is not None:
        rcols = _read_pos_cov_columns(rhs_fp)
        if rcols is not None:
            import numpy as np

            p1, c1 = lcols
            p2, c2 = rcols
            if (len(p1) < 2 or bool(np.all(p1[1:] > p1[:-1]))) and (
                len(p2) < 2 or bool(np.all(p2[1:] > p2[:-1]))
            ):
                # strictly increasing inputs: the streaming merge equals a
                # position union with summed coverage
                all_pos = np.union1d(p1, p2)
                cov = np.zeros(len(all_pos), np.int64)
                cov[np.searchsorted(all_pos, p1)] += c1
                cov[np.searchsorted(all_pos, p2)] += c2
                out.write("POSITION\tCOVERAGE\n")
                blob = get_native().format_pos_cov(all_pos.tobytes(), cov.tobytes())
                out.write(blob.decode("latin1"))
                return
            # fall through to the streaming merge over the parsed columns
            lhs_fp = (f"{p}\t{c}" for p, c in zip(p1.tolist(), c1.tolist()))
            rhs_fp = (f"{p}\t{c}" for p, c in zip(p2.tolist(), c2.tolist()))

    def gen(fp):
        for raw in fp:
            pos_s, cov_s = raw.rstrip("\n").split("\t")
            yield int(pos_s), int(cov_s)

    out.write("POSITION\tCOVERAGE\n")
    a = gen(lhs_fp)
    b = gen(rhs_fp)
    x = next(a, None)
    y = next(b, None)
    while x is not None and y is not None:
        if x[0] < y[0]:
            out.write(f"{x[0]}\t{x[1]}\n")
            x = next(a, None)
        elif x[0] > y[0]:
            out.write(f"{y[0]}\t{y[1]}\n")
            y = next(b, None)
        else:
            out.write(f"{x[0]}\t{x[1] + y[1]}\n")
            x = next(a, None)
            y = next(b, None)
    while x is not None:
        out.write(f"{x[0]}\t{x[1]}\n")
        x = next(a, None)
    while y is not None:
        out.write(f"{y[0]}\t{y[1]}\n")
        y = next(b, None)


def filter_with_vcf(
    pos_fp,
    vcf_path: str,
    out=sys.stdout,
    *,
    bed_fp=None,
    chr_id: str | None = None,
) -> None:
    """Keep only coverage positions under variants of the given VCF
    (optionally restricted by chromosome and BED regions); positions missing
    from the coverage stream are reported as zero."""
    from ..io.vcf import VcfReader

    regions: list[tuple[int, int]] | None = None
    if bed_fp is not None:
        regions = []
        for raw in bed_fp:
            f = raw.rstrip("\n").split("\t")
            if f[0] == chr_id:
                regions.append((int(f[1]), int(f[2])))
        regions.sort()

    out.write(next(pos_fp))

    def positions():
        for raw in pos_fp:
            p, c = raw.rstrip("\n").split("\t")
            yield int(p), int(c)

    pos_gen = positions()
    cur = next(pos_gen, None)

    def coverage_at(i: int) -> int:
        nonlocal cur
        while cur is not None and cur[0] < i:
            cur = next(pos_gen, None)
        if cur is not None and cur[0] == i:
            return cur[1]
        return 0

    def overlaps_regions(start: int, end: int) -> bool:
        assert regions is not None
        i = bisect.bisect_right(regions, (end, -1))
        for s, e in regions[:i][::-1]:
            if e > start:
                return True
            if e <= start:
                break
        return False

    for var in VcfReader(vcf_path):
        if chr_id is not None and var.chrom != chr_id:
            continue
        start = var.pos
        end = var.pos + len(var.ref)
        if regions is not None and not overlaps_regions(start, end):
            continue
        for i in range(start, end):
            out.write(f"{i}\t{coverage_at(i)}\n")


def filter_reference(
    in_fp,
    out=sys.stdout,
    *,
    remove_contigs: frozenset[str] = frozenset(),
    description: str | None = None,
    contig_id_out=None,
) -> None:
    """Drop the named contigs from a FASTA stream (two-line records out),
    optionally listing all input contig ids.  Behaviour of the reference's
    bowtie2-workflow filter_reference.py:10-36."""
    name = None
    chunks: list[str] = []

    def emit():
        if name is None:
            return
        if contig_id_out is not None:
            contig_id_out.write(name + "\n")
        if name not in remove_contigs:
            title = name if description is None else f"{name} {description}"
            out.write(f">{title}\n{''.join(chunks)}\n")

    for raw in in_fp:
        line = raw.rstrip("\n")
        if line.startswith(">"):
            emit()
            name = line[1:].split()[0] if len(line) > 1 else ""
            chunks = []
        else:
            chunks.append(line)
    emit()
