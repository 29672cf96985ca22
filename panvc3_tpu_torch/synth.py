"""Synthetic founder MSAs and founder-aligned reads, made from a seed.

For smoke tests and benchmarks of the port at a size users run, where the
real founder sequences are not available: one chromosome with REF plus
four founders (the row layout of
``workflows/test-workflow/data/index-input/input.tsv``), each row the
same random A/C/G/T column sequence with its own 2% of gap columns, and
100 bp reads drawn from the gap-stripped rows with the CIGAR kinds of
``bench.py`` (``synthesise_records``: match, deletion, insertion plus
deletion; ``synthesise_heavy_records``: one 48I48D run per read), with a
constant quality string or, for quality-scored (``-q``) runs, phreds
drawn from the seed.  For the tools after projection: read pairs aligned
to every founder with ``AS:i`` tags (QNAME-grouped, what
``recalculate_mapq`` takes once they are projected), a diploid
single-sample VCF over the reference row, and BED intervals.  For the
workflow driver: verbatim founder reads of the bundled toy data
(``workflow_reads_sam``), and the bundled reads' own alignments moved onto
the founders (``founder_alignments``), the test workflow's aligner stage.
"""

from __future__ import annotations

import pathlib

import numpy as np

from .bitvec import GapBitVector
from .msa_index import ChrEntry, MsaIndex, SequenceEntry

SEQ_IDS = ("REF", "1", "2", "3", "4")
_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def make_msa(n_cols: int, seed: int, gap_rate: float = 0.02) -> dict[str, bytes]:
    """{seq id: aligned row} over ``n_cols`` columns, '-' for gaps."""
    rng = np.random.default_rng(seed)
    base = _ACGT[rng.integers(0, 4, n_cols, dtype=np.uint8)]
    rows = {}
    for sid in SEQ_IDS:
        row = base.copy()
        row[rng.random(n_cols, dtype=np.float32) < gap_rate] = ord("-")
        rows[sid] = row.tobytes()
    return rows


def write_inputs(
    workdir: pathlib.Path, chr_id: str, rows: dict[str, bytes]
) -> tuple[pathlib.Path, pathlib.Path, dict[str, bytes]]:
    """Save the MSA index and the REF FASTA; returns (index path, FASTA
    path, {seq id: gap-stripped founder sequence})."""
    index = MsaIndex()
    chrom = ChrEntry(chr_id)
    chrom.sequence_entries = [
        SequenceEntry(sid, GapBitVector.from_gap_string(row))
        for sid, row in rows.items()
    ]
    index.chr_entries.append(chrom)
    index.sort()
    index_path = workdir / "msa-index.npz"
    index.save(str(index_path))
    founders = {
        sid: np.frombuffer(row, np.uint8)[np.frombuffer(row, np.uint8) != ord("-")].tobytes()
        for sid, row in rows.items()
    }
    fasta_path = workdir / "reference.fa"
    with open(fasta_path, "wb") as fh:
        fh.write(f">{chr_id}\n".encode() + founders["REF"] + b"\n")
    return index_path, fasta_path, founders


def reads_sam(
    chr_id: str,
    founders: dict[str, bytes],
    n_reads: int,
    seed: int,
    read_len: int = 100,
    qualities: bool = False,
) -> bytes:
    """SAM text of ``n_reads`` reads: even reads take the mixed kinds
    (match / kD / kI jD), odd reads one 48I48D run.  Qualities are all
    ``I`` (phred 40), or with ``qualities`` uniform phreds 2..41 from a
    generator of their own, so the reads are the same either way."""
    rng = np.random.default_rng(seed)
    if qualities:
        phreds = np.random.default_rng([seed, 1]).integers(2, 42, (n_reads, read_len))
        quals = (phreds + 33).astype(np.uint8)
    sids = list(founders)
    lines = ["@HD\tVN:1.6"]
    for sid in sids:
        lines.append(f"@SQ\tSN:{chr_id}/{sid}\tLN:{len(founders[sid])}")
    half = read_len // 2
    heavy_half = (read_len - 48) // 2
    picks = rng.integers(0, len(sids), n_reads)
    for i in range(n_reads):
        sid = sids[int(picks[i])]
        s = founders[sid]
        pos = int(rng.integers(0, len(s) - read_len - 16))
        if i % 2:
            ins = _ACGT[rng.integers(0, 4, 48)].tobytes()
            seq = s[pos:pos + heavy_half] + ins + s[pos + heavy_half + 48:pos + read_len]
            cigar = f"{heavy_half}=48I48D{read_len - heavy_half - 48}="
        else:
            kind = (i // 2) % 3
            if kind == 0:
                seq = s[pos:pos + read_len]
                cigar = f"{read_len}="
            elif kind == 1:
                k = int(rng.integers(1, 6))
                seq = s[pos:pos + half] + s[pos + half + k:pos + k + read_len]
                cigar = f"{half}={k}D{read_len - half}="
            else:
                k = int(rng.integers(1, 6))
                j = int(rng.integers(1, 6))
                ins = _ACGT[rng.integers(0, 4, k)].tobytes()
                seq = (
                    s[pos:pos + half] + ins
                    + s[pos + half + j:pos + half + j + (read_len - half - k)]
                )
                cigar = f"{half}={k}I{j}D{read_len - half - k}="
        qual = quals[i, :len(seq)].tobytes().decode() if qualities else "I" * len(seq)
        lines.append(
            f"r{i}\t0\t{chr_id}/{sid}\t{pos + 1}\t60\t{cigar}\t*\t0\t0\t"
            f"{seq.decode()}\t{qual}"
        )
    return ("\n".join(lines) + "\n").encode()


def pairs_sam(
    chr_id: str,
    founders: dict[str, bytes],
    n_pairs: int,
    seed: int,
    read_len: int = 100,
) -> bytes:
    """SAM text of ``n_pairs`` read pairs, each aligned to every founder
    (not to REF) as a proper pair of two ``100=`` mates 150-350 bp apart,
    at the same relative place in each founder, with a seeded ``AS:i``:
    QNAME-grouped, 2 x 4 records per pair."""
    rng = np.random.default_rng(seed)
    sids = [sid for sid in founders if sid != "REF"]
    lines = ["@HD\tVN:1.6\tSO:unsorted\tGO:query"]
    for sid in founders:
        lines.append(f"@SQ\tSN:{chr_id}/{sid}\tLN:{len(founders[sid])}")
    shortest = min(len(founders[sid]) for sid in sids)
    starts = rng.integers(0, shortest - 2 * read_len - 400, n_pairs).tolist()
    gaps = rng.integers(150, 351, n_pairs).tolist()
    scores = rng.integers(0, 31, (n_pairs, len(sids), 2)).tolist()
    qual = "I" * read_len
    for i in range(n_pairs):
        p1 = starts[i]
        p2 = p1 + gaps[i]
        tlen = p2 + read_len - p1
        for k, sid in enumerate(sids):
            s = founders[sid]
            rname = f"{chr_id}/{sid}"
            lines.append(
                f"p{i}\t99\t{rname}\t{p1 + 1}\t60\t{read_len}=\t=\t{p2 + 1}\t{tlen}\t"
                f"{s[p1:p1 + read_len].decode()}\t{qual}\tAS:i:-{scores[i][k][0]}"
            )
            lines.append(
                f"p{i}\t147\t{rname}\t{p2 + 1}\t60\t{read_len}=\t=\t{p1 + 1}\t{-tlen}\t"
                f"{s[p2:p2 + read_len].decode()}\t{qual}\tAS:i:-{scores[i][k][1]}"
            )
    return ("\n".join(lines) + "\n").encode()


def variants_vcf(chr_id: str, reference: bytes, n_variants: int, seed: int) -> bytes:
    """A position-sorted VCF of at most ``n_variants`` SNPs (drawn with
    replacement, kept once) over ``reference`` for one diploid sample,
    genotypes 0|1, 1|0 and 1|1."""
    rng = np.random.default_rng(seed)
    pos = np.unique(rng.integers(1, len(reference) - 1, n_variants))
    n_variants = len(pos)
    ref = np.frombuffer(reference, np.uint8)[pos - 1]
    alt = _ACGT[(np.searchsorted(_ACGT, ref) + rng.integers(1, 4, n_variants)) % 4]
    gts = np.array(["0|1", "1|0", "1|1"])[rng.integers(0, 3, n_variants)]
    lines = [
        "##fileformat=VCFv4.2",
        f"##contig=<ID={chr_id},length={len(reference)}>",
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1",
    ]
    lines += [
        f"{chr_id}\t{p}\tv{j}\t{chr(r)}\t{chr(a)}\t.\tPASS\t.\tGT\t{g}"
        for j, (p, r, a, g) in enumerate(zip(pos.tolist(), ref.tolist(), alt.tolist(), gts.tolist()))
    ]
    return ("\n".join(lines) + "\n").encode()


def bed_intervals(chr_id: str, length: int, n_intervals: int, seed: int) -> bytes:
    """``n_intervals`` start-sorted BED intervals of 1-500 bp on ``chr_id``."""
    rng = np.random.default_rng(seed)
    starts = np.sort(rng.integers(0, length - 501, n_intervals))
    ends = starts + rng.integers(1, 501, n_intervals)
    return "".join(f"{chr_id}\t{a}\t{b}\n" for a, b in zip(starts.tolist(), ends.tolist())).encode()


def workflow_reads_sam(founder_seqs: dict[str, bytes], n_reads: int = 200,
                       read_len: int = 100, seed: int = 42) -> str:
    """Reads sampled verbatim from founder sequences (aligned rows of the
    chromosome ``test``), aligned with all-= CIGARs against the
    gap-stripped founders (a copy of ``tests/test_workflow_data.py``'s
    ``_synthesise_sam``, which the JAX package's workflow driver uses)."""
    rng = np.random.default_rng(seed)
    lines = ["@HD\tVN:1.6"]
    stripped = {sid: s.replace(b"-", b"") for sid, s in founder_seqs.items()}
    for sid, s in stripped.items():
        lines.append(f"@SQ\tSN:test/{sid}\tLN:{len(s)}")
    names = list(stripped)
    for i in range(n_reads):
        sid = names[rng.integers(len(names))]
        s = stripped[sid]
        pos = int(rng.integers(0, len(s) - read_len))
        seq = s[pos:pos + read_len].decode()
        lines.append(
            f"read{i}\t0\ttest/{sid}\t{pos + 1}\t60\t{read_len}=\t*\t0\t0\t{seq}\t{'I' * read_len}\tNM:i:0\tXD:i:7"
        )
    return "\n".join(lines) + "\n"


def founder_alignments(data: pathlib.Path, index_path) -> bytes:
    """Stand-in for the test workflow's aligner stage (``bowtie2 -k``
    against the founders) on the bundled reads: SAM text, QNAME-grouped.

    ``data/reads/alignment.bam`` holds the simulated reads' alignments to
    the toy genome (contig ``test``, the MSA's REF row), not to the
    founders.  Each mapped record is projected from REF onto each founder
    with the port's projector (the machinery of ``project_alignments`` in
    the other direction) and written as ``test/<founder>``: primary on the
    first founder it fits, secondary (0x100) on the others, with
    Bowtie 2's default penalties as ``AS:i`` (mismatch -6, a gap of k
    bases -5 - 3k), so each read's placements score differently where the
    founders differ.  Mates become single reads named ``<qname>.1`` and
    ``<qname>.2``.  ``index_path`` is the MSA index built from
    ``data/index-input``."""
    import bz2

    from .cigar import format_cigar
    from .io.sam import SamReader
    from .projector import project_alignment

    rows = {}
    for line in (data / "index-input/input.tsv").read_text().splitlines():
        _chr, seq_id, rel = line.split("\t")
        rows[seq_id] = bz2.open(data / rel, "rb").read().replace(b"-", b"")
    chrom = MsaIndex.load(str(index_path)).find_chr("test")
    ref_entry = chrom.find("REF")
    names = [sid for sid in rows if sid != "REF"]
    lines = ["@HD\tVN:1.6"] + [f"@SQ\tSN:test/{sid}\tLN:{len(rows[sid])}" for sid in names]
    reader = SamReader(str(data / "reads/alignment.bam"))
    for rec in reader:
        if rec.is_unmapped or rec.seq == "*":
            continue
        qname = f"{rec.qname}.{1 if rec.flag & 0x40 else 2}"
        placed = 0
        for sid in names:
            res = project_alignment(
                rec.pos, ref_entry, chrom.find(sid), rows[sid], rec.seq, rec.cigar, None, 0, -1
            )
            # the projected CIGAR holds =, X, I and D against the founder
            score = sum(
                -6 * count if op == "X" else -5 - 3 * count if op in "ID" else 0
                for count, op in res.cigar
            )
            ref_len = sum(count for count, op in res.cigar if op in "=XD")
            if ref_len == 0 or res.dst_pos + ref_len > len(rows[sid]):
                continue
            flag = (rec.flag & 0x10) | (0x100 if placed else 0)
            lines.append(
                f"{qname}\t{flag}\ttest/{sid}\t{res.dst_pos + 1}\t{rec.mapq}"
                f"\t{format_cigar(res.cigar)}\t*\t0\t0"
                f"\t{rec.seq}\t{rec.qual}\tAS:i:{score}"
            )
            placed += 1
    reader.close()
    return ("\n".join(lines) + "\n").encode()


def head_of(sam: bytes, n: int) -> bytes:
    """The header and the first ``n`` records of SAM text."""
    lines = sam.split(b"\n")
    k = next(i for i, ln in enumerate(lines) if ln and not ln.startswith(b"@"))
    return b"\n".join(lines[:k + n]) + b"\n"


def every_other(sam: bytes, n: int) -> bytes:
    """The header and the even-numbered records (0, 2, ...) of SAM text,
    ``n`` of them."""
    lines = sam.split(b"\n")
    k = next(i for i, ln in enumerate(lines) if ln and not ln.startswith(b"@"))
    recs = [ln for ln in lines[k:] if ln][:2 * n:2]
    if len(recs) != n:
        raise ValueError(f"every_other: {len(recs)} even records, not {n}")
    return b"\n".join(lines[:k] + recs) + b"\n"
