"""CIGAR rewriting between MSA coordinate systems (the host oracle; copy
of ``panvc3_tpu.rewrite``).

Walk the CIGAR of an alignment made against the *source* sequence and
re-express it against the *destination* sequence of the same MSA, column
by column:

- I/S (query-only) and H/P (no-op) operations pass through unchanged;
- M/=/X are processed one source base at a time: a gap in the destination
  column turns the base into an insertion, a non-gap compares the query
  character against the destination character (= / X); destination non-gap
  columns skipped between consecutive source positions emit deletions;
- D/N are processed one source base at a time: destination gap drops the
  deletion, non-gap keeps a 1-base D; skipped destination columns emit
  deletions the same way.

Returns the projected start position in destination coordinates
(= rank0_dst(select0_src(1 + src_pos))).
"""

from __future__ import annotations

from .cigar import Cigar, CigarBuffer
from .msa_index import SequenceEntry


def rewrite_cigar(
    src_pos: int,
    cigar: Cigar,
    src_entry: SequenceEntry,
    dst_entry: SequenceEntry,
    query_seq: str | bytes,
    dst_seq: str | bytes,
    destination: CigarBuffer | None = None,
) -> tuple[int, Cigar]:
    """Rewrite ``cigar`` from src coordinates to dst coordinates.

    ``query_seq`` is the read sequence (typically dna5-normalised),
    ``dst_seq`` the gapless destination sequence.  Characters are compared as
    raw single characters: the query is dna5 output and the destination is
    raw bytes from the FASTA.

    Returns ``(dst_pos, rewritten_cigar)``.
    """
    if isinstance(query_seq, bytes):
        query_seq = query_seq.decode("latin1")
    if isinstance(dst_seq, bytes):
        dst_seq = dst_seq.decode("latin1")

    dst = destination if destination is not None else CigarBuffer()
    dst.clear()

    query_pos = 0
    aln_pos = int(src_entry.aligned_position(src_pos))
    prev_excess = int(dst_entry.project_aligned_position(aln_pos))
    retval = prev_excess

    sgaps = src_entry.gaps
    dgaps = dst_entry.gaps

    for op_count, op in cigar:
        if op in ("I", "S"):
            dst.push_back(op, op_count)
            query_pos += op_count
        elif op in ("H", "P"):
            dst.push_back(op, op_count)
        elif op in ("M", "=", "X"):
            for _ in range(op_count):
                aln = int(sgaps.select0(1 + src_pos))
                excess = int(dgaps.rank0(aln))
                if prev_excess < excess:
                    dst.push_back("D", excess - prev_excess)
                if dgaps[aln]:
                    dst.push_back("I", 1)
                    prev_excess = excess
                else:
                    if query_seq[query_pos] == dst_seq[excess]:
                        dst.push_back("=", 1)
                    else:
                        dst.push_back("X", 1)
                    prev_excess = excess + 1
                query_pos += 1
                src_pos += 1
        elif op in ("D", "N"):
            for _ in range(op_count):
                aln = int(sgaps.select0(1 + src_pos))
                excess = int(dgaps.rank0(aln))
                if prev_excess < excess:
                    dst.push_back("D", excess - prev_excess)
                if not dgaps[aln]:
                    dst.push_back("D", 1)
                    prev_excess = excess + 1
                else:
                    prev_excess = excess
                src_pos += 1
        else:
            raise ValueError(f"unexpected CIGAR operation {op!r}")

    dst.finish()
    return retval, dst.operations
