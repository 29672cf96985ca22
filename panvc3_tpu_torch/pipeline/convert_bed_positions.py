"""The ``convert_bed_positions`` tool.

Copy of ``panvc3_tpu.pipeline.convert_bed_positions``.

Reimplements convert-bed-positions/main.cc: project BED
intervals between two MSA sequences.  Per position:
``alnpos = select0_src(1 + pos)``, then
``dstpos = rank0_dst(1 + alnpos) + dst_gap_bit - 1`` (the ``+dstc-1``
half-open boundary handling, main.cc:60-73)."""

from __future__ import annotations

import sys

from ..io.bed import read_bed
from ..msa_index import MsaIndex, SequenceEntry


def convert_position(src: SequenceEntry, dst: SequenceEntry, pos: int) -> int:
    alnpos = int(src.gaps.select0(1 + pos))
    dstc = dst.gaps[alnpos]
    return int(dst.gaps.rank0(1 + alnpos)) + dstc - 1


def run_convert_bed_positions(
    msa_index_path: str,
    bed_path_or_fh,
    chr_id: str,
    src_seq: str,
    dst_seq: str,
    *,
    dst_chr_id: str | None = None,
    out=sys.stdout,
) -> tuple[int, int]:
    """Returns (chr matches, mismatches)."""
    index = MsaIndex.load(msa_index_path)
    src_chr = index.find_chr(chr_id)
    if src_chr is None:
        raise KeyError(f"no entry for chromosome ID {chr_id!r} in the MSA index")
    dst_chr = src_chr if not dst_chr_id else index.find_chr(dst_chr_id)
    if dst_chr is None:
        raise KeyError(f"no entry for chromosome ID {dst_chr_id!r} in the MSA index")
    src = src_chr.find(src_seq)
    dst = dst_chr.find(dst_seq)
    if src is None or dst is None:
        raise KeyError(f"no entry for sequence ID {src_seq!r}/{dst_seq!r}")

    matches = mismatches = 0
    for rec in read_bed(bed_path_or_fh):
        if rec.chrom != chr_id:
            mismatches += 1
            continue
        matches += 1
        lb = convert_position(src, dst, rec.start)
        rb = convert_position(src, dst, rec.end)
        print(f"{rec.chrom}\t{lb}\t{rb}", file=out)
    return matches, mismatches
