"""The ``subset_alignments`` tool.

Copy of ``panvc3_tpu.pipeline.subset_alignments``.
The C host extension always exists in the port, so the chunk engine is
gated by ``PANVC3_SUBSET_FAST`` alone.

Reimplements subset-alignments/main.cc: filter a SAM/BAM
stream by chromosome name (--chr), by a read-ID list (--read-id, sorted +
binary search, main.cc:140-159), and/or select the best-MAPQ record per
QNAME group plus its mate matched by RNEXT/PNEXT (--best-mapq,
main.cc:36-126; MAPQ 255 is ignored when ranking).
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass

from ..io.sam import SamHeader, SamReader, SamRecord, SamWriter
from ..native import get_native


@dataclass
class MatchCount:
    matches: int = 0
    mismatches: int = 0


def _output_best_mate(mate_ref_id, mate_pos, alignments, writer):
    if not alignments:
        return
    best_mapq = 0
    for rec in alignments:
        if rec.ref_id != mate_ref_id or rec.pos != mate_pos:
            continue
        if rec.mapq == 255:
            continue
        best_mapq = max(best_mapq, rec.mapq)
    for rec in alignments:
        if rec.mapq == best_mapq and rec.ref_id == mate_ref_id and rec.pos == mate_pos:
            writer.write(rec)
            return


def _process_group(alignments, writer):
    if not alignments:
        return
    best_mapq = 0
    for rec in alignments:
        if rec.mapq == 255:
            continue
        best_mapq = max(best_mapq, rec.mapq)
    for rec in alignments:
        if rec.mapq == best_mapq:
            writer.write(rec)
            if rec.mate_ref_id < 0 or rec.mate_pos < 0:
                return
            _output_best_mate(rec.mate_ref_id, rec.mate_pos, alignments, writer)
            return
    # default: output the first
    rec = alignments[0]
    writer.write(rec)
    if rec.mate_ref_id >= 0 and rec.mate_pos >= 0:
        _output_best_mate(rec.mate_ref_id, rec.mate_pos, alignments, writer)


def run_subset_alignments(
    input_path_or_fh,
    output_path_or_fh,
    *,
    chr_id: str | None = None,
    read_ids=None,  # iterable of read names, or None
    best_mapq: bool = False,
    output_bam: bool = False,
    command_line: str = "panvc3_tpu_torch subset_alignments",
    version: str = "0.1",
) -> MatchCount:
    reader = SamReader(input_path_or_fh)
    header = reader.header
    out_header = SamHeader()
    out_header.lines = list(header.lines)
    out_header.ref_names = list(header.ref_names)
    out_header.ref_lengths = list(header.ref_lengths)
    out_header.append_program(
        "panvc3.subset-alignments", "PanVC 3 subset_alignments", command_line, version
    )
    writer = SamWriter(output_path_or_fh, out_header, bam=output_bam)

    name_set = set(read_ids) if read_ids is not None else None
    mc = MatchCount()
    buffer: list[SamRecord] = []

    # Native chunk engine: the whole filter + best-mapq group loop in C on
    # raw line chunks (cut at QNAME boundaries), emitting the canonical
    # format_sam_record form byte-identical to the object path.
    nat = get_native()
    if os.environ.get("PANVC3_SUBSET_FAST") != "0":
        refmap = {n.encode(): i for i, n in enumerate(header.ref_names)}
        chr_b = chr_id.encode() if chr_id is not None else None
        ids_b = (
            sorted(n.encode() for n in name_set)
            if name_set is not None
            else None
        )
        CHUNK = 16384
        pending: list[bytes] = []

        def flush(chunk_lines):
            blob, m, mm = nat.subset_filter_lines(
                chunk_lines, refmap, header.ref_names, chr_b, ids_b,
                1 if best_mapq else 0,
            )
            mc.matches += m
            mc.mismatches += mm
            writer.write_raw(blob)

        for block in reader.raw_record_line_blocks():
            pending.extend(block)
            while len(pending) > CHUNK:
                i = CHUNK
                last_q = pending[i - 1].split(b"\t", 1)[0]
                n = len(pending)
                while i < n and pending[i].split(b"\t", 1)[0] == last_q:
                    i += 1
                if i >= n:
                    break  # group spans the buffer end; read more first
                flush(pending[:i])
                del pending[:i]
        if pending:
            flush(pending)
        writer.close()
        print(f"Matches:    {mc.matches}", file=sys.stderr)
        print(f"Mismatches: {mc.mismatches}", file=sys.stderr)
        return mc

    for rec in reader:
        if chr_id is not None:
            if rec.ref_id < 0 or header.ref_names[rec.ref_id] != chr_id:
                mc.mismatches += 1
                continue
        if name_set is not None and rec.qname not in name_set:
            mc.mismatches += 1
            continue
        mc.matches += 1
        if best_mapq:
            if buffer and rec.qname != buffer[0].qname:
                _process_group(buffer, writer)
                buffer = []
            buffer.append(rec)
        else:
            writer.write(rec)

    if best_mapq and buffer:
        _process_group(buffer, writer)
    writer.close()
    print(f"Matches:    {mc.matches}", file=sys.stderr)
    print(f"Mismatches: {mc.mismatches}", file=sys.stderr)
    return mc
