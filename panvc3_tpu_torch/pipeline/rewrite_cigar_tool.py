"""The ``rewrite_cigar`` tool: convert between M and =/X CIGARs.

Copy of ``panvc3_tpu.pipeline.rewrite_cigar_tool``.
The C host extension always exists in the port, so the chunk engine is
gated by ``PANVC3_REWRITE_TOOL_FAST`` alone.

Reimplements rewrite-cigar/main.cc:

- ``-M`` mode (alignment match): rewrite =/X -> M, merging adjacent runs
  (rewrite_cigar_alignment_match, main.cc:151-192);
- ``-S`` mode (sequence match): rewrite M -> =/X by comparing the query to
  the reference, and emit the XN tag — a bit-packed (8 per byte, LSB first)
  mask of reference N positions under the reference-consuming span of the
  alignment (fill_ref_n_positions, main.cc:126-148;
  rewrite_cigar_sequence_match, main.cc:195-284).  Note the reference does
  NOT merge the new =/X runs with neighbouring ops (plain vector push_back),
  which we reproduce.
"""

from __future__ import annotations

import os

from ..cigar import Cigar, CigarBuffer
from ..io.fasta import FastaReader
from ..io.sam import SamHeader, SamReader, SamWriter
from ..native import get_native


def rewrite_alignment_match(cigar: Cigar) -> Cigar:
    buf = CigarBuffer()
    for count, op in cigar:
        if op in ("=", "X"):
            buf.push_back("M", count)
        elif op in "HPISDNM":
            buf.push_back(op, count)
        else:
            raise ValueError(f"unexpected CIGAR operation {op!r}")
    buf.finish()
    return buf.operations


def _fill_ref_n_positions(
    ref: bytes, out: bytearray, ref_base_pos: int, ref_pos: int, count: int
) -> None:
    need = (ref_pos + count + 7) // 8
    if len(out) < need:
        out.extend(b"\x00" * (need - len(out)))
    if ref_base_pos + ref_pos + count > len(ref):
        raise ValueError("CIGAR overruns the reference")
    for i in range(count):
        if ref[ref_base_pos + ref_pos + i] == ord("N"):
            out[(ref_pos + i) // 8] |= 1 << ((ref_pos + i) % 8)


def rewrite_sequence_match(
    ref: bytes, ref_base_pos: int, query: str, cigar: Cigar
) -> tuple[Cigar, bytes]:
    """Returns (new_cigar, xn_bitmask)."""
    out: Cigar = []
    n_positions = bytearray()
    query_pos = 0
    ref_pos = 0
    for count, op in cigar:
        if op in ("H", "P"):
            out.append((count, op))
        elif op in ("I", "S"):
            out.append((count, op))
            query_pos += count
        elif op in ("=", "X"):
            out.append((count, op))
            _fill_ref_n_positions(ref, n_positions, ref_base_pos, ref_pos, count)
            query_pos += count
            ref_pos += count
        elif op in ("D", "N"):
            out.append((count, op))
            _fill_ref_n_positions(ref, n_positions, ref_base_pos, ref_pos, count)
            ref_pos += count
        elif op == "M":
            _fill_ref_n_positions(ref, n_positions, ref_base_pos, ref_pos, count)
            if query_pos + count > len(query):
                raise ValueError("CIGAR overruns SEQ")
            # per-character comparison, runs merged within this op only
            prev_count = 1
            prev_op = (
                "=" if ord(query[query_pos]) == ref[ref_base_pos + ref_pos] else "X"
            )
            for i in range(1, count):
                cur = (
                    "="
                    if ord(query[query_pos + i]) == ref[ref_base_pos + ref_pos + i]
                    else "X"
                )
                if cur == prev_op:
                    prev_count += 1
                else:
                    out.append((prev_count, prev_op))
                    prev_count = 1
                    prev_op = cur
            out.append((prev_count, prev_op))
            ref_pos += count
            query_pos += count
        else:
            raise ValueError(f"unexpected CIGAR operation {op!r}")
    return out, bytes(n_positions)


def run_rewrite_cigar(
    input_path_or_fh,
    output_path_or_fh,
    *,
    mode: str,  # "alignment-match" (-M) or "sequence-match" (-S)
    reference_path: str | None = None,
    ref_n_positions_tag: str = "XN",
    output_bam: bool = False,
    command_line: str = "panvc3_tpu_torch rewrite_cigar",
    version: str = "0.1",
    status_output_interval: int = 5,
) -> int:
    # periodic µs/record status like the reference's timer thread
    # (rewrite-cigar/main.cc:287-328)
    from ..utils import StatusReporter

    reporter = StatusReporter(status_output_interval)
    reader = SamReader(input_path_or_fh)
    header = reader.header
    out_header = SamHeader()
    out_header.lines = list(header.lines)
    out_header.ref_names = list(header.ref_names)
    out_header.ref_lengths = list(header.ref_lengths)
    out_header.append_program(
        "panvc3.rewrite-cigar", "PanVC 3 rewrite_cigar", command_line, version
    )
    writer = SamWriter(output_path_or_fh, out_header, bam=output_bam)

    if mode not in ("alignment-match", "sequence-match"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "sequence-match" and reference_path is None:
        raise ValueError("sequence-match mode requires a reference FASTA")

    # Native chunk engine: the whole record loop in C over raw line chunks
    # (canonical emission, byte-identical to the object path).  A chunk
    # whose records touch an unloaded contig returns that ref id so the
    # bounded LRU store loads it and the chunk retries — nothing is
    # emitted before the retry (pre-pass inside the C call).
    nat = get_native()
    if os.environ.get("PANVC3_REWRITE_TOOL_FAST") != "0":
        refmap = {nm.encode(): i for i, nm in enumerate(header.ref_names)}
        mode_i = 0 if mode == "alignment-match" else 1
        store = None
        if mode_i == 1:
            from ..seqbuf import SequenceBufferStore

            fasta = FastaReader(reference_path)
            store = SequenceBufferStore(
                lambda rid: fasta.read_sequence(header.ref_names[rid]),
                max_size=4,
            )
        xn_b = ref_n_positions_tag.encode() if mode_i == 1 else None
        n = 0
        CHUNK = 16384
        pending: list[bytes] = []

        def flush(chunk_lines):
            nonlocal n
            # per-chunk contig snapshot (keeps the store's bound between
            # chunks, like the per-batch snapshots of the projection lane)
            ref_list: list = [None] * len(header.ref_names)
            while True:
                res = nat.rewrite_cigar_lines(
                    chunk_lines, refmap, header.ref_names, ref_list,
                    mode_i, xn_b,
                )
                if isinstance(res, int):
                    ref_list[res] = store.get(res)
                    continue
                blob, n_recs = res
                n += n_recs
                writer.write_raw(blob)
                reporter.tick(n)
                return

        for block in reader.raw_record_line_blocks():
            pending.extend(block)
            while len(pending) >= CHUNK:
                flush(pending[:CHUNK])
                del pending[:CHUNK]
        if pending:
            flush(pending)
        writer.close()
        return n

    n = 0
    if mode == "alignment-match":
        for rec in reader:
            n += 1
            rec.cigar = rewrite_alignment_match(rec.cigar)
            writer.write(rec)
            reporter.tick(n)
    elif mode == "sequence-match":
        if reference_path is None:
            raise ValueError("sequence-match mode requires a reference FASTA")
        fasta = FastaReader(reference_path)
        # bounded like the reference's 4-entry heap LRU
        # (rewrite-cigar/main.cc:51-108, MAX_SIZE=4)
        from ..seqbuf import SequenceBufferStore

        ref_cache = SequenceBufferStore(
            lambda rid: fasta.read_sequence(header.ref_names[rid]), max_size=4
        )
        for rec in reader:
            n += 1
            if rec.pos < 0 or rec.ref_id < 0:
                writer.write(rec)
                continue
            ref = ref_cache[rec.ref_id]
            new_cigar, xn = rewrite_sequence_match(ref, rec.pos, rec.seq, rec.cigar)
            rec.cigar = new_cigar
            if xn:
                rec.tags[ref_n_positions_tag] = ("B", ("C", list(xn)))
            writer.write(rec)
            reporter.tick(n)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    writer.close()
    return n
