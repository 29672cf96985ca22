"""Build / inspect / query the MSA index.

Copy of ``panvc3_tpu.pipeline.index_msa``.

Reimplements the ``panvc3_index_msa`` tool
(index-msa/main.cc and input_processor.cc):

- ``--sequence-inputs``: TSV of (chr_id, seq_id, path) rows pointing at
  aligned (gapped) sequence files — raw text or FASTA, optionally piped
  through a decompression command (``--pipe-input``, e.g. ``bzip2 -d -c``);
- ``--sequences``: a single A2M FASTA whose headers are ``chr/seq``;
- optional gap-stripped FASTA output for the aligner (``--output-fasta``
  with ``--fasta-line-width``);
- ``--list-contents`` and ``--query`` modes over a saved index.

The reference's gap scan and bitvector build become a vectorised numpy
pass in GapBitVector.from_gap_string.
"""

from __future__ import annotations

import shlex
import subprocess
import sys


from ..bitvec import GapBitVector
from ..io.fasta import write_fasta
from ..msa_index import MsaIndex, SequenceEntry


def _read_input_file(path: str, pipe_command: str | None) -> bytes:
    """Read one aligned-sequence input, optionally via a decompression
    subprocess (mirrors subprocess_input_handler,
    index-msa/input_handler.hh:57-66)."""
    if pipe_command:
        proc = subprocess.run(
            shlex.split(pipe_command) + [path], capture_output=True
        )
        if proc.returncode != 0:
            # the reference's SIGCHLD handler aborts on decompressor failure
            # (index-msa/main.cc:28-58); surface it as a typed CLI error
            detail = proc.stderr.decode("latin1", "replace").strip()
            raise ValueError(
                f"input decompression '{pipe_command}' failed for {path!r} "
                f"(exit {proc.returncode})" + (f": {detail}" if detail else "")
            )
        return proc.stdout
    with open(path, "rb") as fh:
        return fh.read()


def _extract_sequence(data: bytes) -> bytes:
    """Accept both raw aligned text and single-record FASTA; strip newlines."""
    if data.startswith(b">"):
        lines = data.split(b"\n")[1:]
        return b"".join(l.rstrip(b"\r") for l in lines)
    return data.replace(b"\n", b"").replace(b"\r", b"")


def build_index_from_tsv(
    tsv_path: str,
    pipe_command: str | None = None,
    fasta_out=None,
    fasta_line_width: int = 0,
    base_index: MsaIndex | None = None,
) -> MsaIndex:
    """TSV mode (sequence_list_input_processor,
    index-msa/input_processor.cc:104-204).  When
    ``fasta_out`` is given, the gap-stripped sequences are written as FASTA
    records named ``chr/seq`` in input order."""
    idx = base_index if base_index is not None else MsaIndex()
    rows: list[tuple[str, str, str]] = []
    with open(tsv_path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            chr_id, seq_id, path = line.split("\t")[:3]
            rows.append((chr_id, seq_id, path))

    # Per-sequence build parallelism, like the reference's background
    # dispatch groups (index-msa/input_processor.cc:141-203): file read,
    # gap scan and bit packing release the GIL; index/FASTA emission stays
    # on this thread in input order.
    def build_one(row):
        chr_id, seq_id, path = row
        data = _extract_sequence(_read_input_file(path, pipe_command))
        gaps = GapBitVector.from_gap_string(data)
        stripped = data.replace(b"-", b"") if fasta_out is not None else None
        return gaps, stripped

    import concurrent.futures as cf
    import os as _os

    workers = min(4, _os.cpu_count() or 1, max(len(rows), 1))
    with cf.ThreadPoolExecutor(max_workers=workers) as pool:
        for (chr_id, seq_id, _), (gaps, stripped) in zip(
            rows, pool.map(build_one, rows)
        ):
            chrom = idx.get_or_add_chr(chr_id)
            chrom.sequence_entries.append(SequenceEntry(seq_id, gaps))
            if fasta_out is not None:
                write_fasta(
                    fasta_out, f"{chr_id}/{seq_id}", stripped, fasta_line_width
                )
    idx.sort()
    return idx


def build_index_from_a2m(
    a2m_path: str,
    pipe_command: str | None = None,
    fasta_out=None,
    fasta_line_width: int = 0,
    separator: str = "/",
    base_index: MsaIndex | None = None,
) -> MsaIndex:
    """A2M mode (a2m_input_processor,
    index-msa/input_processor.cc:207-288): multi-FASTA whose
    record names are ``chr<sep>seq``."""
    idx = base_index if base_index is not None else MsaIndex()
    data = _read_input_file(a2m_path, pipe_command)

    def handle(name: str, seq: bytes) -> None:
        pos = name.find(separator)
        if pos < 0:
            raise ValueError(f"A2M record name {name!r} lacks separator {separator!r}")
        chr_id, seq_id = name[:pos], name[pos + len(separator):]
        gaps = GapBitVector.from_gap_string(seq)
        chrom = idx.get_or_add_chr(chr_id)
        chrom.sequence_entries.append(SequenceEntry(seq_id, gaps))
        if fasta_out is not None:
            write_fasta(fasta_out, name, seq.replace(b"-", b""), fasta_line_width)

    # record-wise split: one C-level replace per sequence instead of a
    # Python object per wrapped line (GB-scale A2M in bowtie2-workflow)
    start = data.find(b">")
    if start >= 0:
        for rec in data[start + 1:].split(b"\n>"):
            header, _, body = rec.partition(b"\n")
            name = header.rstrip(b"\r").split()[0].decode()
            seq = body.replace(b"\n", b"").replace(b"\r", b"")
            handle(name, seq)
    idx.sort()
    return idx


def list_contents(index: MsaIndex, out=sys.stdout) -> None:
    """--list-contents (mirrors index-msa/main.cc:61-86)."""
    for chrom in index.chr_entries:
        print(chrom.chr_id, file=out)
        for entry in chrom.sequence_entries:
            print(
                f"\t{entry.seq_id}\t{entry.unaligned_length}\t{entry.aligned_length}",
                file=out,
            )


def query_repl(index: MsaIndex, chr_id: str, in_stream=None, out=None) -> None:
    """Interactive position-projection loop (the --query mode,
    index-msa/main.cc:88-190): prompts for a source and a
    destination sequence, then projects entered coordinates; ``s``/``d``
    switch the source/destination sequence; EOF exits.  Input is
    whitespace-token based, so it works identically when piped."""
    import sys as _sys

    in_stream = in_stream or _sys.stdin
    out = out or _sys.stdout
    chrom = index.find_chr(chr_id)
    if chrom is None:
        raise KeyError(f"No entry for chromosome '{chr_id}'")

    def _tokens():
        for line in in_stream:
            yield from line.split()

    tok = _tokens()

    def read_seq(msg):
        while True:
            print(msg, end="", flush=True, file=out)
            t = next(tok, None)
            if t is None:
                return None
            entry = chrom.find(t)
            if entry is not None:
                return entry
            print(f"No entry for sequence '{t}'.", file=_sys.stderr)

    src = read_seq("Source sequence identifier? ")
    if src is None:
        return
    dst = read_seq("Destination sequence identifier? ")
    if dst is None:
        return
    while True:
        pos_limit = src.unaligned_length
        print(
            f"[{src.seq_id} → {dst.seq_id}] Source co-ordinate or 's' "
            f"or 'd' to switch sequence? ([0, {pos_limit})) ",
            end="", flush=True, file=out,
        )
        t = next(tok, None)
        if t is None:
            return
        if t == "s":
            src = read_seq("Source sequence identifier? ")
            if src is None:
                return
        elif t == "d":
            dst = read_seq("Destination sequence identifier? ")
            if dst is None:
                return
        else:
            try:
                pos = int(t)
            except ValueError:
                continue
            if not 0 <= pos < pos_limit:
                continue
            print(int(src.project_position(pos, dst)), file=out)


def query_positions(
    index: MsaIndex,
    chr_id: str,
    queries: list[tuple[str, str, int]],
    out=sys.stdout,
) -> list[int]:
    """Project positions between sequences of one chromosome (the
    interactive --query mode, index-msa/main.cc:88-190).
    Each query is (src_seq_id, dst_seq_id, pos)."""
    chrom = index.find_chr(chr_id)
    if chrom is None:
        raise KeyError(f"chromosome {chr_id!r} not in index")
    results = []
    for src_id, dst_id, pos in queries:
        src = chrom.find(src_id)
        dst = chrom.find(dst_id)
        if src is None or dst is None:
            raise KeyError(f"sequence {src_id!r} or {dst_id!r} not in index")
        projected = int(src.project_position(pos, dst))
        results.append(projected)
        print(f"{src_id}\t{dst_id}\t{pos}\t{projected}", file=out)
    return results
