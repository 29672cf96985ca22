"""FASTA reading and writing, including random access into
bgzip-compressed FASTA via ``.fai`` + ``.gzi`` indexes (copy of
``panvc3_tpu.io.fasta``): per-sequence random access decompresses from
the nearest indexed block and strips newlines using the faidx line-length
fields.
"""

from __future__ import annotations

import bz2
import gzip
import os
from dataclasses import dataclass

from .bgzf import BgzfReader, is_bgzf


@dataclass
class FaidxEntry:
    name: str
    length: int       # sequence length in bases
    offset: int       # uncompressed byte offset of the first base
    line_bases: int   # bases per line
    line_width: int   # bytes per line incl. newline


def read_faidx(path: str) -> list[FaidxEntry]:
    entries = []
    with open(path) as fh:
        for line in fh:
            if not line.strip():
                continue
            name, length, offset, line_bases, line_width = line.rstrip("\n").split("\t")[:5]
            entries.append(
                FaidxEntry(name, int(length), int(offset), int(line_bases), int(line_width))
            )
    return entries


class FastaReader:
    """Random-access FASTA reader.

    Supports plain FASTA, bgzip FASTA (+ .gzi), and falls back to loading
    gzip/bz2 files wholesale.  ``read_sequence(name)`` returns the raw bytes
    of one sequence (newlines stripped, no case normalisation — matching the
    reference, which compares raw FASTA bytes).
    """

    def __init__(self, path: str):
        self.path = path
        fai = path + ".fai"
        self._entries: dict[str, FaidxEntry] = {}
        self._order: list[str] = []
        self._bgzf: BgzfReader | None = None
        self._data: bytes | None = None

        if os.path.exists(fai):
            for e in read_faidx(fai):
                self._entries[e.name] = e
                self._order.append(e.name)
            if is_bgzf(path):
                gzi = path + ".gzi"
                self._bgzf = BgzfReader(path, gzi if os.path.exists(gzi) else None)
            elif path.endswith(".gz") or path.endswith(".bz2"):
                self._data = self._load_all(path)
            else:
                self._fh = open(path, "rb")
        else:
            self._data = self._load_all(path)
            self._parse_all()

    @staticmethod
    def _load_all(path: str) -> bytes:
        if path.endswith(".bz2"):
            return bz2.open(path, "rb").read()
        if path.endswith(".gz"):
            return gzip.open(path, "rb").read()
        with open(path, "rb") as fh:
            return fh.read()

    def _parse_all(self) -> None:
        """Build in-memory entries when no .fai exists."""
        assert self._data is not None
        self._sequences: dict[str, bytes] = {}
        name = None
        chunks: list[bytes] = []
        for line in self._data.split(b"\n"):
            if line.startswith(b">"):
                if name is not None:
                    self._sequences[name] = b"".join(chunks)
                name = line[1:].split()[0].decode() if len(line) > 1 else ""
                self._order.append(name)
                chunks = []
            elif line:
                chunks.append(line.rstrip(b"\r"))
        if name is not None:
            self._sequences[name] = b"".join(chunks)

    @property
    def names(self) -> list[str]:
        return list(self._order)

    def read_sequence(self, name: str) -> bytes:
        if not self._entries:
            return self._sequences[name]
        e = self._entries[name]
        full_lines = e.length // e.line_bases if e.line_bases else 0
        rem = e.length - full_lines * e.line_bases if e.line_bases else 0
        nbytes = full_lines * e.line_width + rem
        if self._bgzf is not None:
            raw = self._bgzf.read_range(e.offset, nbytes)
        elif self._data is not None:
            raw = self._data[e.offset:e.offset + nbytes]
        else:
            self._fh.seek(e.offset)
            raw = self._fh.read(nbytes)
        if e.line_bases and e.line_width != e.line_bases:
            out = bytearray()
            for i in range(full_lines):
                start = i * e.line_width
                out += raw[start:start + e.line_bases]
            if rem:
                out += raw[full_lines * e.line_width:full_lines * e.line_width + rem]
            seq = bytes(out)
        else:
            seq = raw
        if len(seq) != e.length:
            raise ValueError(f"{self.path}: truncated sequence {name}")
        return seq


def write_fasta(fh, name: str, seq: bytes | str, line_width: int = 0) -> None:
    """Write one FASTA record; ``line_width`` 0 means a single line
    (matching index_msa --fasta-line-width default)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    fh.write(f">{name}\n".encode())
    if line_width <= 0:
        fh.write(seq + b"\n")
    else:
        for i in range(0, len(seq), line_width):
            fh.write(seq[i:i + line_width] + b"\n")
