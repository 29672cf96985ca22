"""BGZF (blocked gzip) reading and writing, for bgzip-compressed FASTA
with ``.gzi`` block indexes and for BAM (copy of ``panvc3_tpu.io.bgzf``).
Blocks inflate and deflate in parallel in the C host extension.
"""

from __future__ import annotations

import os
import struct

from ..native import get_native

BGZF_MAGIC = b"\x1f\x8b\x08\x04"
# Empty BGZF block used as EOF marker (fixed 28-byte sequence from the spec).
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)
MAX_BLOCK_UNCOMPRESSED = 65280


def is_bgzf(path: str) -> bool:
    with open(path, "rb") as fh:
        return fh.read(4) == BGZF_MAGIC


def bgzf_threads() -> int:
    v = os.environ.get("PANVC3_BGZF_THREADS")
    if v:
        return max(1, int(v))
    return min(8, os.cpu_count() or 1)


def _parse_block_header(buf, off: int) -> int:
    """BSIZE (total compressed block size) of the block at ``off``, or 0
    if the header is incomplete; raises on a non-BGZF prefix."""
    if off + 12 > len(buf):
        return 0
    if bytes(buf[off:off + 4]) != BGZF_MAGIC:
        raise ValueError("not a BGZF block")
    xlen = struct.unpack_from("<H", buf, off + 10)[0]
    end = off + 12 + xlen
    if end > len(buf):
        return 0
    xo = off + 12
    while xo + 4 <= end:
        si1, si2 = buf[xo], buf[xo + 1]
        slen = struct.unpack_from("<H", buf, xo + 2)[0]
        if si1 == 66 and si2 == 67 and slen == 2 and xo + 6 <= end:
            return struct.unpack_from("<H", buf, xo + 4)[0] + 1
        xo += 4 + slen
    raise ValueError("BGZF block without BC subfield")


def whole_block_prefix(buf) -> int:
    """Largest p such that buf[:p] consists of whole BGZF blocks."""
    off = 0
    n = len(buf)
    while off < n:
        bsize = _parse_block_header(buf, off)
        if bsize == 0 or off + bsize > n:
            break
        off += bsize
    return off


class BgzfReader:
    """Random-access BGZF reader backed by a block index.

    The index is either loaded from a ``.gzi`` file (pairs of
    (compressed offset, uncompressed offset) as little-endian u64, entry
    count first — the bgzip format the reference parses at
    compressed_fasta_reader.cc:163-215) or built by scanning the file.
    """

    def __init__(self, path: str, gzi_path: str | None = None):
        self.path = path
        self._fh = open(path, "rb")
        if gzi_path is not None:
            self._blocks = self._load_gzi(gzi_path)
        else:
            self._blocks = self._scan_blocks()

    @staticmethod
    def _load_gzi(path: str) -> list[tuple[int, int]]:
        with open(path, "rb") as fh:
            (count,) = struct.unpack("<Q", fh.read(8))
            entries = [(0, 0)]
            for _ in range(count):
                comp, uncomp = struct.unpack("<QQ", fh.read(16))
                entries.append((comp, uncomp))
        return entries

    def _scan_blocks(self) -> list[tuple[int, int]]:
        # header-walk only: BSIZE from the BC subfield, ISIZE from the
        # trailer — no inflate needed to build the index
        entries = [(0, 0)]
        comp = uncomp = 0
        self._fh.seek(0)
        while True:
            header = self._fh.read(12)
            if not header:
                break
            if len(header) < 12 or header[:4] != BGZF_MAGIC:
                raise ValueError("not a BGZF block")
            xlen = struct.unpack("<H", header[10:12])[0]
            extra = self._fh.read(xlen)
            bsize = _parse_block_header(header + extra, 0)
            if bsize == 0:
                raise ValueError("truncated BGZF header")
            self._fh.seek(comp + bsize - 4)
            (isize,) = struct.unpack("<I", self._fh.read(4))
            comp += bsize
            uncomp += isize
            entries.append((comp, uncomp))
        return entries

    def read_range(self, start: int, length: int) -> bytes:
        """Read ``length`` uncompressed bytes starting at uncompressed
        offset ``start``, seeking via the block index."""
        if length <= 0:
            return b""
        # find last block with uncompressed offset <= start
        lo, hi = 0, len(self._blocks) - 1
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if self._blocks[mid][1] <= start:
                lo = mid
            else:
                hi = mid - 1
        comp_off, uncomp_off = self._blocks[lo]
        self._fh.seek(comp_off)
        # compressed span covering [start, start+length), inflated in
        # parallel
        j = lo + 1
        nb = len(self._blocks)
        while j < nb and self._blocks[j][1] <= start + length - 1:
            j += 1
        if j < nb:
            span = self._fh.read(self._blocks[j][0] - comp_off)
        else:
            span = self._fh.read()
        data = get_native().bgzf_decompress(span, bgzf_threads())
        off = start - uncomp_off
        return data[off:off + length]


class BgzfWriter:
    """Streaming BGZF writer (used for BAM and bgzipped text output).

    Whole 65280-byte blocks are deflated in parallel over pthreads in
    ~4 MiB batches."""

    def __init__(self, fileobj, level: int = 6):
        self._fh = fileobj
        self._level = level
        self._buf = bytearray()
        self._nat = get_native()
        self._flush_at = MAX_BLOCK_UNCOMPRESSED * 64

    def write(self, data: bytes) -> None:
        self._buf += data
        if len(self._buf) >= self._flush_at:
            whole = (
                len(self._buf) // MAX_BLOCK_UNCOMPRESSED
            ) * MAX_BLOCK_UNCOMPRESSED
            self._fh.write(
                self._nat.bgzf_compress(
                    bytes(self._buf[:whole]), self._level, bgzf_threads()
                )
            )
            del self._buf[:whole]

    def close(self) -> None:
        if self._buf:
            self._fh.write(
                self._nat.bgzf_compress(
                    bytes(self._buf), self._level, bgzf_threads()
                )
            )
            self._buf.clear()
        self._fh.write(BGZF_EOF)
        self._fh.flush()
