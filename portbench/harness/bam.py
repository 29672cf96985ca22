"""BAM and BGZF written from the pool's arrays, without the program.

The pool's records are encoded once, vectorised by CIGAR length, and
compressed into BGZF blocks that hold only records (the header has blocks
of its own).  A call's input repeats those blocks ``repeats`` times
between the header and the end-of-file block: its records are the pool's,
``repeats`` passes over, and only the pool is ever compressed.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import struct
import zlib

import numpy as np


BGZF_EOF = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")
BLOCK_DATA = 65280  # bytes of data per block, as htslib writes them
LEVEL = 6  # zlib's default, as samtools writes BAM
_CODE = np.zeros(256, np.uint8)
for _i, _c in enumerate(b"=ACMGRSVTWYHKDBN"):
    _CODE[_c] = _i
OP_CODE = np.array([0, 1, 2], np.uint32)  # BAM codes of the pool's M, I, D


def reg2bin(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    """The BAM index bin of [beg, end), as the SAM specification gives it."""
    end = end - 1
    out = np.zeros(len(beg), np.int64)
    done = np.zeros(len(beg), bool)
    for shift, base in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        hit = ~done & ((beg >> shift) == (end >> shift))
        out[hit] = base + (beg[hit] >> shift)
        done |= hit
    return out


def _cols(*parts) -> np.ndarray:
    """Concatenate (n, k) uint8 views of little-endian arrays column-wise."""
    n = len(parts[0])
    return np.concatenate(
        [np.ascontiguousarray(p.astype(p.dtype.newbyteorder("<"))).view(np.uint8).reshape(n, -1)
         for p in parts],
        axis=1,
    )


def _names(pair: np.ndarray, width: int) -> np.ndarray:
    """(n, width + 2) uint8: 'p' and the pair number in ``width`` digits, NUL."""
    digits = (pair[:, None] // 10 ** np.arange(width - 1, -1, -1)[None, :]) % 10
    n = len(pair)
    return np.concatenate(
        [np.full((n, 1), ord("p"), np.uint8), (digits + ord("0")).astype(np.uint8),
         np.zeros((n, 1), np.uint8)], axis=1,
    )


def encode_records(pool: dict, mapq: int) -> bytes:
    """The pool's records, in order, as one uncompressed BAM record
    stream, with bowtie2's tags but ``MD``."""
    seqs = pool["seq"]
    n, length = seqs.shape
    width = len(str(int(pool["pair"].max())))
    codes = _CODE[seqs]
    if length % 2:
        codes = np.concatenate([codes, np.zeros((n, 1), np.uint8)], axis=1)
    packed = (codes[:, 0::2] << 4) | codes[:, 1::2]
    n_ops = pool["n_ops"]
    has_xs = pool["has_XS"]
    # AS, XS (where the read has it), XN, XM, XO, XG, NM, YS, YT
    tag_bytes = 5 + 5 * has_xs + 4 * 5 + 5 + 6
    sizes = 4 + 32 + (width + 2) + 4 * n_ops + packed.shape[1] + length + tag_bytes
    ends = np.cumsum(sizes)
    starts = ends - sizes
    out = np.empty(int(ends[-1]), np.uint8)
    for k in np.unique(n_ops).tolist():
        for xs in (False, True):
            sel = np.flatnonzero((n_ops == k) & (has_xs == xs))
            if not len(sel):
                continue
            m = len(sel)
            cig = (pool["counts"][sel, :k].astype(np.uint32) << 4) | OP_CODE[pool["ops"][sel, :k]]
            row = pool["row"][sel].astype(np.int32)
            pos = pool["pos"][sel]

            def tag(name, typ, values=None, dtype=None):
                head = np.tile(np.frombuffer(name + typ, np.uint8), (m, 1))
                return head if values is None else np.concatenate(
                    [head, _cols(values[sel].astype(dtype))], axis=1)

            parts = [
                _cols(
                    (sizes[sel] - 4).astype(np.int32), row, pos.astype(np.int32),
                    np.full(m, width + 2, np.uint8), np.full(m, mapq, np.uint8),
                    reg2bin(pos, pos + pool["span"][sel]).astype(np.uint16), np.full(m, k, np.uint16),
                    pool["flag"][sel].astype(np.uint16), np.full(m, length, np.int32), row,
                    pool["mate_pos"][sel].astype(np.int32), pool["tlen"][sel].astype(np.int32),
                ),
                _names(pool["pair"][sel], width),
                _cols(cig),
                packed[sel],
                pool["qual"][sel] - 33,
                tag(b"AS", b"s", pool["AS"], np.int16),
            ]
            if xs:
                parts.append(tag(b"XS", b"s", pool["XS"], np.int16))
            parts += [
                tag(b"XN", b"C", np.zeros(len(pool["AS"]), np.uint8), np.uint8),
                tag(b"XM", b"C", pool["XM"], np.uint8), tag(b"XO", b"C", pool["XO"], np.uint8),
                tag(b"XG", b"C", pool["XG"], np.uint8), tag(b"NM", b"C", pool["NM"], np.uint8),
                tag(b"YS", b"s", pool["YS"], np.int16),
                np.concatenate([tag(b"YT", b"Z"), np.tile(np.frombuffer(b"CP\0", np.uint8), (m, 1))], axis=1),
            ]
            block = np.concatenate(parts, axis=1)
            out[starts[sel, None] + np.arange(block.shape[1])[None, :]] = block
    return out.tobytes()


def header_bytes(text: str, refs: list[tuple[str, int]]) -> bytes:
    """The BAM header: magic, SAM header text and the reference list."""
    raw = text.encode()
    out = [b"BAM\x01", struct.pack("<i", len(raw)), raw, struct.pack("<i", len(refs))]
    for name, length in refs:
        name_z = name.encode() + b"\0"
        out += [struct.pack("<i", len(name_z)), name_z, struct.pack("<i", length)]
    return b"".join(out)


def _block(data: bytes) -> bytes:
    comp = zlib.compressobj(LEVEL, zlib.DEFLATED, -15)
    body = comp.compress(data) + comp.flush()
    return (
        b"\x1f\x8b\x08\x04\0\0\0\0\0\xff\x06\0BC\x02\0"
        + struct.pack("<H", len(body) + 25) + body
        + struct.pack("<II", zlib.crc32(data), len(data))
    )


def bgzf_blocks(data: bytes, threads: int = 8) -> bytes:
    """``data`` as whole BGZF blocks (no end-of-file block)."""
    parts = [data[i:i + BLOCK_DATA] for i in range(0, len(data), BLOCK_DATA)]
    with cf.ThreadPoolExecutor(max(1, min(threads, os.cpu_count() or 1))) as pool:
        return b"".join(pool.map(_block, parts))


def write_bam(path, header: bytes, records: bytes, repeats: int) -> int:
    """Write a BAM whose records are ``records`` ``repeats`` times over;
    returns the bytes written."""
    head = bgzf_blocks(header)
    body = bgzf_blocks(records)
    with open(path, "wb") as fh:
        fh.write(head)
        for _ in range(repeats):
            fh.write(body)
        fh.write(BGZF_EOF)
    return len(head) + repeats * len(body) + len(BGZF_EOF)

