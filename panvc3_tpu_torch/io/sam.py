"""SAM/BAM records, headers, readers and writers (copy of
``panvc3_tpu.io.sam``, trimmed to what the port calls).  SAM text parses
and formats in C (the port's build of the host extension), which also
converts BAM record regions to SAM text lines and back; ``SamWriter.write``
encodes BAM records in Python.  Conventions match seqan3's observable
output:

- positions are stored 0-based internally (-1 == unset); SAM text uses
  1-based with 0 for missing,
- optional tags are emitted sorted by their two-character tag (seqan3 keeps
  tags in a std::map keyed by the 16-bit tag value, so its output is always
  tag-sorted),
- integer tags are written with type 'i' regardless of the BAM storage
  width, matching htslib/seqan3 SAM text behaviour.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from .bgzf import BgzfWriter, bgzf_threads, whole_block_prefix
from ..native import get_native
from ..cigar import Cigar, OPS, cigar_query_length

# FLAG bits (SAMv1)
FLAG_UNMAPPED = 0x4
FLAG_REVERSE = 0x10

_BAM_SEQ_CODE = "=ACMGRSVTWYHKDBN"
_BAM_SEQ_ENCODE = {c: i for i, c in enumerate(_BAM_SEQ_CODE)}
for _c, _i in list(_BAM_SEQ_ENCODE.items()):
    _BAM_SEQ_ENCODE[_c.lower()] = _i

# bulk codec tables: the per-base loops run in C via bytes.translate /
# bytes.hex / bytes.fromhex instead of Python-level character loops
_BAM_SEQ_HEX_DECODE = str.maketrans("0123456789abcdef", _BAM_SEQ_CODE)
_BAM_SEQ_BYTE_ENCODE = bytes(_BAM_SEQ_ENCODE.get(chr(i), 15) for i in range(256))
_CODE_TO_HEX = b"0123456789abcdef" + bytes(240)
_QUAL_SUB33 = bytes((i - 33) & 0xFF for i in range(256))
_QUAL_ADD33 = bytes((i + 33) & 0xFF for i in range(256))
_OP_TO_CODE = {op: i for i, op in enumerate("MIDNSHP=X")}


@dataclass
class SamHeader:
    """Parsed SAM header: raw lines (in order) + reference dictionary."""

    lines: list[str] = field(default_factory=list)
    ref_names: list[str] = field(default_factory=list)
    ref_lengths: list[int] = field(default_factory=list)
    # residual @SQ fields beyond SN/LN (tab-joined, input order), copied
    # onto the output header by project_alignments
    ref_extras: list[str] = field(default_factory=list)

    @classmethod
    def parse(cls, text: str) -> "SamHeader":
        hdr = cls()
        for line in text.splitlines():
            if not line:
                continue
            hdr.lines.append(line)
            if line.startswith("@SQ"):
                name = length = None
                extras = []
                for fld in line.split("\t")[1:]:
                    if fld.startswith("SN:"):
                        name = fld[3:]
                    elif fld.startswith("LN:"):
                        length = int(fld[3:])
                    else:
                        extras.append(fld)
                if name is None or length is None:
                    raise ValueError(f"invalid @SQ line: {line!r}")
                hdr.ref_names.append(name)
                hdr.ref_lengths.append(length)
                hdr.ref_extras.append("\t".join(extras))
        return hdr

    def ref_id(self, name: str) -> int:
        try:
            return self.ref_names.index(name)
        except ValueError:
            return -1

    def to_text(self) -> str:
        return "".join(line + "\n" for line in self.lines)

    def last_pg_id(self) -> str | None:
        last = None
        for line in self.lines:
            if line.startswith("@PG"):
                for fld in line.split("\t")[1:]:
                    if fld.startswith("ID:"):
                        last = fld[3:]
        return last

    def append_program(
        self, base_id: str, name: str, command_line: str, version: str
    ) -> None:
        """Append a @PG line chained onto the previous one via PP, with an
        ID made unique by suffixing ``.N``."""
        existing = set()
        for line in self.lines:
            if line.startswith("@PG"):
                for fld in line.split("\t")[1:]:
                    if fld.startswith("ID:"):
                        existing.add(fld[3:])
        pg_id = base_id
        i = 1
        while pg_id in existing:
            pg_id = f"{base_id}.{i}"
            i += 1
        prev = self.last_pg_id()
        parts = [f"@PG\tID:{pg_id}", f"PN:{name}"]
        if prev is not None:
            parts.append(f"PP:{prev}")
        parts.append(f"CL:{command_line}")
        parts.append(f"VN:{version}")
        self.lines.append("\t".join(parts))


@dataclass(slots=True)
class SamRecord:
    qname: str = "*"
    flag: int = 0
    ref_id: int = -1          # index into header ref_names; -1 == '*'
    pos: int = -1             # 0-based; -1 == unset
    mapq: int = 255
    cigar: Cigar = field(default_factory=list)
    mate_ref_id: int = -1     # -2 encodes '=' pending resolution (text parse)
    mate_pos: int = -1
    tlen: int = 0
    seq: str = "*"
    qual: str = "*"
    tags: dict[str, tuple[str, object]] = field(default_factory=dict)

    # -- flag helpers ------------------------------------------------------
    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & FLAG_UNMAPPED)

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & FLAG_REVERSE)

    def query_length(self) -> int:
        if self.seq != "*":
            return len(self.seq)
        return cigar_query_length(self.cigar)


# -- tag codecs -------------------------------------------------------------

def format_float(v: float) -> str:
    """Format a float tag value exactly like C++ ``std::to_chars`` on float
    (the reference's seqan3 SAM writer): the shortest digit string that
    round-trips float32, printed fixed unless scientific is strictly
    shorter, with the exact-integer tiebreak for zero-padded integral
    values (closest-to-value rule)."""
    import numpy as np

    f = np.float32(v)
    if np.isnan(f):
        return "-nan" if np.signbit(f) else "nan"
    if np.isinf(f):
        return "-inf" if f < 0 else "inf"
    if f == 0:
        return "-0" if np.signbit(f) else "0"
    s = np.format_float_scientific(f, unique=True, trim="-")
    neg = s.startswith("-")
    if neg:
        s = s[1:]
    mant, _, ex = s.partition("e")
    exp10 = int(ex)
    digits = mant.replace(".", "")
    nd = len(digits)
    sci = (
        digits[0]
        + ("." + digits[1:] if nd > 1 else "")
        + f"e{'+' if exp10 >= 0 else '-'}{abs(exp10):02d}"
    )
    if exp10 >= 0:
        if exp10 + 1 > nd:
            # padding the shortest digits with zeros costs the same
            # characters as the exact integer, which is closer to the
            # value — to_chars prints the exact integer
            af = abs(float(f))
            fixed = str(int(af)) if af == int(af) else digits + "0" * (exp10 + 1 - nd)
        elif exp10 + 1 == nd:
            fixed = digits
        else:
            fixed = digits[: exp10 + 1] + "." + digits[exp10 + 1 :]
    else:
        fixed = "0." + "0" * (-exp10 - 1) + digits
    out = sci if len(sci) < len(fixed) else fixed
    return ("-" + out) if neg else out


# -- SAM text ---------------------------------------------------------------

def parse_sam_record(line: str, header: SamHeader) -> SamRecord:
    (qname, flag, rname, pos, mapq, cigar, rnext, pnext, tlen, seq,
     qual, tags) = get_native().parse_sam_line(line)
    ref_id = header.ref_id(rname) if rname != "*" else -1
    if rname != "*" and ref_id < 0:
        raise ValueError(f"unknown reference {rname!r}")
    rec = SamRecord(
        qname=qname, flag=flag, ref_id=ref_id, pos=pos, mapq=mapq,
        cigar=cigar, tlen=tlen, seq=seq, qual=qual, tags=tags,
    )
    if rnext == "*":
        rec.mate_ref_id = -1
    elif rnext == "=":
        rec.mate_ref_id = rec.ref_id
    else:
        rec.mate_ref_id = header.ref_id(rnext)
        if rec.mate_ref_id < 0:
            raise ValueError(f"unknown mate reference {rnext!r}")
    rec.mate_pos = pnext
    return rec


def format_sam_record(rec: SamRecord, header: SamHeader) -> str:
    rname = header.ref_names[rec.ref_id] if rec.ref_id >= 0 else "*"
    if rec.mate_ref_id < 0:
        rnext = "*"
    elif rec.mate_ref_id == rec.ref_id and rec.ref_id >= 0:
        rnext = "="
    else:
        rnext = header.ref_names[rec.mate_ref_id]
    return get_native().format_sam_line(
        rec.qname, rec.flag, rname, rec.pos, rec.mapq,
        rec.cigar if rec.cigar else [], rnext, rec.mate_pos, rec.tlen,
        rec.seq if rec.seq else "*", rec.qual if rec.qual else "*",
        rec.tags, format_float,
    )


# -- BAM --------------------------------------------------------------------

def _decode_bam_tags(buf: bytes) -> dict[str, tuple[str, object]]:
    tags: dict[str, tuple[str, object]] = {}
    off = 0
    n = len(buf)
    int_fmt = {"c": "<b", "C": "<B", "s": "<h", "S": "<H", "i": "<i", "I": "<I"}
    int_sz = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4}
    while off < n:
        tag = buf[off:off + 2].decode()
        typ = chr(buf[off + 2])
        off += 3
        if typ == "A":
            tags[tag] = ("A", chr(buf[off]))
            off += 1
        elif typ in int_fmt:
            (v,) = struct.unpack_from(int_fmt[typ], buf, off)
            off += int_sz[typ]
            tags[tag] = ("i", v)
        elif typ == "f":
            (v,) = struct.unpack_from("<f", buf, off)
            off += 4
            tags[tag] = ("f", v)
        elif typ in ("Z", "H"):
            end = buf.index(0, off)
            tags[tag] = (typ, buf[off:end].decode())
            off = end + 1
        elif typ == "B":
            sub = chr(buf[off])
            (cnt,) = struct.unpack_from("<I", buf, off + 1)
            off += 5
            if sub == "f":
                vals = list(struct.unpack_from(f"<{cnt}f", buf, off))
                off += 4 * cnt
            else:
                fmt = {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i", "I": "I"}[sub]
                vals = list(struct.unpack_from(f"<{cnt}{fmt}", buf, off))
                off += int_sz[sub] * cnt
            tags[tag] = ("B", (sub, vals))
        else:
            raise ValueError(f"unknown BAM tag type {typ!r}")
    return tags


def _encode_bam_tags(tags: dict[str, tuple[str, object]]) -> bytes:
    out = bytearray()
    for tag in sorted(tags):
        typ, val = tags[tag]
        out += tag.encode()
        if typ == "A":
            out += b"A" + val.encode()
        elif typ == "i":
            v = int(val)
            # choose the smallest width like htslib does
            if 0 <= v <= 0xFF:
                out += b"C" + struct.pack("<B", v)
            elif -0x80 <= v < 0x80:
                out += b"c" + struct.pack("<b", v)
            elif 0 <= v <= 0xFFFF:
                out += b"S" + struct.pack("<H", v)
            elif -0x8000 <= v < 0x8000:
                out += b"s" + struct.pack("<h", v)
            elif v < 0:
                out += b"i" + struct.pack("<i", v)
            else:
                out += b"I" + struct.pack("<I", v)
        elif typ == "f":
            out += b"f" + struct.pack("<f", float(val))
        elif typ in ("Z", "H"):
            out += typ.encode() + val.encode() + b"\x00"
        elif typ == "B":
            sub, items = val
            out += b"B" + sub.encode() + struct.pack("<I", len(items))
            fmt = {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i", "I": "I", "f": "f"}[sub]
            for x in items:
                out += struct.pack("<" + fmt, x)
        else:
            raise ValueError(f"unknown tag type {typ!r}")
    return bytes(out)


def _decode_bam_record(buf: bytes, header: SamHeader) -> SamRecord:
    (ref_id, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq,
     next_ref, next_pos, tlen) = struct.unpack_from("<iiBBHHHiiii", buf, 0)
    off = 32
    qname = buf[off:off + l_read_name - 1].decode()
    off += l_read_name
    cigar: Cigar = []
    for _ in range(n_cigar):
        (v,) = struct.unpack_from("<I", buf, off)
        off += 4
        cigar.append((v >> 4, OPS[v & 0xF]))
    if l_seq:
        nb = (l_seq + 1) // 2
        raw = buf[off:off + nb]
        off += nb
        # each nibble is one base: hex-expand then map hex digit -> base
        seq = raw.hex().translate(_BAM_SEQ_HEX_DECODE)[:l_seq]
        qraw = buf[off:off + l_seq]
        off += l_seq
        qual = (
            "*" if qraw[0] == 0xFF
            else qraw.translate(_QUAL_ADD33).decode("latin-1")
        )
    else:
        seq = "*"
        qual = "*"
    tags = _decode_bam_tags(buf[off:])
    return SamRecord(
        qname=qname, flag=flag, ref_id=ref_id, pos=pos, mapq=mapq,
        cigar=cigar, mate_ref_id=next_ref, mate_pos=next_pos, tlen=tlen,
        seq=seq, qual=qual, tags=tags,
    )


def _encode_bam_record(rec: SamRecord) -> bytes:
    qname_b = rec.qname.encode() + b"\x00"
    cigar_b = struct.pack(
        "<%dI" % len(rec.cigar),
        *((n << 4) | _OP_TO_CODE[op] for n, op in rec.cigar),
    )
    if rec.seq != "*":
        l_seq = len(rec.seq)
        codes = rec.seq.encode("latin-1").translate(_BAM_SEQ_BYTE_ENCODE)
        if l_seq % 2:
            codes += b"\x00"
        # pair nibbles: code bytes -> hex digits -> packed bytes
        seq_b = bytes.fromhex(codes.translate(_CODE_TO_HEX).decode("ascii"))
        if rec.qual == "*":
            qual_b = b"\xff" * l_seq
        else:
            qual_b = rec.qual.encode("latin-1").translate(_QUAL_SUB33)
    else:
        l_seq = 0
        seq_b = b""
        qual_b = b""
    tags_b = _encode_bam_tags(rec.tags)
    body = struct.pack(
        "<iiBBHHHiiii",
        rec.ref_id, rec.pos, len(qname_b), rec.mapq, 0,
        len(rec.cigar), rec.flag, l_seq, rec.mate_ref_id, rec.mate_pos, rec.tlen,
    ) + qname_b + bytes(cigar_b) + bytes(seq_b) + qual_b + tags_b
    return struct.pack("<I", len(body)) + body


# -- file-level readers/writers --------------------------------------------

class SamReader:
    """Streaming reader over SAM text or BAM (auto-detected)."""

    def __init__(self, path_or_fh, *, is_bam: bool | None = None):
        import gzip as _gzip
        import io as _io

        if isinstance(path_or_fh, str):
            fh = open(path_or_fh, "rb")
            self._owns = True
        else:
            fh = path_or_fh
            self._owns = False
        if not isinstance(fh, _io.BufferedReader) or not hasattr(fh, "peek"):
            fh = _io.BufferedReader(fh)
        self._fh = fh
        head = self._fh.peek(4)[:4]
        if is_bam is None and head[:2] == b"\x1f\x8b":
            # gzip container: BAM (BGZF with a BAM\1 payload) or gzipped SAM
            # text — peek at the decompressed head to tell them apart
            probe = _gzip.GzipFile(fileobj=_io.BytesIO(self._fh.peek(65536)))
            try:
                inner = probe.read(4)
            except (OSError, EOFError):
                inner = b""
            if inner == b"BAM\x01":
                is_bam = True
            else:
                is_bam = False
                self._fh = _io.BufferedReader(_gzip.GzipFile(fileobj=self._fh))
        if is_bam is None:
            is_bam = False
        self.is_bam = is_bam
        self.header: SamHeader
        if is_bam:
            self._init_bam()
        else:
            self._init_sam()

    # SAM text ---------------------------------------------------------
    def _init_sam(self):
        header_lines = []
        self._first_record_line: str | None = None
        while True:
            line = self._fh.readline()
            if not line:
                break
            text = line.decode()
            if text.startswith("@"):
                header_lines.append(text.rstrip("\n"))
            else:
                self._first_record_line = text
                break
        self.header = SamHeader.parse("\n".join(header_lines))

    # BAM --------------------------------------------------------------
    def _init_bam(self):
        self._bam_buf = bytearray()
        self._bam_comp = bytearray()
        self._bam_eof = False
        data = self._bam_need(4)
        if data[:4] != b"BAM\x01":
            raise ValueError("not a BAM file")
        self._bam_skip(4)
        (l_text,) = struct.unpack("<i", self._bam_need(4)[:4])
        self._bam_skip(4)
        text = self._bam_need(l_text)[:l_text].decode()
        self._bam_skip(l_text)
        (n_ref,) = struct.unpack("<i", self._bam_need(4)[:4])
        self._bam_skip(4)
        ref_names = []
        ref_lengths = []
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", self._bam_need(4)[:4])
            self._bam_skip(4)
            name = self._bam_need(l_name)[:l_name - 1].decode()
            self._bam_skip(l_name)
            (l_ref,) = struct.unpack("<i", self._bam_need(4)[:4])
            self._bam_skip(4)
            ref_names.append(name)
            ref_lengths.append(l_ref)
        self.header = SamHeader.parse(text)
        # trust the binary reference list if the text header lacks @SQ
        if not self.header.ref_names:
            self.header.ref_names = ref_names
            self.header.ref_lengths = ref_lengths
            self.header.ref_extras = [""] * len(ref_names)
            for n, l in zip(ref_names, ref_lengths):
                self.header.lines.append(f"@SQ\tSN:{n}\tLN:{l}")

    def _bam_fill(self) -> bool:
        # inflate all whole blocks of a ~4 MiB compressed chunk at once, in
        # parallel (the compressed remainder carries to the next fill)
        comp = self._bam_comp
        while True:
            chunk = self._fh.read(1 << 22)
            if chunk:
                comp += chunk
            p = whole_block_prefix(comp)
            if p:
                self._bam_buf += get_native().bgzf_decompress(
                    bytes(comp[:p]), bgzf_threads()
                )
                del comp[:p]
                return True
            if not chunk:
                self._bam_eof = True
                if comp:
                    raise ValueError("truncated BGZF block at EOF")
                return False

    def _bam_need(self, n: int) -> bytes:
        while len(self._bam_buf) < n and not self._bam_eof:
            self._bam_fill()
        return bytes(self._bam_buf[:n])

    def _bam_skip(self, n: int) -> None:
        del self._bam_buf[:n]

    def take_bam_stream(self):
        """Hands the BAM input past the header to another reader: (the
        inflated bytes not yet read, the compressed bytes not yet
        inflated, the file, whether its end was reached).  This reader
        reads no record after it."""
        out = (bytes(self._bam_buf), bytes(self._bam_comp), self._fh, self._bam_eof)
        self._bam_buf, self._bam_comp, self._bam_eof = bytearray(), bytearray(), True
        return out

    def raw_record_line_blocks(self, hint: int = 1 << 20):
        """Yield blocks (lists) of raw record line bytes.

        The fast lanes consume lines directly without building SamRecord
        objects.  BAM input converts record regions to SAM text lines in C
        (bam_to_sam_lines); SAM text streams pass through."""
        if self.is_bam:
            nat = get_native()
            names = self.header.ref_names
            need = hint
            while True:
                while len(self._bam_buf) < need and not self._bam_eof:
                    self._bam_fill()
                if not self._bam_buf:
                    return
                lines, consumed = nat.bam_to_sam_lines(
                    bytes(self._bam_buf), names
                )
                if consumed == 0:
                    if self._bam_eof:
                        raise ValueError("truncated BAM record at EOF")
                    need = len(self._bam_buf) * 2  # record spans the buffer
                    continue
                need = hint
                self._bam_skip(consumed)
                if lines:
                    yield lines
            return
        if self._first_record_line is not None:
            first = self._first_record_line.encode()
            self._first_record_line = None
            yield [first]
        while True:
            block = self._fh.readlines(hint)
            if not block:
                return
            yield block

    # ------------------------------------------------------------------
    def __iter__(self):
        if self.is_bam:
            # C decode to SAM text + C text parse; record values equal
            # those of _decode_bam_record
            for block in self.raw_record_line_blocks():
                for ln in block:
                    yield parse_sam_record(ln.decode(), self.header)
            return
        if self._first_record_line is not None:
            yield parse_sam_record(self._first_record_line, self.header)
            self._first_record_line = None
        while True:
            line = self._fh.readline()
            if not line:
                break
            text = line.decode()
            if text.strip():
                yield parse_sam_record(text, self.header)

    def close(self):
        if self._owns:
            self._fh.close()


class SamWriter:
    """SAM text or BAM writer."""

    def __init__(self, path_or_fh, header: SamHeader, *, bam: bool = False):
        if isinstance(path_or_fh, str):
            self._fh = open(path_or_fh, "wb")
            self._owns = True
        else:
            self._fh = path_or_fh
            self._owns = False
        self.header = header
        self.bam = bam
        if bam:
            self._bgzf = BgzfWriter(self._fh)
            text = header.to_text().encode()
            out = b"BAM\x01" + struct.pack("<i", len(text)) + text
            out += struct.pack("<i", len(header.ref_names))
            for name, length in zip(header.ref_names, header.ref_lengths):
                nb = name.encode() + b"\x00"
                out += struct.pack("<i", len(nb)) + nb + struct.pack("<i", length)
            self._bgzf.write(out)
        else:
            self._fh.write(header.to_text().encode())

    def write(self, rec: SamRecord) -> None:
        if self.bam:
            self._bgzf.write(_encode_bam_record(rec))
        else:
            self._fh.write(format_sam_record(rec, self.header).encode() + b"\n")

    def write_raw(self, blob: bytes, names: list[str] | None = None) -> None:
        """Write pre-formatted SAM text (newline-terminated lines).

        BAM mode converts the text blob to BAM records in C
        (sam_text_to_bam) and streams them through the BGZF writer.
        ``names`` overrides the RNAME lookup table for the conversion (used
        when the output header renames references but the text still
        carries the input names — BAM stores reference ids)."""
        if self.bam:
            self._bgzf.write(
                get_native().sam_text_to_bam(
                    blob, names or self.header.ref_names
                )
            )
            return
        self._fh.write(blob)

    def close(self) -> None:
        if self.bam:
            self._bgzf.close()
        self._fh.flush()
        if self._owns:
            self._fh.close()
