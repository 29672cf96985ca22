"""SAM records, headers, readers and writers (copy of
``panvc3_tpu.io.sam``, trimmed to what the port calls).  Records parse and
format in C (the port's build of the host extension); BAM input and
output are not ported (ROADMAP Queue 1 item 8) and raise.  Conventions
match seqan3's observable output:

- positions are stored 0-based internally (-1 == unset); SAM text uses
  1-based with 0 for missing,
- optional tags are emitted sorted by their two-character tag (seqan3 keeps
  tags in a std::map keyed by the 16-bit tag value, so its output is always
  tag-sorted),
- integer tags are written with type 'i' regardless of the BAM storage
  width, matching htslib/seqan3 SAM text behaviour.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..cigar import Cigar
from ..native import get_native

_BAM_NOT_PORTED = "BAM input/output on the port is ROADMAP Queue 1 item 8"
FLAG_REVERSE = 0x10


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

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & FLAG_REVERSE)


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


# -- file-level readers/writers --------------------------------------------

class SamReader:
    """Streaming reader over SAM text, plain or gzipped."""

    def __init__(self, path_or_fh):
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
        if self._fh.peek(4)[:2] == b"\x1f\x8b":
            # gzip container: BAM (BGZF with a BAM\1 payload) or gzipped SAM
            # text — peek at the decompressed head to tell them apart
            probe = _gzip.GzipFile(fileobj=_io.BytesIO(self._fh.peek(65536)))
            try:
                inner = probe.read(4)
            except (OSError, EOFError):
                inner = b""
            if inner == b"BAM\x01":
                raise NotImplementedError(_BAM_NOT_PORTED)
            self._fh = _io.BufferedReader(_gzip.GzipFile(fileobj=self._fh))
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

    def raw_record_line_blocks(self, hint: int = 1 << 20):
        """Yield blocks (lists) of raw record line bytes (the fast lane
        consumes lines without building SamRecord objects)."""
        if self._first_record_line is not None:
            first = self._first_record_line.encode()
            self._first_record_line = None
            yield [first]
        while True:
            block = self._fh.readlines(hint)
            if not block:
                return
            yield block

    def __iter__(self):
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
    """SAM text writer."""

    def __init__(self, path_or_fh, header: SamHeader, *, bam: bool = False):
        if bam:
            raise NotImplementedError(_BAM_NOT_PORTED)
        if isinstance(path_or_fh, str):
            self._fh = open(path_or_fh, "wb")
            self._owns = True
        else:
            self._fh = path_or_fh
            self._owns = False
        self.header = header
        self._fh.write(header.to_text().encode())

    def write(self, rec: SamRecord) -> None:
        self._fh.write(format_sam_record(rec, self.header).encode() + b"\n")

    def write_raw(self, blob: bytes) -> None:
        """Write pre-formatted SAM text (newline-terminated lines)."""
        self._fh.write(blob)

    def close(self) -> None:
        self._fh.flush()
        if self._owns:
            self._fh.close()
