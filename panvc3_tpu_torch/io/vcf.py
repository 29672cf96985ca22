"""Minimal VCF reader covering what count_supporting_reads needs.

Copy of ``panvc3_tpu.io.vcf``.

Replaces libbio's vcf::reader usage
(count-supporting-reads/main.cc:775-817): streaming parse of
VCF text (plain or gzipped), GT genotypes of a single sample, the END info
field, and presence checks for flag info fields (CO/USRA).
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass


@dataclass
class VcfVariant:
    chrom: str
    pos: int          # zero-based
    ids: list[str]
    ref: str
    alts: list[str]
    qual: str
    filter: str
    info: dict[str, str | bool]
    format: list[str]
    samples: list[dict[str, str]]
    lineno: int = 0

    def end_pos(self, end_field: str = "END") -> int:
        """Zero-based exclusive end (libbio vcf::variant_end_pos): the END
        info value when present (1-based inclusive == 0-based exclusive),
        otherwise pos + len(REF)."""
        v = self.info.get(end_field)
        if v is not None and v is not True:
            return int(v)
        return self.pos + len(self.ref)

    def genotype(self, sample_idx: int = 0) -> list[int | None]:
        """Parsed GT of one sample; None encodes '.'"""
        if "GT" not in self.format:
            raise ValueError("variant lacks GT")
        gt_idx = self.format.index("GT")
        raw = list(self.samples[sample_idx].values())[gt_idx]
        out: list[int | None] = []
        for part in raw.replace("|", "/").split("/"):
            out.append(None if part == "." else int(part))
        return out


class VcfReader:
    def __init__(self, path_or_fh):
        if isinstance(path_or_fh, str):
            if path_or_fh.endswith(".gz"):
                self._fh = gzip.open(path_or_fh, "rt")
            else:
                self._fh = open(path_or_fh, "rt")
            self._owns = True
        else:
            self._fh = path_or_fh
            self._owns = False
        self.header_lines: list[str] = []
        self.sample_names: list[str] = []
        self._lineno = 0
        self._read_header()

    def _read_header(self) -> None:
        for line in self._fh:
            self._lineno += 1
            line = line.rstrip("\n")
            if line.startswith("##"):
                self.header_lines.append(line)
            elif line.startswith("#CHROM"):
                cols = line.split("\t")
                self.sample_names = cols[9:]
                return
            else:
                raise ValueError(f"unexpected VCF line {self._lineno}: {line!r}")

    @staticmethod
    def _parse_info(text: str) -> dict[str, str | bool]:
        info: dict[str, str | bool] = {}
        if text == ".":
            return info
        for part in text.split(";"):
            if "=" in part:
                k, v = part.split("=", 1)
                info[k] = v
            elif part:
                info[part] = True
        return info

    @classmethod
    def parse_record_line(cls, line: str, lineno: int) -> VcfVariant:
        """Parse one record line (no trailing newline) into a VcfVariant."""
        f = line.split("\t")
        fmt = f[8].split(":") if len(f) > 8 else []
        samples = []
        for s in f[9:]:
            vals = s.split(":")
            samples.append({k: (vals[i] if i < len(vals) else ".") for i, k in enumerate(fmt)})
        return VcfVariant(
            chrom=f[0],
            pos=int(f[1]) - 1,
            ids=f[2].split(";") if f[2] != "." else ["."],
            ref=f[3],
            alts=f[4].split(",") if f[4] != "." else [],
            qual=f[5],
            filter=f[6],
            info=cls._parse_info(f[7]) if len(f) > 7 else {},
            format=fmt,
            samples=samples,
            lineno=lineno,
        )

    def __iter__(self):
        for line in self._fh:
            self._lineno += 1
            line = line.rstrip("\n")
            if not line or line.startswith("#"):
                continue
            yield self.parse_record_line(line, self._lineno)

    def close(self):
        if self._owns:
            self._fh.close()
