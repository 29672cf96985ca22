"""Minimal BED reading (chrom, start, end — 0-based half-open).

Copy of ``panvc3_tpu.io.bed``.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class BedRecord:
    chrom: str
    start: int
    end: int
    rest: tuple = ()


def read_bed(path_or_fh):
    """Yield BedRecords from a BED file."""
    if isinstance(path_or_fh, str):
        fh = open(path_or_fh)
        owns = True
    else:
        fh = path_or_fh
        owns = False
    try:
        for lineno, line in enumerate(fh, 1):
            line = line.rstrip("\n")
            if not line or line.startswith(("#", "track", "browser")):
                continue
            f = line.split("\t")
            if len(f) < 3:
                raise ValueError(f"BED parse error on line {lineno}")
            yield BedRecord(f[0], int(f[1]), int(f[2]), tuple(f[3:]))
    finally:
        if owns:
            fh.close()


class RegionSet:
    """Per-chromosome interval sets for variant filtering (the role of
    libbio's region_variant_validator regions)."""

    def __init__(self):
        self._by_chrom: dict[str, list[tuple[int, int]]] = {}

    def add(self, chrom: str, start: int, end: int) -> None:
        self._by_chrom.setdefault(chrom, []).append((start, end))

    def load_bed(self, path_or_fh) -> None:
        for rec in read_bed(path_or_fh):
            self.add(rec.chrom, rec.start, rec.end)
        for iv in self._by_chrom.values():
            iv.sort()

    def has_chrom(self, chrom: str) -> bool:
        return chrom in self._by_chrom

    def contains(self, chrom: str, pos: int) -> bool:
        import bisect

        ivs = self._by_chrom.get(chrom)
        if not ivs:
            return False
        i = bisect.bisect_right(ivs, (pos, float("inf")))
        return i > 0 and ivs[i - 1][0] <= pos < ivs[i - 1][1]
