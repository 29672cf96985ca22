"""The ``alignment_statistics`` tool.

Copy of ``panvc3_tpu.pipeline.alignment_statistics``.
The C host extension always exists in the port, so the chunk engine is
gated by ``PANVC3_ALS_FAST`` alone.

Reimplements alignment-statistics/main.cc: four modes over a
filtered stream (flags, RNAME/prefix, mate-same-ref):

- coverage: per-position coverage via a two-set interval sweep
  (calculate_coverage, main.cc:252-332);
- count-alignments: per-contig record counts;
- mapq-histogram;
- mapq-box-plot: binned quantiles via the extended-P² estimator (the
  reference uses boost::accumulators extended_p_square_quantile; we
  implement the same Jain–Chlamtac extended P² marker algorithm).
"""

from __future__ import annotations

import heapq
import os
import sys
from dataclasses import dataclass

from ..io.sam import SamReader
from ..native import get_native


@dataclass
class AlignmentStatistics:
    flags_not_matched: int = 0
    ref_id_mismatches: int = 0
    mate_ref_id_mismatches: int = 0


def calculate_record_length(cigar, include_soft_clipping: bool) -> int:
    n = 0
    for count, op in cigar:
        if op in "M=XDN":
            n += count
        elif op in "IS" and include_soft_clipping:
            n += count
    return n


def iter_filtered(
    reader: SamReader,
    stats: AlignmentStatistics,
    *,
    rnames: tuple[str, ...] = (),
    rname_prefix: bool = False,
    primary_only: bool = False,
    same_ref: bool = False,
):
    """Stream records through the shared filter (main.cc:142-249)."""
    ref_names = reader.header.ref_names
    filtered_ids: set[int] = set()
    eq_class = [None] * len(ref_names)
    for i, rn in enumerate(rnames):
        for ref_id, name in enumerate(ref_names):
            if name == rn or (rname_prefix and name.startswith(rn)):
                filtered_ids.add(ref_id)
                eq_class[ref_id] = i

    for rec in reader:
        if rec.flag & (0x4 | 0x200 | 0x400 | 0x800):
            stats.flags_not_matched += 1
            continue
        if primary_only and rec.flag & 0x100:
            stats.flags_not_matched += 1
            continue
        if filtered_ids:
            if rec.ref_id < 0 or rec.ref_id not in filtered_ids:
                stats.ref_id_mismatches += 1
                continue
            if same_ref:
                if rec.mate_ref_id < 0:
                    stats.mate_ref_id_mismatches += 1
                    continue
                if eq_class[rec.ref_id] != eq_class[rec.mate_ref_id]:
                    stats.mate_ref_id_mismatches += 1
                    continue
        if rec.pos < 0:
            stats.flags_not_matched += 1
            continue
        yield rec


def _run_native(
    reader: SamReader,
    mode: int,
    out,
    *,
    include_clipping: bool = False,
    bin_width: int = 100000,
    rnames: tuple[str, ...] = (),
    rname_prefix: bool = False,
    primary_only: bool = False,
    same_ref: bool = False,
) -> tuple[AlignmentStatistics, list[int] | None] | None:
    """Native chunk engine (native/als.c): streams raw lines through the
    shared filter + mode state, byte-identical to the Python loops.
    Returns None under ``PANVC3_ALS_FAST=0``."""
    if os.environ.get("PANVC3_ALS_FAST") == "0":
        return None
    nat = get_native()
    ref_names = reader.header.ref_names
    eq_class = [-1] * len(ref_names)
    for i, rn in enumerate(rnames):
        for ref_id, name in enumerate(ref_names):
            if name == rn or (rname_prefix and name.startswith(rn)):
                eq_class[ref_id] = i
    # like iter_filtered: a filter that matches nothing disables filtering
    has_filter = any(e >= 0 for e in eq_class)
    refmap = {n.encode(): i for i, n in enumerate(ref_names)}
    state = nat.als_new(
        mode, refmap, eq_class, int(has_filter), int(primary_only),
        int(same_ref), int(include_clipping), bin_width,
    )
    for block in reader.raw_record_line_blocks():
        blob = nat.als_chunk(state, block)
        if blob:
            out.write(blob.decode("latin1"))
    blob, aux, flags_nm, ref_mm, mate_mm = nat.als_finish(state)
    if blob:
        out.write(blob.decode("latin1"))
    return (
        AlignmentStatistics(
            flags_not_matched=flags_nm,
            ref_id_mismatches=ref_mm,
            mate_ref_id_mismatches=mate_mm,
        ),
        aux,
    )


def calculate_coverage(reader, out=sys.stdout, *, include_clipping=False, **filters):
    """Per-position coverage of a position-sorted stream."""
    stats = AlignmentStatistics()
    print("POSITION\tCOVERAGE", file=out)
    res = _run_native(reader, 0, out, include_clipping=include_clipping, **filters)
    if res is not None:
        return res[0]
    prev_pos = 0
    # heap of interval end positions currently open ("left" set); "right"
    # holds intervals starting at the current position
    left: list[int] = []
    right: list[int] = []

    for rec in iter_filtered(reader, stats, **filters):
        pos = rec.pos
        if prev_pos > pos:
            raise ValueError("alignments must be sorted by position")
        ref_len = calculate_record_length(rec.cigar, include_clipping)
        rec_end = pos + ref_len

        if prev_pos < pos:
            for e in right:
                heapq.heappush(left, e)
            right = []
            while left and prev_pos < pos:
                while left and left[0] <= prev_pos:
                    heapq.heappop(left)
                print(f"{prev_pos}\t{len(left)}", file=out)
                prev_pos += 1
        if ref_len:
            right.append(rec_end)
        prev_pos = pos

    for e in right:
        heapq.heappush(left, e)
    while left:
        while left and left[0] <= prev_pos:
            heapq.heappop(left)
        print(f"{prev_pos}\t{len(left)}", file=out)
        prev_pos += 1
    return stats


def count_alignments(reader, out=sys.stdout, **filters):
    stats = AlignmentStatistics()
    print("CONTIG\tCOUNT", file=out)
    names = reader.header.ref_names
    res = _run_native(reader, 1, out, **filters)
    if res is not None:
        for name, count in zip(names, res[1]):
            print(f"{name}\t{count}", file=out)
        return res[0]
    counts = [0] * len(names)
    for rec in iter_filtered(reader, stats, **filters):
        if rec.ref_id >= 0:
            counts[rec.ref_id] += 1
    for name, count in zip(names, counts):
        print(f"{name}\t{count}", file=out)
    return stats


def mapq_histogram(reader, out=sys.stdout, **filters):
    stats = AlignmentStatistics()
    print("VALUE\tCOUNT", file=out)
    res = _run_native(reader, 2, out, **filters)
    if res is not None:
        for val, count in enumerate(res[1]):
            if count:
                print(f"{val}\t{count}", file=out)
        return res[0]
    hist = [0] * 256
    for rec in iter_filtered(reader, stats, **filters):
        hist[rec.mapq] += 1
    for val, count in enumerate(hist):
        if count:
            print(f"{val}\t{count}", file=out)
    return stats


class ExtendedP2:
    """Extended P² quantile estimator (Jain & Chlamtac 1985, extended as in
    boost::accumulators::extended_p_square): simultaneous estimation of
    several quantiles with 2*k+3 markers."""

    def __init__(self, probabilities):
        self.probs = list(probabilities)
        k = len(self.probs)
        # marker desired probabilities: 0, p_i/2, p_i, (1+p_i)/2, 1
        ps = [0.0]
        for p in self.probs:
            ps.append(p / 2.0)
        for p in self.probs:
            ps.append(p)
        for p in self.probs:
            ps.append((1.0 + p) / 2.0)
        ps.append(1.0)
        self.m_probs = sorted(ps)
        self.m = len(self.m_probs)  # 2k+3 for distinct probabilities
        self.heights: list[float] = []
        self.actual: list[float] = []
        self.desired: list[float] = []
        self.count = 0

    def add(self, x: float) -> None:
        self.count += 1
        if self.count <= self.m:
            self.heights.append(x)
            if self.count == self.m:
                self.heights.sort()
                self.actual = [float(i + 1) for i in range(self.m)]
                self.desired = [1.0 + (self.m - 1) * p for p in self.m_probs]
            return

        # find cell
        if x < self.heights[0]:
            self.heights[0] = x
            k = 0
        elif x >= self.heights[-1]:
            self.heights[-1] = x
            k = self.m - 2
        else:
            k = 0
            for i in range(self.m - 1):
                if self.heights[i] <= x < self.heights[i + 1]:
                    k = i
                    break
        for i in range(k + 1, self.m):
            self.actual[i] += 1.0
        for i in range(self.m):
            self.desired[i] += self.m_probs[i]

        # adjust interior markers
        for i in range(1, self.m - 1):
            d = self.desired[i] - self.actual[i]
            if (d >= 1.0 and self.actual[i + 1] - self.actual[i] > 1.0) or (
                d <= -1.0 and self.actual[i - 1] - self.actual[i] < -1.0
            ):
                s = 1.0 if d >= 0 else -1.0
                h, hp, hm = self.heights[i], self.heights[i + 1], self.heights[i - 1]
                n, np_, nm = self.actual[i], self.actual[i + 1], self.actual[i - 1]
                new_h = h + s / (np_ - nm) * (
                    (n - nm + s) * (hp - h) / (np_ - n)
                    + (np_ - n - s) * (h - hm) / (n - nm)
                )
                if hm < new_h < hp:
                    self.heights[i] = new_h
                else:  # linear interpolation
                    if s > 0:
                        self.heights[i] = h + (hp - h) / (np_ - n)
                    else:
                        self.heights[i] = h - (hm - h) / (nm - n)
                self.actual[i] += s

    def quantile(self, p: float) -> float:
        if self.count == 0:
            return float("nan")
        if self.count < self.m:
            hs = sorted(self.heights)
            idx = min(len(hs) - 1, max(0, int(p * len(hs))))
            return hs[idx]
        # nearest marker with this desired probability
        best = min(range(self.m), key=lambda i: abs(self.m_probs[i] - p))
        return self.heights[best]

    @property
    def minimum(self):
        if self.count == 0:
            return float("nan")
        return min(self.heights) if self.count < self.m else self.heights[0]

    @property
    def maximum(self):
        if self.count == 0:
            return float("nan")
        return max(self.heights) if self.count < self.m else self.heights[-1]


def _fmt(x: float) -> str:
    """C++ ostream default double formatting (6 significant digits)."""
    if x != x:
        return "nan"
    s = f"{x:.6g}"
    return s


def mapq_box_plot(reader, out=sys.stdout, *, bin_width=100000, **filters):
    if bin_width <= 0:
        raise ValueError("bin width must be positive")
    stats = AlignmentStatistics()
    print("BIN\tMIN\tq10\tq25\tMED\tq75\tq90\tMAX\tCOUNT", file=out)
    res = _run_native(reader, 3, out, bin_width=bin_width, **filters)
    if res is not None:
        return res[0]
    probs = [0.1, 0.25, 0.50, 0.75, 0.9]
    current_bin = 0
    acc = ExtendedP2(probs)

    def print_acc():
        print(
            f"{current_bin}\t{_fmt(acc.minimum)}\t{_fmt(acc.quantile(0.1))}\t"
            f"{_fmt(acc.quantile(0.25))}\t{_fmt(acc.quantile(0.5))}\t"
            f"{_fmt(acc.quantile(0.75))}\t{_fmt(acc.quantile(0.9))}\t"
            f"{_fmt(acc.maximum)}\t{acc.count}",
            file=out,
        )

    for rec in iter_filtered(reader, stats, **filters):
        b = rec.pos // bin_width
        if b != current_bin:
            print_acc()
            current_bin = b
            acc = ExtendedP2(probs)
        if rec.mapq < 255:
            acc.add(float(rec.mapq))

    print_acc()
    return stats
