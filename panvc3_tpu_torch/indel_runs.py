"""Detection of indel runs that need realignment (copy of
``panvc3_tpu.indel_runs``): scan a rewritten CIGAR for maximal runs of I/D
operations containing *both* insertions and deletions; those ranges
(reference range, query range, CIGAR op range) are the candidates for
local realignment.  Runs are broken by M/=/X/S/N/H/P.
"""

from __future__ import annotations

from dataclasses import dataclass

from .cigar import Cigar

_HAS_I = 0x1
_HAS_D = 0x2
_HAS_BOTH = _HAS_I | _HAS_D


@dataclass(frozen=True)
class IndelRun:
    ref_start: int    # run start in destination-reference coordinates
    ref_length: int
    query_start: int  # run start in query coordinates
    query_length: int
    cigar_start: int  # [cigar_start, cigar_end) op-index range to replace
    cigar_end: int
    # The checker's m_ref_pos / m_query_pos at report time, i.e. *after* the
    # run-breaking operation advanced them (or the CIGAR end for a final
    # run).  The projector records these as the first element of the
    # realigned reference ranges.
    checker_ref_pos: int
    checker_query_pos: int


def find_indel_runs(cigar: Cigar, ref_pos: int) -> list[IndelRun]:
    """Return all I+D runs of ``cigar``; ``ref_pos`` is the alignment's
    destination start position."""
    runs: list[IndelRun] = []
    query_pos = 0
    run_type = 0
    ref_range_loc = ref_pos
    query_range_loc = 0
    cigar_first = 0

    def report(i: int, ref_before: int, query_before: int) -> None:
        runs.append(
            IndelRun(
                ref_start=ref_range_loc,
                ref_length=ref_before - ref_range_loc,
                query_start=query_range_loc,
                query_length=query_before - query_range_loc,
                cigar_start=cigar_first,
                cigar_end=i,
                checker_ref_pos=ref_pos,
                checker_query_pos=query_pos,
            )
        )

    i = 0
    n = len(cigar)
    while i < n:
        ref_before = ref_pos
        query_before = query_pos
        prev_type = run_type

        if run_type == 0:
            ref_range_loc = ref_pos
            query_range_loc = query_pos
            cigar_first = i

        count, op = cigar[i]
        if op in ("H", "P"):
            run_type = 0
            if prev_type == _HAS_BOTH:
                report(i, ref_before, query_before)
        elif op == "I":
            query_pos += count
            run_type |= _HAS_I
        elif op == "D":
            ref_pos += count
            run_type |= _HAS_D
        elif op == "S":
            query_pos += count
            run_type = 0
            if prev_type == _HAS_BOTH:
                report(i, ref_before, query_before)
        elif op == "N":
            ref_pos += count
            run_type = 0
            if prev_type == _HAS_BOTH:
                report(i, ref_before, query_before)
        elif op in ("M", "=", "X"):
            ref_pos += count
            query_pos += count
            run_type = 0
            if prev_type == _HAS_BOTH:
                report(i, ref_before, query_before)
        else:
            raise ValueError(f"unexpected CIGAR operation {op!r}")
        i += 1

    if run_type == _HAS_BOTH:
        report(n, ref_pos, query_pos)
    return runs
