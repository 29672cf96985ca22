"""Full alignment projection: rewrite + indel-run realignment (the host
oracle; copy of ``panvc3_tpu.projector``).

1. rewrite the CIGAR from source (founder) to destination (standard
   reference) coordinates;
2. find maximal I+D runs in the rewritten CIGAR and realign each run's
   reference/query slices with affine-gap global alignment (optionally
   quality-aware, reference qualities pinned to max);
3. splice the realigned ops back and collapse adjacent operations.

Returns the projected destination position plus the realigned ranges
(recorded for the XB/YB output tags of project_alignments).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from .align import align_global, max_quality_array
from .alphabet import normalise_dna5
from .cigar import Cigar, collapse_cigar
from .indel_runs import find_indel_runs
from .msa_index import SequenceEntry
from .rewrite import rewrite_cigar


@dataclass
class ProjectionResult:
    dst_pos: int
    cigar: Cigar
    realigned_reference_ranges: list[tuple[int, int]] = field(default_factory=list)
    realigned_query_ranges: list[tuple[int, int]] = field(default_factory=list)
    num_realignments: int = 0
    # total ns spent in the realignment DP and total max(ref, query) run
    # length, summed over this record's runs
    realignment_time_ns: int = 0
    realigned_total_length: int = 0


def project_alignment(
    src_pos: int,
    src_entry: SequenceEntry,
    dst_entry: SequenceEntry,
    ref_seq: str | bytes,
    query_seq: str | bytes,
    cigar: Cigar,
    base_qualities: np.ndarray | None,
    gap_opening_cost: int,
    gap_extension_cost: int,
) -> ProjectionResult:
    """Project one alignment from src to dst coordinates.

    ``ref_seq`` is the gapless destination reference sequence (raw bytes as
    read from the FASTA), ``query_seq`` the read (will be dna5-normalised for
    comparisons, matching seqan3 record parsing), ``base_qualities`` phred
    values or None to disable quality-aware realignment.
    """
    if isinstance(ref_seq, str):
        ref_seq = ref_seq.encode("latin1")
    query_dna5 = normalise_dna5(query_seq)

    dst_pos, rewritten = rewrite_cigar(
        src_pos, cigar, src_entry, dst_entry, query_dna5, ref_seq
    )

    result = ProjectionResult(dst_pos=dst_pos, cigar=[])
    out: Cigar = []
    copy_from = 0
    for run in find_indel_runs(rewritten, dst_pos):
        out.extend(rewritten[copy_from:run.cigar_start])
        copy_from = run.cigar_end

        result.realigned_reference_ranges.append((run.checker_ref_pos, run.ref_length))
        result.realigned_query_ranges.append((run.query_start, run.query_length))
        result.num_realignments += 1
        result.realigned_total_length += max(run.ref_length, run.query_length)

        ref_part = ref_seq[run.ref_start:run.ref_start + run.ref_length]
        # the ref slice goes through the sequence alphabet (dna5) before
        # aligning
        ref_part = normalise_dna5(ref_part)
        query_part = query_dna5[run.query_start:run.query_start + run.query_length]

        t0 = time.perf_counter_ns()
        if base_qualities is None:
            _, realigned = align_global(
                ref_part, query_part, gap_opening_cost, gap_extension_cost
            )
        else:
            _, realigned = align_global(
                ref_part,
                query_part,
                gap_opening_cost,
                gap_extension_cost,
                quals1=max_quality_array(len(ref_part)),
                quals2=np.asarray(base_qualities)[
                    run.query_start:run.query_start + run.query_length
                ],
            )
        result.realignment_time_ns += time.perf_counter_ns() - t0
        out.extend(realigned)

    out.extend(rewritten[copy_from:])
    result.cigar = collapse_cigar(out)
    return result
