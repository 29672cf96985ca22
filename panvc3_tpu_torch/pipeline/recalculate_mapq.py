"""Recalculate MAPQ of projected alignments, Bowtie2-v2 style.

Copy of ``panvc3_tpu.pipeline.recalculate_mapq``.
The C host extension always exists in the port, so ``CigarScorer``
scores in C only and the chunk engine is gated by ``PANVC3_MAPQ_FAST``
alone; the worker pool's start method looks for a live CUDA context
(``mp_start_method``).

Reimplements ``panvc3_recalculate_mapq``
(recalculate-mapq/main.cc).  Input must be QNAME-grouped;
records are buffered per group (unmapped records skipped before grouping,
main.cc:1236-1241) and each group is scored:

- per-record alignment score from the AS tag, or recomputed from an =/X
  CIGAR + base qualities with Bowtie2-like quality-scaled penalties and the
  XN reference-N bitmask (--rescore-alignments, main.cc:183-321);
- segment descriptions keyed by *original* (pre-projection) position from
  the XR/XP tags; mate scores found via original RNEXT/PNEXT (YR/YP) with a
  binary search; paired records deduplicated per normalised projected
  position pair keeping the best total (main.cc:878-902);
- per record, the best *other* candidate whose projected position pair
  differs provides next_score for calculate_mapq(); records that are not
  best-scoring get MAPQ 255 (MAPQ_NO_NEXT_RECORD, main.cc:51,1167);
- groups containing both paired and unpaired records are skipped with a
  warning (main.cc:1028-1033).

calculate_mapq mirrors bowtie2_v2_score_calculator (main.cc:479-565):
min score = -0.6 - 0.6*len summed over mates, max = 0; note the reference
clamps next_score to min_score *before* the ALIGNMENT_SCORE_MIN comparison,
so its unique-alignment table branch is unreachable — we reproduce that
behaviour (and keep the table for reference).
"""

from __future__ import annotations

import bisect
import os
import sys
from dataclasses import dataclass

from ..io.sam import (
    SamHeader,
    SamReader,
    SamRecord,
    SamWriter,
    format_sam_record,
    parse_sam_record,
)
from ..native import get_native

ALIGNMENT_SCORE_MIN = -sys.float_info.max
MAPQ_NO_NEXT_RECORD = 255
INVALID_POSITION = (0xFFFFFFFF, 0xFFFFFFFF)

# (normalised_score_threshold, mapq) — kept for parity with the reference's
# unique_alignment_scores (main.cc:376-384); unreachable, see module docstring.
UNIQUE_ALIGNMENT_SCORES = (
    (0.0, 0), (0.3, 3), (0.4, 8), (0.5, 23), (0.6, 24), (0.7, 40), (0.8, 42),
)

# (diff_next_threshold, normalised_score_threshold, mapq) (main.cc:394-425)
NON_UNIQUE_ALIGNMENT_SCORES = (
    (0.0, 0.0, 2),
    (0.0, 0.67, 6),
    (0.1, 0.0, 0),
    (0.1, 0.67, 7),
    (0.1, 0.88, 12),
    (0.1, 1.0, 30),
    (0.2, 0.0, 0),
    (0.2, 0.67, 11),
    (0.2, 0.88, 17),
    (0.2, 1.0, 31),
    (0.3, 0.0, 3),
    (0.3, 0.67, 15),
    (0.3, 0.88, 18),
    (0.3, 1.0, 32),
    (0.4, 0.0, 4),
    (0.4, 0.68, 14),
    (0.4, 0.84, 21),
    (0.4, 1.0, 34),
    (0.5, 0.0, 5),
    (0.5, 0.68, 16),
    (0.5, 0.84, 25),
    (0.5, 1.0, 35),
    (0.6, 0.0, 22),
    (0.6, 1.0, 36),
    (0.7, 0.0, 26),
    (0.7, 1.0, 37),
    (0.8, 0.0, 27),
    (0.8, 1.0, 38),
    (0.9, 0.0, 33),
    (0.9, 1.0, 39),
)

_NU_FIRST = [e[0] for e in NON_UNIQUE_ALIGNMENT_SCORES]
_NU_PAIRS = [(e[0], e[1]) for e in NON_UNIQUE_ALIGNMENT_SCORES]


def calculate_read_min_score(read_length: int) -> float:
    """Bowtie2 v2 minimum valid score: -0.6 - 0.6*len (main.cc:455-461)."""
    if not read_length:
        return 0.0
    return -0.6 + (-0.6 * read_length)


def calculate_mapq(
    read_length: int,
    other_read_length: int,
    score: float,
    next_score_: float,
) -> int:
    min_score = calculate_read_min_score(read_length) + calculate_read_min_score(other_read_length)
    max_score = 0.0
    score_range = max(1.0, max_score - min_score)

    if score < min_score:
        return 0

    next_score = next_score_ if min_score < next_score_ else min_score

    normalised_score = score - min_score
    normalised_score_quotient = normalised_score / score_range
    diff_next = score - next_score
    diff_next_quotient = diff_next / score_range

    if next_score == ALIGNMENT_SCORE_MIN:
        # Unreachable after the clamp above; kept for structural parity.
        i = bisect.bisect_right([e[0] for e in UNIQUE_ALIGNMENT_SCORES], normalised_score_quotient)
        return UNIQUE_ALIGNMENT_SCORES[i - 1][1]
    if diff_next:
        i = bisect.bisect_right(_NU_FIRST, diff_next_quotient)
        threshold = NON_UNIQUE_ALIGNMENT_SCORES[i - 1][0]
        j = bisect.bisect_right(_NU_PAIRS, (threshold, normalised_score_quotient), hi=i)
        return NON_UNIQUE_ALIGNMENT_SCORES[j - 1][2]
    return 1 if normalised_score_quotient >= 0.67 else 0


# -- alignment scorers ------------------------------------------------------

@dataclass
class AlignmentScoring:
    min_mismatch_penalty: int = 2
    max_mismatch_penalty: int = 6
    n_penalty: int = 1
    gap_opening_penalty: int = 5
    gap_extension_penalty: int = 3


@dataclass
class MapqTagSpec:
    ref_n_positions: str = "XN"
    original_rname: str = "XR"
    original_pos: str = "XP"
    original_rnext: str = "YR"
    original_pnext: str = "YP"
    original_alignment_score: str = "XS"
    new_alignment_score: str = "YS"


class AsTagScorer:
    """Score = AS tag value (main.cc:169-180)."""

    def __call__(self, rec: SamRecord, tags: MapqTagSpec) -> float:
        t = rec.tags.get("AS")
        if t is None:
            return ALIGNMENT_SCORE_MIN
        return float(t[1])


class CigarScorer:
    """Recompute the score from an =/X CIGAR and base qualities
    (main.cc:183-321).  Penalty lookup: min(q,40)/40*(max-min)+min,
    truncated to int (fill_penalties, main.cc:184-188)."""

    def __init__(self, scoring: AlignmentScoring):
        self.scoring = scoring

    def calculate(self, rec: SamRecord, ref_n_positions: list[int]) -> int:
        """Exact integer semantics, in C (``score_cigar``; mirrors
        cigar_alignment_scorer::calculate_score)."""
        s = self.scoring
        return get_native().score_cigar(
            rec.cigar,
            rec.seq,
            None if rec.qual == "*" else rec.qual,
            bytes(ref_n_positions),
            s.min_mismatch_penalty,
            s.max_mismatch_penalty,
            s.n_penalty,
            s.gap_opening_penalty,
            s.gap_extension_penalty,
        )

    def __call__(self, rec: SamRecord, tags: MapqTagSpec) -> float:
        t = rec.tags.get(tags.ref_n_positions)
        ref_n = []
        if t is not None and t[0] == "B":
            ref_n = [x & 0xFF for x in t[1][1]]
        new_score = self.calculate(rec, ref_n)
        old = rec.tags.get("AS")
        if old is None:
            rec.tags["AS"] = ("i", int(new_score))
        else:
            rec.tags[tags.original_alignment_score] = old
            rec.tags[tags.new_alignment_score] = ("f", float(new_score))
            rec.tags["AS"] = ("i", int(new_score))
        return float(new_score)


# -- group algorithm --------------------------------------------------------

@dataclass
class MapqStatistics:
    total_alignments: int = 0
    unpaired_alignments: int = 0
    reads_with_and_without_mate: int = 0
    mate_not_found: int = 0
    reads_without_valid_position: int = 0


def _tag_position(rec: SamRecord, ref_tag: str, pos_tag: str):
    rt = rec.tags.get(ref_tag)
    pt = rec.tags.get(pos_tag)
    if rt is None or pt is None:
        return INVALID_POSITION
    r, p = int(rt[1]), int(pt[1])
    if r < 0 or p < 0:
        raise ValueError(f"tag value out of bounds ({ref_tag}/{pos_tag})")
    return (r, p)


def _projected_position(rec: SamRecord):
    if rec.ref_id < 0 or rec.pos < 0:
        return INVALID_POSITION
    return (rec.ref_id, rec.pos)


def _mate_position(rec: SamRecord):
    if rec.mate_ref_id < 0 or rec.mate_pos < 0:
        return INVALID_POSITION
    return (rec.mate_ref_id, rec.mate_pos)


class MapqScorer:
    def __init__(self, aln_scorer, tag_spec: MapqTagSpec):
        self.aln_scorer = aln_scorer
        self.tags = tag_spec
        self.statistics = MapqStatistics()

    def process_alignment_group(self, alignments: list[SamRecord], out, verbose=False):
        """Mirror of mapq_scorer::process_alignment_group (main.cc:960-1179)."""
        if not alignments:
            return
        st = self.statistics
        st.total_alignments += len(alignments)

        seen_types = 0
        scored: list[dict] = []
        segment_descriptions: list[tuple[tuple[int, int], float, int]] = []
        for i, rec in enumerate(alignments):
            has_mate = rec.mate_ref_id >= 0 and rec.mate_pos >= 0
            seen_types |= 1 << int(has_mate)
            if not has_mate:
                st.unpaired_alignments += 1
            score = self.aln_scorer(rec, self.tags)
            scored.append(
                dict(rec=rec, idx=i, score=score, pairwise=ALIGNMENT_SCORE_MIN, mate_length=0)
            )
            segment_descriptions.append(
                (_tag_position(rec, self.tags.original_rname, self.tags.original_pos),
                 score, len(rec.seq) if rec.seq != "*" else 0)
            )

        if seen_types == 0x3:
            st.reads_with_and_without_mate += 1
            print(
                f"WARNING: Read '{alignments[0].qname}' has both paired and "
                "unpaired alignment records; skipping.",
                file=sys.stderr,
            )
            return

        segment_descriptions.append((INVALID_POSITION, 0.0, 0))  # sentinel
        segment_descriptions.sort(key=lambda e: (e[0], e[1]))
        seg_positions = [e[0] for e in segment_descriptions]

        if all(p == INVALID_POSITION for p in seg_positions):
            st.reads_without_valid_position += 1
            print(
                f"WARNING: Read '{alignments[0].qname}' has no alignments "
                "with a valid position.",
                file=sys.stderr,
            )

        # paired segment scores by normalised projected position pair
        # (sequence "key": None for paired records — deduplicated; a unique
        # token for unpaired ones — never deduplicated, matching the
        # reference's pointer comparison at main.cc:890)
        pss_list: list[dict] = []

        def add_pss(pss):
            # insertion keeping (positions) sorted
            i = bisect.bisect_left([p["positions"] for p in pss_list], pss["positions"])
            while i < len(pss_list) and pss_list[i]["positions"] == pss["positions"]:
                if pss_list[i]["seq_key"] is pss["seq_key"]:
                    if pss_list[i]["total"] < pss["total"]:
                        pss_list[i] = pss
                    return
                i += 1
            pss_list.insert(i, pss)

        for sr in scored:
            rec = sr["rec"]
            ppos = _projected_position(rec)
            mpos = _mate_position(rec)
            pair = tuple(sorted((ppos, mpos)))
            has_mate = mpos != INVALID_POSITION
            pss = dict(
                positions=pair,
                seq_key=None if has_mate else sr["idx"],
                seq=rec.seq,
                score=sr["score"],
                other_score=0.0,
                has_mate=False,
            )
            mate_length = 0
            if ppos != INVALID_POSITION and has_mate:
                mate_orig = _tag_position(rec, self.tags.original_rnext, self.tags.original_pnext)
                j = bisect.bisect_right(seg_positions, mate_orig)
                if j == 0:
                    st.mate_not_found += 1
                    if verbose:
                        print(
                            f"WARNING: Mate not found for alignment '{rec.qname}'",
                            file=sys.stderr,
                        )
                else:
                    cand = segment_descriptions[j - 1]
                    if cand[0] == mate_orig:
                        pss["other_score"] = cand[1]
                        pss["has_mate"] = True
                        mate_length = cand[2]
                    else:
                        st.mate_not_found += 1
                        if verbose:
                            print(
                                f"WARNING: Mate not found for alignment '{rec.qname}'",
                                file=sys.stderr,
                            )
            pss["total"] = pss["score"] + pss["other_score"]
            pss["max"] = max(pss["score"], pss["other_score"]) if pss["has_mate"] else pss["score"]
            sr["pairwise"] = pss["total"]
            sr["mate_length"] = mate_length
            add_pss(pss)

        pss_sorted = sorted(pss_list, key=lambda p: p["total"])
        totals = [p["total"] for p in pss_sorted]

        for sr in scored:
            rec = sr["rec"]
            ppos = _projected_position(rec)
            mpos = _mate_position(rec)
            pair = tuple(sorted((ppos, mpos)))
            has_mate = mpos != INVALID_POSITION

            it = bisect.bisect_right(totals, sr["pairwise"])
            is_best = it == len(pss_sorted)
            # sequence-content comparison target: the first better-scoring
            # entry, or (reference UB case: it == end) this record's own
            # sequence
            it_seq = pss_sorted[it]["seq"] if it < len(pss_sorted) else rec.seq
            it_seq_key_paired = pss_sorted[it]["seq_key"] is None if it < len(pss_sorted) else (
                has_mate
            )

            mapq = None
            for other in reversed(pss_sorted[:it]):
                # sequences_eq<true>: null keys (paired) always compare
                # equal; content comparison otherwise (main.cc:568-581)
                if not (it_seq_key_paired or other["seq_key"] is None or it_seq == other["seq"]):
                    continue
                if other["positions"] == pair:
                    continue
                mapq = calculate_mapq(
                    len(rec.seq) if rec.seq != "*" else 0,
                    sr["mate_length"],
                    sr["pairwise"],
                    other["total"] if has_mate else other["max"],
                )
                break
            if mapq is None:
                if is_best:
                    mapq = calculate_mapq(
                        len(rec.seq) if rec.seq != "*" else 0,
                        sr["mate_length"],
                        sr["pairwise"],
                        ALIGNMENT_SCORE_MIN,
                    )
                else:
                    mapq = MAPQ_NO_NEXT_RECORD
            rec.mapq = mapq
            out.write(rec)


def run_recalculate_mapq(
    input_path_or_fh,
    output_path_or_fh,
    *,
    rescore: bool = False,
    scoring: AlignmentScoring | None = None,
    tag_spec: MapqTagSpec | None = None,
    output_bam: bool = False,
    verbose: bool = False,
    print_reference_names: bool = False,
    status_output_interval: int = 5,
    command_line: str = "panvc3_tpu_torch recalculate_mapq",
    version: str = "0.1",
    jobs: int = 1,
) -> MapqStatistics:
    reader = SamReader(input_path_or_fh)
    header = reader.header
    if print_reference_names:
        # --print-reference-names (recalculate-mapq/main.cc:1414-1420)
        print("Reference IDs:", file=sys.stderr)
        for idx, name in enumerate(header.ref_names):
            print(f"{idx}\t{name}", file=sys.stderr)
    out_header = SamHeader()
    out_header.lines = list(header.lines)
    out_header.ref_names = list(header.ref_names)
    out_header.ref_lengths = list(header.ref_lengths)
    out_header.append_program(
        "panvc3.recalculate-mapq", "PanVC 3 recalculate_mapq", command_line, version
    )
    writer = SamWriter(output_path_or_fh, out_header, bam=output_bam)

    tag_spec = tag_spec or MapqTagSpec()

    # Process-parallel group scoring: the input is QNAME-grouped, so chunks
    # cut at group boundaries are independent — workers run the exact
    # sequential algorithm per chunk and the parent concatenates outputs in
    # submission order (byte-identical to jobs=1).  BAM in/out rides the C
    # BAM<->SAM-text converters; verbose stays sequential (per-group stderr
    # would interleave).
    if jobs != 1 and not verbose:
        stats = _run_parallel_mapq(
            reader, writer, rescore, scoring, tag_spec, out_header, jobs,
            status_output_interval,
        )
        writer.close()
        return stats

    # Native chunk engine (mapq_score_groups): the whole group algorithm +
    # canonical emission in C, chunked at QNAME boundaries; falls back to
    # the object path per chunk on constructs it cannot reproduce
    # bit-identically (returns None).  Verbose stays on the object path
    # (per-record mate warnings need SamRecord context).
    if not verbose and os.environ.get("PANVC3_MAPQ_FAST") != "0":
        stats = _run_fast_mapq(
            reader, writer, rescore, scoring, tag_spec, out_header,
            status_output_interval,
        )
        writer.close()
        return stats

    if rescore:
        scorer = MapqScorer(CigarScorer(scoring or AlignmentScoring()), tag_spec)
    else:
        scorer = MapqScorer(AsTagScorer(), tag_spec)

    from ..utils import StatusReporter, log_time

    reporter = StatusReporter(status_output_interval)
    buffer: list[SamRecord] = []
    rec_idx = 0
    for rec in reader:
        rec_idx += 1
        if rec_idx % 10_000_000 == 0:
            log_time(f"Processed {rec_idx} alignments…")
        reporter.tick(rec_idx)
        if rec.flag & 0x4:  # unmapped
            continue
        if buffer and rec.qname != buffer[0].qname:
            scorer.process_alignment_group(buffer, writer, verbose)
            buffer = []
        buffer.append(rec)
    if buffer:
        scorer.process_alignment_group(buffer, writer, verbose)
    writer.close()
    return scorer.statistics


# ---- process-parallel group scoring ---------------------------------------

_MP_STATE: dict = {}


def _mp_init(header_lines, ref_names, ref_lengths, rescore, scoring, tag_spec):
    h = SamHeader()
    h.lines = list(header_lines)
    h.ref_names = list(ref_names)
    h.ref_lengths = list(ref_lengths)
    if rescore:
        aln_scorer = CigarScorer(scoring or AlignmentScoring())
    else:
        aln_scorer = AsTagScorer()
    _MP_STATE["header"] = h
    _MP_STATE["aln_scorer"] = aln_scorer
    _MP_STATE["tags"] = tag_spec
    _MP_STATE["refmap"] = {n.encode(): i for i, n in enumerate(ref_names)}
    _MP_STATE["rescore"] = rescore
    _MP_STATE["scoring"] = scoring


class _BlobWriter:
    """Duck-typed SamWriter collecting formatted lines into a blob."""

    __slots__ = ("parts", "header")

    def __init__(self, header):
        self.parts: list[bytes] = []
        self.header = header

    def write(self, rec) -> None:
        self.parts.append(
            (format_sam_record(rec, self.header) + "\n").encode()
        )


def _mapq_tag_names(tag_spec: MapqTagSpec) -> tuple:
    return tuple(
        t.encode()
        for t in (
            tag_spec.ref_n_positions, tag_spec.original_rname,
            tag_spec.original_pos, tag_spec.original_rnext,
            tag_spec.original_pnext, tag_spec.original_alignment_score,
            tag_spec.new_alignment_score,
        )
    )


def _native_mapq_chunk(nat, lines, header, refmap, rescore, scoring,
                       tag_names):
    """One chunk through the C group engine.  Returns (blob, warnings,
    stats tuple) or None when the C path bailed (unsupported construct)."""
    s = scoring or AlignmentScoring()
    res = nat.mapq_score_groups(
        lines, refmap, header.ref_names, 1 if rescore else 0, tag_names,
        s.min_mismatch_penalty, s.max_mismatch_penalty, s.n_penalty,
        s.gap_opening_penalty, s.gap_extension_penalty,
    )
    if res is None:
        return None
    blob, st, warnings = res
    return blob, warnings, st


def _fold_mapq_stats(stats: MapqStatistics, st: tuple) -> None:
    (stats.total_alignments, stats.unpaired_alignments,
     stats.reads_with_and_without_mate, stats.mate_not_found,
     stats.reads_without_valid_position) = (
        stats.total_alignments + st[0],
        stats.unpaired_alignments + st[1],
        stats.reads_with_and_without_mate + st[2],
        stats.mate_not_found + st[3],
        stats.reads_without_valid_position + st[4],
    )


def _run_fast_mapq(
    reader, writer, rescore, scoring, tag_spec, out_header,
    status_output_interval,
) -> MapqStatistics:
    from ..utils import StatusReporter, log_time

    nat = get_native()
    header = out_header
    stats = MapqStatistics()
    refmap = {n.encode(): i for i, n in enumerate(header.ref_names)}
    tag_names = _mapq_tag_names(tag_spec)
    reporter = StatusReporter(status_output_interval)
    CHUNK = 16384
    fallback_scorer = None
    rec_idx = 0

    def flush(chunk_lines):
        nonlocal fallback_scorer
        res = _native_mapq_chunk(
            nat, chunk_lines, header, refmap, rescore, scoring, tag_names
        )
        if res is not None:
            blob, warnings, st = res
            for w in warnings:
                print(w, file=sys.stderr)
            _fold_mapq_stats(stats, st)
            writer.write_raw(blob)
            return
        # object-path fallback for this chunk (identical algorithm/output)
        if fallback_scorer is None:
            aln = (
                CigarScorer(scoring or AlignmentScoring())
                if rescore
                else AsTagScorer()
            )
            fallback_scorer = MapqScorer(aln, tag_spec)
        buffer: list[SamRecord] = []
        for ln in chunk_lines:
            text = ln.decode().rstrip("\r\n")
            if not text.strip():
                continue
            rec = parse_sam_record(text, header)
            if rec.flag & 0x4:
                continue
            if buffer and rec.qname != buffer[0].qname:
                fallback_scorer.process_alignment_group(buffer, writer, False)
                buffer = []
            buffer.append(rec)
        if buffer:
            fallback_scorer.process_alignment_group(buffer, writer, False)

    pending: list[bytes] = []
    for block in reader.raw_record_line_blocks():
        pending.extend(block)
        while len(pending) > CHUNK:
            i = CHUNK
            last_q = pending[i - 1].split(b"\t", 1)[0]
            n = len(pending)
            while i < n and pending[i].split(b"\t", 1)[0] == last_q:
                i += 1
            if i >= n:
                break  # group spans the buffer end; read more first
            flush(pending[:i])
            prev = rec_idx
            rec_idx += i
            if prev // 10_000_000 != rec_idx // 10_000_000:
                log_time(f"Processed {rec_idx} alignments…")
            reporter.tick(rec_idx)
            del pending[:i]
    if pending:
        flush(pending)
        reporter.tick(rec_idx + len(pending))
    if fallback_scorer is not None:
        for f in MapqStatistics.__dataclass_fields__:
            setattr(
                stats, f,
                getattr(stats, f) + getattr(fallback_scorer.statistics, f),
            )
    return stats


def _mp_process_chunk(task):
    """Run the group algorithm over one chunk of raw SAM text (guaranteed
    to contain whole QNAME groups): the C chunk engine unless
    ``PANVC3_MAPQ_FAST=0``, the object-path loop otherwise."""
    data, n_lines = task
    h = _MP_STATE["header"]
    if os.environ.get("PANVC3_MAPQ_FAST") != "0":
        res = _native_mapq_chunk(
            get_native(), data.splitlines(), h, _MP_STATE["refmap"],
            _MP_STATE["rescore"], _MP_STATE["scoring"],
            _mapq_tag_names(_MP_STATE["tags"]),
        )
        if res is not None:
            blob, warnings, st = res
            for w in warnings:
                print(w, file=sys.stderr)
            stats = MapqStatistics()
            _fold_mapq_stats(stats, st)
            return blob, stats, n_lines
    scorer = MapqScorer(_MP_STATE["aln_scorer"], _MP_STATE["tags"])
    out = _BlobWriter(h)
    buffer: list[SamRecord] = []
    for text in data.decode().splitlines():
        if not text.strip():
            continue
        rec = parse_sam_record(text, h)
        if rec.flag & 0x4:  # unmapped
            continue
        if buffer and rec.qname != buffer[0].qname:
            scorer.process_alignment_group(buffer, out, False)
            buffer = []
        buffer.append(rec)
    if buffer:
        scorer.process_alignment_group(buffer, out, False)
    return b"".join(out.parts), scorer.statistics, n_lines


def mp_start_method() -> str:
    """Start method of the worker pool.  fork is cheap and safe while this
    process holds no CUDA context (recalculate_mapq itself launches nothing
    on the card); a forked child of a process with a live context, fetch
    threads and pinned buffers can hang, so such a process spawns."""
    if sys.platform not in ("linux", "linux2"):
        return "spawn"
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        return "spawn"
    return "fork"


def _run_parallel_mapq(
    reader, writer, rescore, scoring, tag_spec, out_header, jobs,
    status_output_interval,
) -> MapqStatistics:
    import multiprocessing as mp
    import os

    from ..utils import StatusReporter, log_time

    if jobs <= 0:
        jobs = min(4, os.cpu_count() or 1)

    CHUNK = 16384  # lines per task; cut only at QNAME boundaries

    def chunks():
        """Yield chunks as single byte blobs (cheap to pickle); QNAME
        comparisons only near each cut point."""
        pending: list[bytes] = []
        for block in reader.raw_record_line_blocks():
            pending.extend(block)
            while len(pending) > CHUNK:
                i = CHUNK
                last_q = pending[i - 1].split(b"\t", 1)[0]
                n = len(pending)
                while i < n and pending[i].split(b"\t", 1)[0] == last_q:
                    i += 1
                if i >= n:
                    break  # group spans the buffer end; read more first
                yield b"".join(pending[:i]), i
                del pending[:i]
        if pending:
            yield b"".join(pending), len(pending)

    stats = MapqStatistics()
    reporter = StatusReporter(status_output_interval)
    rec_idx = 0
    ctx = mp.get_context(mp_start_method())
    with ctx.Pool(
        jobs,
        initializer=_mp_init,
        initargs=(
            out_header.lines, out_header.ref_names, out_header.ref_lengths,
            rescore, scoring, tag_spec,
        ),
    ) as pool:
        for blob, st, n_lines in pool.imap(_mp_process_chunk, chunks()):
            writer.write_raw(blob)
            for f in MapqStatistics.__dataclass_fields__:
                setattr(stats, f, getattr(stats, f) + getattr(st, f))
            prev = rec_idx
            rec_idx += n_lines
            if prev // 10_000_000 != rec_idx // 10_000_000:
                log_time(f"Processed {rec_idx} alignments…")
            reporter.tick(rec_idx)
    return stats
