"""Count reads supporting reference/alternative alleles at variant sites.

Copy of ``panvc3_tpu.pipeline.count_supporting_reads``.
The C host extension always exists in the port, so the sweep and the
VCF parse are gated by ``PANVC3_CSR_FAST`` and ``PANVC3_CSR_VCF_FAST``
alone.

Reimplements ``panvc3_count_supporting_reads``
(count-supporting-reads/main.cc): a joint coordinate-sorted
sweep over a VCF and alignments.  For each diploid variant passing the
zygosity/chromosome/region filters, the candidate set of alignments fully
containing the variant's REF span is maintained (update_candidate_records,
main.cc:576-678); for each candidate the read's allele at the site is
extracted by walking the CIGAR (try_read_aligned_sequence, main.cc:204-435)
into the dna11 alphabet: insertions folded in, deletions -> '~', optional
lower-case soft clips, and trailing same-type operation continuation.
Output is a TSV stream of V (variant), R (allele,count) and S/T
(statistics) records (main.cc:889-981).
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass

from ..alphabet import normalise_dna5
from ..cigar import Cigar
from ..io.bed import RegionSet
from ..io.sam import SamReader, SamRecord
from ..io.vcf import VcfReader
from ..native import get_native

# dna11 ordering: rank order of the alphabet (dna11_alphabet.hh:15-108)
_DNA11_RANK = {c: i for i, c in enumerate("ACGNTacgnt~")}


def _dna11_key(seq: str):
    return tuple(_DNA11_RANK[c] for c in seq)


def calculate_record_lengths(cigar: Cigar) -> tuple[int, int]:
    """(reference_length, right_anchored_length) (main.cc:106-150):
    right-anchored length is the reference length up to the last M/=/X."""
    reference_length = 0
    right_anchored = 0
    for count, op in cigar:
        if op in "M=X":
            reference_length += count
            right_anchored = reference_length
        elif op in "DN":
            reference_length += count
    return reference_length, right_anchored


def _can_continue(prev: str, op: str) -> bool:
    if prev in "DN":
        return op in "DN"
    if prev in "HP":
        return op in "HP"
    return prev == op


def try_read_aligned_sequence(
    rec_pos: int,
    seq: str,            # dna5-normalised query
    cigar: Cigar,
    rec_ref_len: int,
    var_pos: int,
    var_ref_len: int,
    var_alt_len: int,
    should_include_clipping: bool,
) -> str | None:
    """Extract the read's allele at the variant site, or None on failure."""
    out: list[str] = []
    i = 0
    n = len(cigar)
    seg_pos = 0
    pos = rec_pos
    assert pos <= var_pos
    assert var_pos + var_ref_len <= rec_pos + rec_ref_len

    op_count = 0
    op = ""
    while i < n:
        op_count, op = cigar[i]
        if pos < var_pos:
            if op in "M=X":
                step = min(var_pos - pos, op_count)
                op_count -= step
                pos += step
                seg_pos += step
                if not op_count:
                    i += 1
                    continue
            elif op in "DN":
                step = min(var_pos - pos, op_count)
                op_count -= step
                pos += step
                if not op_count:
                    i += 1
                    continue
            elif op in "IS":
                seg_pos += op_count
                i += 1
                continue
            else:
                i += 1
                continue

        # read the aligned sequence
        if op in "M=X":
            step = min(op_count, var_ref_len)
            out.append(seq[seg_pos:seg_pos + step])
            seg_pos += step
            var_ref_len -= min(var_ref_len, step)
            var_alt_len -= min(var_alt_len, step)
            op_count -= step
            if op_count and var_ref_len == 0:
                # aligned nucleotides remain: the read has no insertion here
                var_alt_len = 0
        elif op == "I":
            out.append(seq[seg_pos:seg_pos + op_count])
            seg_pos += op_count
            var_alt_len -= min(var_alt_len, op_count)
            op_count = 0
        elif op in "DN":
            if var_ref_len < op_count and (not out or not out[-1].endswith("~")):
                out.append("~")
            var_ref_len -= min(var_ref_len, op_count)
            op_count = 0
        elif op == "S":
            if should_include_clipping:
                out.append(seq[seg_pos:seg_pos + op_count].lower())
            seg_pos += op_count
            var_alt_len -= min(var_alt_len, op_count)
            op_count = 0
        elif op in "HP":
            op_count = 0
        else:
            raise ValueError(f"unexpected CIGAR operation {op!r}")

        if var_ref_len == 0 and var_alt_len == 0:
            break
        i += 1
    else:
        return None

    # trailing same-type operation continuation (main.cc:355-418)
    if op_count == 0 and i < n:
        prev_op = op
        i += 1
        while i < n:
            op_count, op2 = cigar[i]
            if op2 == "S":
                if should_include_clipping:
                    out.append(seq[seg_pos:seg_pos + op_count].lower())
                seg_pos += op_count
                i += 1
                continue
            if not _can_continue(prev_op, op2):
                break
            if op2 == "I":
                out.append(seq[seg_pos:seg_pos + op_count])
                seg_pos += op_count
            elif op2 in "DN":
                if not out or not out[-1].endswith("~"):
                    out.append("~")
            elif op2 in "HP":
                pass
            else:
                raise ValueError(f"unexpected CIGAR operation {op2!r}")
            i += 1

    return "".join(out)


@dataclass
class VariantStatistics:
    variants_processed: int = 0
    chr_id_mismatches: int = 0
    position_mismatches: int = 0
    zygosity_mismatches: int = 0
    zero_coverage: int = 0


@dataclass
class AlignmentStatistics:
    reads_processed: int = 0
    flags_not_matched: int = 0
    ref_id_mismatches: int = 0
    mate_ref_id_mismatches: int = 0
    position_mismatches: int = 0
    matched_reads: int = 0


@dataclass
class _Candidate:
    pos: int
    seq: str
    cigar: Cigar
    ref_length: int
    right_anchored_length: int
    order: int

    @property
    def ref_end(self) -> int:
        return self.pos + self.ref_length


class AlignmentSweep:
    """Streaming sweep keeping candidates overlapping the current variant
    (alignment_reader, main.cc:543-678)."""

    def __init__(
        self,
        reader,
        ref_names: list[str],
        contig: str | None,
        contig_is_prefix: bool,
        primary_only: bool,
        same_ref_in_next: bool,
    ):
        self._it = iter(reader)
        self._pending: SamRecord | None = None
        self.statistics = AlignmentStatistics()
        self.candidates: list[_Candidate] = []
        self._order = 0
        self._prev_pos = 0
        self.primary_only = primary_only
        self.same_ref_in_next = same_ref_in_next
        if contig is None:
            self.target = [True] * len(ref_names)
        else:
            self.target = [
                (name.startswith(contig) if contig_is_prefix else name == contig)
                for name in ref_names
            ]

    def update(self, var_pos: int) -> None:
        st = self.statistics
        self.candidates = [c for c in self.candidates if c.ref_end > var_pos]
        cand_pos = {c.pos for c in self.candidates}

        while True:
            # Like the reference, a record beyond var_pos is left at the
            # stream head and *fully reprocessed* on the next call (the
            # reference returns without advancing its iterator and the loop
            # re-runs every check and counter, main.cc:584-678).
            if self._pending is not None:
                rec = self._pending
                self._pending = None
            else:
                rec = next(self._it, None)
            if rec is None:
                return
            st.reads_processed += 1
            # 0x4 unmapped | 0x200 QC fail | 0x400 dup | 0x800 suppl.
            if rec.flag & (0x4 | 0x200 | 0x400 | 0x800):
                st.flags_not_matched += 1
                continue
            if self.primary_only and rec.flag & 0x100:
                st.flags_not_matched += 1
                continue
            if rec.ref_id < 0 or not self.target[rec.ref_id]:
                st.ref_id_mismatches += 1
                continue
            if self.same_ref_in_next:
                if rec.mate_ref_id < 0 or not self.target[rec.mate_ref_id]:
                    st.mate_ref_id_mismatches += 1
                    continue
            if rec.pos < 0:
                st.flags_not_matched += 1
                continue
            if self._prev_pos > rec.pos:
                raise ValueError("alignments must be sorted by position")
            self._prev_pos = rec.pos

            if rec.pos > var_pos:
                st.position_mismatches += 1
                self._pending = rec
                return

            ref_len, right_anchored = calculate_record_lengths(rec.cigar)
            if rec.pos + ref_len <= var_pos:
                st.position_mismatches += 1
                continue

            st.matched_reads += 1
            # The reference's candidate container is a std::set keyed by
            # reference position only (main.cc:479-484,677), so a second
            # record at an already-present start position is NOT inserted.
            if rec.pos not in cand_pos:
                cand_pos.add(rec.pos)
                self.candidates.append(
                    _Candidate(
                        pos=rec.pos,
                        seq=normalise_dna5(rec.seq).decode(),
                        cigar=rec.cigar,
                        ref_length=ref_len,
                        right_anchored_length=right_anchored,
                        order=self._order,
                    )
                )
            self._order += 1


def _iter_passing_variants(
    vcf: VcfReader,
    var_stats: VariantStatistics,
    regions: RegionSet | None,
    chr_id: str | None,
    zygosity: int,
):
    """Shared VCF validation/filter loop (main.cc:817-873): yields
    (var, zyg) for variants reaching the sweep, updating var_stats and
    raising on sortedness / non-diploid inputs exactly like the object
    path."""
    prev_key = None
    seen_chroms: set[str] = set()
    for var in vcf:
        var_stats.variants_processed += 1

        # sortedness + region validation (libbio region_variant_validator)
        if prev_key is not None and var.chrom == prev_key[0] and var.pos < prev_key[1]:
            raise ValueError(
                f"line {var.lineno}: variants are not sorted by chromosome ID and position"
            )
        if prev_key is not None and var.chrom != prev_key[0]:
            if var.chrom in seen_chroms:
                raise ValueError(
                    f"line {var.lineno}: contigs are not in contiguous blocks"
                )
        seen_chroms.add(var.chrom)
        prev_key = (var.chrom, var.pos)

        if regions is not None:
            if not regions.has_chrom(var.chrom):
                var_stats.chr_id_mismatches += 1
                continue
            if not regions.contains(var.chrom, var.pos):
                var_stats.position_mismatches += 1
                continue

        if chr_id is not None and var.chrom != chr_id:
            var_stats.chr_id_mismatches += 1
            continue

        gt = var.genotype(0)
        if len(gt) != 2:
            raise ValueError(
                f"Variant on line {var.lineno} has non-diploid GT ({len(gt)})"
            )
        zyg = sum(1 for a in gt if a)
        if 0 <= zygosity != zyg:
            var_stats.zygosity_mismatches += 1
            continue

        yield var, zyg


def _format_v_line(var, zyg: int, co_field_id: str, usra_field_id: str) -> str:
    is_reversed = int(
        (co_field_id in var.info) or (usra_field_id in var.info)
    )
    alts_txt = ",".join(
        "<DEL>" if a in ("<DEL>", "<DEL:ME>") else a for a in var.alts
    )
    return (
        f"V\t{var.chrom}\t{var.pos}\t{','.join(var.ids)}\t{var.ref}\t"
        f"{alts_txt}\t{zyg}\t{is_reversed}"
    )


def _target_mask(
    ref_names: list[str], contig: str | None, contig_is_prefix: bool
) -> list[bool]:
    if contig is None:
        return [True] * len(ref_names)
    return [
        (name.startswith(contig) if contig_is_prefix else name == contig)
        for name in ref_names
    ]


def _reader_variant_tuples(variants, end_field_id, co_field_id, usra_field_id):
    """(pos, end, alt_len, v_line, lineno, n_alts) from the object-path
    (var, zyg) stream — the fallback producer for _run_fast."""
    for var, zyg in variants:
        v_line = (
            _format_v_line(var, zyg, co_field_id, usra_field_id) + "\n"
        ).encode("latin1")
        alt_len = len(var.alts[0]) if len(var.alts) == 1 else -1
        yield (
            var.pos, var.end_pos(end_field_id), alt_len, v_line,
            var.lineno, len(var.alts),
        )


def _native_variant_tuples(
    nat,
    vcf_path: str,
    var_stats: VariantStatistics,
    regions,
    chr_id: str | None,
    zygosity: int,
    end_field_id: str,
    co_field_id: str,
    usra_field_id: str,
):
    """C VCF record parsing (csr_parse_vcf) + the Python-side validation
    and filters of _iter_passing_variants, yielding the same tuples as
    _reader_variant_tuples.  Rows the C parser flags as anomalous are
    re-parsed with the Python reader to reproduce its exact errors."""
    import gzip

    import numpy as np

    from ..io.vcf import VcfReader

    fh = (
        gzip.open(vcf_path, "rb")
        if vcf_path.endswith(".gz")
        else open(vcf_path, "rb")
    )
    try:
        lineno = 0
        while True:
            raw = fh.readline()
            if not raw:
                return  # header-only / empty: no records
            lineno += 1
            s = raw.rstrip(b"\n")
            if s.startswith(b"##"):
                continue
            if s.startswith(b"#CHROM"):
                break
            raise ValueError(
                f"unexpected VCF line {lineno}: {s.decode('latin1')!r}"
            )

        end_b = end_field_id.encode()
        co_b = co_field_id.encode()
        usra_b = usra_field_id.encode()
        chr_id_b = chr_id.encode("latin1") if chr_id is not None else None
        # chromosome names stay bytes on this path; decode only for the
        # region filter and error messages
        prev_key: tuple[bytes, int] | None = None
        seen_chroms: set[bytes] = set()
        while True:
            block = fh.readlines(1 << 20)
            if not block:
                return
            vlines, chroms, meta_b, n = nat.csr_parse_vcf(
                block, lineno + 1, end_b, co_b, usra_b
            )
            lineno += len(block)
            rows = np.frombuffer(meta_b, np.int64).reshape(n, 8).tolist()
            for i, (pos, end0, alt_len, n_alts, zyg, gt_len, ln,
                    flags) in enumerate(rows):
                var = None
                if flags & 1:
                    # anomalous row: vlines[i] holds the raw line; Python
                    # re-parse raises exactly like the object reader would
                    # (before the processed counter, matching its order)
                    var = VcfReader.parse_record_line(
                        vlines[i].decode("latin1"), ln
                    )
                    chrom = var.chrom.encode("latin1")
                    pos = var.pos
                else:
                    chrom = chroms[i]
                var_stats.variants_processed += 1

                if (
                    prev_key is not None
                    and chrom == prev_key[0]
                    and pos < prev_key[1]
                ):
                    raise ValueError(
                        f"line {ln}: variants are not sorted by chromosome ID and position"
                    )
                if prev_key is not None and chrom != prev_key[0]:
                    if chrom in seen_chroms:
                        raise ValueError(
                            f"line {ln}: contigs are not in contiguous blocks"
                        )
                    seen_chroms.add(chrom)
                elif prev_key is None:
                    seen_chroms.add(chrom)
                prev_key = (chrom, pos)

                if regions is not None:
                    chrom_s = chrom.decode("latin1")
                    if not regions.has_chrom(chrom_s):
                        var_stats.chr_id_mismatches += 1
                        continue
                    if not regions.contains(chrom_s, pos):
                        var_stats.position_mismatches += 1
                        continue
                if chr_id_b is not None and chrom != chr_id_b:
                    var_stats.chr_id_mismatches += 1
                    continue

                if var is not None:
                    gt = var.genotype(0)
                    if len(gt) != 2:
                        raise ValueError(
                            f"Variant on line {ln} has non-diploid GT ({len(gt)})"
                        )
                    zyg = sum(1 for a in gt if a)
                elif gt_len != 2:
                    raise ValueError(
                        f"Variant on line {ln} has non-diploid GT ({gt_len})"
                    )
                if 0 <= zygosity != zyg:
                    var_stats.zygosity_mismatches += 1
                    continue

                if var is not None:
                    v_line = (
                        _format_v_line(var, zyg, co_field_id, usra_field_id)
                        + "\n"
                    ).encode("latin1")
                    end0 = var.end_pos(end_field_id)
                    alt_len = len(var.alts[0]) if len(var.alts) == 1 else -1
                    n_alts = len(var.alts)
                    yield pos, end0, alt_len, v_line, ln, n_alts
                else:
                    yield pos, end0, alt_len, vlines[i], ln, n_alts
    finally:
        fh.close()


def _run_fast(
    nat,
    reader: SamReader,
    variant_tuples,
    var_stats: VariantStatistics,
    out,
    *,
    contig: str | None,
    contig_is_prefix: bool,
    primary_only: bool,
    same_ref: bool,
    include_clipping: bool,
    anchor_left: bool,
) -> AlignmentStatistics:
    """Native sweep engine loop: batches passing variants and streams raw
    SAM line chunks through csr_sweep_chunk, whose output is byte-identical
    to the object path's V/R stream."""
    mask = bytes(
        bytearray(_target_mask(reader.header.ref_names, contig, contig_is_prefix))
    )
    refmap = {n.encode(): i for i, n in enumerate(reader.header.ref_names)}
    state = nat.csr_sweep_new(
        mask, refmap, int(primary_only), int(same_ref),
        int(include_clipping), int(anchor_left),
    )
    line_iter = reader.raw_record_line_blocks()
    lines: list[bytes] = []
    sam_eof = False

    BATCH = 512
    vp: list[int] = []
    ve: list[int] = []
    va: list[int] = []
    vlines: list[bytes] = []
    vmeta: list[tuple[int, int]] = []  # (lineno, n_alts)

    def flush() -> None:
        nonlocal sam_eof
        vi = 0
        while vi < len(vp):
            blob, vc, lc, errflag = nat.csr_sweep_chunk(
                state, lines, vp[vi:], ve[vi:], va[vi:], vlines[vi:],
                int(sam_eof),
            )
            if blob:
                out.write(blob.decode("latin1"))
            del lines[:lc]
            vi += vc
            if errflag:
                lineno, n_alts = vmeta[vi]
                raise ValueError(
                    f"line {lineno}: exactly one ALT supported, got {n_alts}"
                )
            if vi < len(vp) and not sam_eof and not lines:
                block = next(line_iter, None)
                if block is None:
                    sam_eof = True
                else:
                    lines.extend(block)
        vp.clear(); ve.clear(); va.clear(); vlines.clear(); vmeta.clear()

    try:
        for pos, end0, alt_len, v_line, lineno, n_alts in variant_tuples:
            vp.append(pos)
            ve.append(end0)
            # alt_len < 0 signals the multi-ALT error path (raised only when
            # the variant has coverage, after its V line — main.cc order)
            va.append(alt_len)
            vlines.append(v_line)
            vmeta.append((lineno, n_alts))
            if len(vp) >= BATCH:
                flush()
    except Exception:
        # drain buffered variants so partial output matches the streaming
        # object path before re-raising
        try:
            flush()
        except Exception:
            pass
        raise
    flush()

    (reads, flags_nm, ref_mm, mate_mm, pos_mm, matched, zero_cov) = (
        nat.csr_sweep_stats(state)
    )
    var_stats.zero_coverage += zero_cov
    return AlignmentStatistics(
        reads_processed=reads,
        flags_not_matched=flags_nm,
        ref_id_mismatches=ref_mm,
        mate_ref_id_mismatches=mate_mm,
        position_mismatches=pos_mm,
        matched_reads=matched,
    )


def run_count_supporting_reads(
    vcf_path: str,
    alignments_path_or_fh,
    out=sys.stdout,
    *,
    chr_id: str | None = None,
    regions_path: str | None = None,
    zygosity: int = -1,
    contig: str | None = None,
    contig_is_prefix: bool = False,
    primary_only: bool = False,
    same_ref: bool = False,
    include_clipping: bool = False,
    anchor_left: bool = False,
    end_field_id: str = "END",
    co_field_id: str = "CO",
    usra_field_id: str = "USRA",
) -> tuple[VariantStatistics, AlignmentStatistics]:
    if same_ref and (contig is None or not primary_only):
        raise ValueError("--same-ref requires --contig and --primary-only")

    reader = SamReader(alignments_path_or_fh)

    regions = None
    if regions_path:
        regions = RegionSet()
        regions.load_bed(regions_path)

    var_stats = VariantStatistics()

    if os.environ.get("PANVC3_CSR_FAST") != "0":
        nat = get_native()
        if os.environ.get("PANVC3_CSR_VCF_FAST") != "0":
            tuples = _native_variant_tuples(
                nat, vcf_path, var_stats, regions, chr_id, zygosity,
                end_field_id, co_field_id, usra_field_id,
            )
        else:
            vcf = VcfReader(vcf_path)
            tuples = _reader_variant_tuples(
                _iter_passing_variants(vcf, var_stats, regions, chr_id, zygosity),
                end_field_id, co_field_id, usra_field_id,
            )
        align_stats = _run_fast(
            nat, reader, tuples, var_stats, out,
            contig=contig, contig_is_prefix=contig_is_prefix,
            primary_only=primary_only, same_ref=same_ref,
            include_clipping=include_clipping, anchor_left=anchor_left,
        )
        _print_stats(out, var_stats, align_stats)
        return var_stats, align_stats

    vcf = VcfReader(vcf_path)
    variants = _iter_passing_variants(vcf, var_stats, regions, chr_id, zygosity)
    sweep = AlignmentSweep(
        reader,
        reader.header.ref_names,
        contig,
        contig_is_prefix,
        primary_only,
        same_ref,
    )

    for var, zyg in variants:
        var_pos = var.pos
        var_end_pos = var.end_pos(end_field_id)
        sweep.update(var_pos)
        if not sweep.candidates:
            var_stats.zero_coverage += 1
            continue

        print(_format_v_line(var, zyg, co_field_id, usra_field_id), file=out)

        if len(var.alts) != 1:
            raise ValueError(
                f"line {var.lineno}: exactly one ALT supported, got {len(var.alts)}"
            )
        var_alt_len = len(var.alts[0])
        var_ref_len = var_end_pos - var_pos

        supported: dict[str, int] = {}
        for cand in sorted(sweep.candidates, key=lambda c: (c.pos, c.order)):
            contained = (
                var_end_pos <= cand.pos + cand.ref_length
                if anchor_left
                else var_end_pos < cand.pos + cand.right_anchored_length
            )
            if not contained:
                continue
            allele = try_read_aligned_sequence(
                cand.pos,
                cand.seq,
                cand.cigar,
                cand.ref_length,
                var_pos,
                var_ref_len,
                var_alt_len,
                include_clipping,
            )
            if allele is not None:
                supported[allele] = supported.get(allele, 0) + 1

        for allele in sorted(supported, key=_dna11_key):
            label = allele if allele else "<DEL>"
            print(f"R\t{supported[allele]}\t{label}", file=out)

    _print_stats(out, var_stats, sweep.statistics)
    return var_stats, sweep.statistics


def _print_stats(out, var_stats: VariantStatistics, a: AlignmentStatistics) -> None:
    print(f"S\tTotal variants\t{var_stats.variants_processed}", file=out)
    print(f"S\tChromosome ID mismatches\t{var_stats.chr_id_mismatches}", file=out)
    print(f"S\tPosition mismatches\t{var_stats.position_mismatches}", file=out)
    print(f"S\tZygosity mismatches\t{var_stats.zygosity_mismatches}", file=out)
    print(f"S\tZero coverage\t{var_stats.zero_coverage}", file=out)
    print(f"T\tReads processed\t{a.reads_processed}", file=out)
    print(f"T\tFlags not matched\t{a.flags_not_matched}", file=out)
    print(f"T\tRef. ID mismatches\t{a.ref_id_mismatches}", file=out)
    print(f"T\tPair ref. ID mismatches\t{a.mate_ref_id_mismatches}", file=out)
    print(f"T\tPosition mismatches\t{a.position_mismatches}", file=out)
    print(f"T\tMatched alignments\t{a.matched_reads}", file=out)
