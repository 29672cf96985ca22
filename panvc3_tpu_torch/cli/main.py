"""CLI of the port: ``python -m panvc3_tpu_torch <tool> [options]`` runs
all nine tools (copy of ``panvc3_tpu.cli.main``).

Option names are ``panvc3_tpu``'s (the reference tools' gengetopt names),
option for option.  ``project_alignments`` adds ``--device {cuda,cpu}``,
which defaults to ``cuda`` and raises when no card is present; the other
eight tools run on the host, as they do in ``panvc3_tpu``, and take no
``--device``.
"""

from __future__ import annotations

import argparse
import sys

from .. import __version__


def _parser(**kw) -> argparse.ArgumentParser:
    """ArgumentParser with the gengetopt-style --version flag every
    reference tool exposes."""
    p = argparse.ArgumentParser(**kw)
    p.add_argument(
        "--version", action="version",
        version=f"%(prog)s {__version__}",
    )
    return p


def _debug_flags(args) -> None:
    if getattr(args, "print_invocation", False):
        print("Invocation: " + " ".join(sys.argv), file=sys.stderr)
    if getattr(args, "print_pid", False):
        import os

        print(f"PID: {os.getpid()}", file=sys.stderr)


def _in_stream(path: str | None):
    if path:
        return path
    return sys.stdin.buffer


def _out_stream(path: str | None):
    if path:
        return path
    return sys.stdout.buffer


# -- index_msa --------------------------------------------------------------

def cmd_index_msa(argv=None) -> int:
    p = _parser(
        prog="panvc3_index_msa",
        description="Build a co-ordinate transformation index from a set of "
        "aligned sequences and optionally output indexable FASTA.",
    )
    p.add_argument("-d", "--msa-index-input", metavar="filename")
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("-B", "--build-index", action="store_true")
    mode.add_argument("-L", "--list-contents", action="store_true")
    mode.add_argument("-Q", "--query", action="store_true")
    p.add_argument("-i", "--sequence-inputs", metavar="filename")
    p.add_argument("-a", "--sequences", metavar="filename")
    p.add_argument("-m", "--msa-index-output", metavar="filename")
    p.add_argument("-p", "--pipe-input", metavar="command")
    p.add_argument("-f", "--output-fasta", action="store_true")
    p.add_argument("-w", "--fasta-line-width", type=int, default=0)
    p.add_argument("--chr-id")
    args = p.parse_args(argv)

    from ..msa_index import MsaIndex
    from ..pipeline.index_msa import (
        build_index_from_a2m,
        build_index_from_tsv,
        list_contents,
        query_repl,
    )

    if args.build_index:
        if not args.msa_index_output:
            p.error("--build-index requires --msa-index-output")
        base = MsaIndex.load(args.msa_index_input) if args.msa_index_input else None
        fasta_out = sys.stdout.buffer if args.output_fasta else None
        if args.sequence_inputs:
            index = build_index_from_tsv(
                args.sequence_inputs,
                pipe_command=args.pipe_input,
                fasta_out=fasta_out,
                fasta_line_width=args.fasta_line_width,
                base_index=base,
            )
        elif args.sequences:
            index = build_index_from_a2m(
                args.sequences,
                pipe_command=args.pipe_input,
                fasta_out=fasta_out,
                fasta_line_width=args.fasta_line_width,
                base_index=base,
            )
        else:
            p.error("--build-index requires --sequence-inputs or --sequences")
        index.save(args.msa_index_output)
        return 0

    if not args.msa_index_input:
        p.error("this mode requires --msa-index-input")
    index = MsaIndex.load(args.msa_index_input)
    if args.list_contents:
        list_contents(index)
        return 0
    # interactive query REPL (index-msa/main.cc:88-190)
    if not args.chr_id:
        p.error("--query requires --chr-id")
    query_repl(index, args.chr_id)
    return 0


# -- project_alignments -----------------------------------------------------

def _parse_shard(spec: str | None) -> tuple[int, int] | None:
    """'K/N' -> (K, N) with 0 <= K < N."""
    if not spec:
        return None
    try:
        k_s, n_s = spec.split("/")
        k, n = int(k_s), int(n_s)
    except ValueError:
        raise ValueError(f"invalid shard spec {spec!r}; expected K/N")
    if not 0 <= k < n:
        raise ValueError(f"invalid shard spec {spec!r}; need 0 <= K < N")
    return (k, n)


def cmd_project_alignments(argv=None) -> int:
    p = _parser(
        prog="panvc3_project_alignments",
        description="Project alignments to founder sequences to a given "
        "reference sequence (PyTorch/CUDA port)",
    )
    p.add_argument("-a", "--alignments", metavar="filename")
    p.add_argument("-B", "--bam-input", action="store_true")
    p.add_argument("-m", "--msa-index", required=True, metavar="filename")
    p.add_argument("-r", "--reference", required=True, metavar="filename")
    p.add_argument("-d", "--reference-msa-id", required=True)
    p.add_argument("-s", "--ref-id-separator", default="_")
    p.add_argument("-u", "--reference-order-input", metavar="filename")
    p.add_argument("-o", "--output-path", metavar="path")
    p.add_argument("-b", "--output-bam", action="store_true")
    p.add_argument("--status-output-interval", type=int, default=5)
    p.add_argument("-l", "--output-realigned-ranges", metavar="filename")
    p.add_argument("--keep-duplicate-ranges", action="store_true")
    p.add_argument("-t", "--preserve-tag", action="append", default=[])
    p.add_argument("--original-rname-tag", default="XR")
    p.add_argument("--original-pos-tag", default="XP")
    p.add_argument("--original-rnext-tag", default="YR")
    p.add_argument("--original-pnext-tag", default="YP")
    p.add_argument("--realigned-query-ranges-tag", default="XB")
    p.add_argument("--realigned-ref-ranges-tag", default="YB")
    p.add_argument("--record-index-tag")
    p.add_argument("-q", "--use-read-base-qualities", action="store_true")
    p.add_argument("-g", "--gap-opening-cost", type=int, default=0)
    p.add_argument("-e", "--gap-extension-cost", type=int, default=-1)
    p.add_argument("--engine", choices=("host", "device"), default="device")
    p.add_argument("--device-batch-size", type=int, default=8192)
    p.add_argument(
        "--pipeline-depth",
        type=int,
        default=2,
        help="device batches kept in flight (overlaps host and device work)",
    )
    p.add_argument(
        "--msa-index-chr-shard",
        metavar="K/N",
        help="load only chromosome shard K of N (input must be pre-routed, "
        "e.g. with panvc3_split_alignments_by_reference)",
    )
    p.add_argument(
        "--data-parallel",
        type=int,
        default=0,
        help="shard batches over a device mesh (0=single device, -1=all, N=first N)",
    )
    p.add_argument("--print-invocation", action="store_true")
    p.add_argument("--print-pid", action="store_true")
    p.add_argument("--debugging-output", action="store_true")
    p.add_argument(
        "--device",
        choices=("cuda", "cpu"),
        default="cuda",
        help="cuda (default; raises without a card) or cpu (plain PyTorch "
        "versions of the kernels, for testing)",
    )
    args = p.parse_args(argv)
    _debug_flags(args)

    from ..pipeline.project_alignments import (
        ProjectConfig,
        TagSpec,
        run_project_alignments,
    )

    cfg = ProjectConfig(
        msa_index_path=args.msa_index,
        reference_path=args.reference,
        reference_msa_id=args.reference_msa_id,
        ref_id_separator=args.ref_id_separator,
        reference_order_path=args.reference_order_input,
        preserve_tags=tuple(args.preserve_tag),
        tags=TagSpec(
            original_rname=args.original_rname_tag,
            original_pos=args.original_pos_tag,
            original_rnext=args.original_rnext_tag,
            original_pnext=args.original_pnext_tag,
            realn_query_ranges=args.realigned_query_ranges_tag,
            realn_ref_ranges=args.realigned_ref_ranges_tag,
            rec_idx=args.record_index_tag,
        ),
        use_read_base_qualities=args.use_read_base_qualities,
        gap_opening_cost=args.gap_opening_cost,
        gap_extension_cost=args.gap_extension_cost,
        output_realigned_ranges_path=args.output_realigned_ranges,
        keep_duplicate_ranges=args.keep_duplicate_ranges,
        debugging_output=args.debugging_output,
        output_bam=args.output_bam,
        command_line=" ".join(sys.argv),
        engine=args.engine,
        device_batch_size=args.device_batch_size,
        pipeline_depth=args.pipeline_depth,
        chr_shard=_parse_shard(args.msa_index_chr_shard),
        data_parallel=args.data_parallel,
        status_output_interval=args.status_output_interval,
    )
    stats = run_project_alignments(
        _in_stream(args.alignments), _out_stream(args.output_path), cfg,
        device=args.device, version=__version__,
    )
    print(f"Matched reads:     {stats.matched_reads}", file=sys.stderr)
    print(f"Ref. ID missing:   {stats.ref_id_missing}", file=sys.stderr)
    print(f"Flags not matched: {stats.flags_not_matched}", file=sys.stderr)
    print(f"Sequence missing:  {stats.seq_missing}", file=sys.stderr)
    if stats.written_range_count is not None:
        print(f"Re-aligned ranges: {stats.written_range_count}", file=sys.stderr)
    if not stats.removed_tag_counts:
        print("No tags removed.", file=sys.stderr)
    else:
        print("Removed tags:", file=sys.stderr)
        for tag in sorted(stats.removed_tag_counts):
            print(f"\t{tag}: {stats.removed_tag_counts[tag]}", file=sys.stderr)
    return 0


# -- recalculate_mapq -------------------------------------------------------

def cmd_recalculate_mapq(argv=None) -> int:
    p = _parser(
        prog="panvc3_recalculate_mapq",
        description="Recalculate the mapping quality from the given alignments",
    )
    p.add_argument("-a", "--alignments", metavar="filename")
    p.add_argument("-B", "--bam-input", action="store_true")
    p.add_argument("-o", "--output-path", metavar="path")
    p.add_argument("-b", "--output-bam", action="store_true")
    p.add_argument("--status-output-interval", type=int, default=5)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--rescore-alignments", action="store_true")
    p.add_argument("--min-mismatch-penalty", type=int, default=2)
    p.add_argument("--max-mismatch-penalty", type=int, default=6)
    p.add_argument("--n-penalty", type=int, default=1)
    p.add_argument("--gap-opening-penalty", type=int, default=5)
    p.add_argument("--gap-extension-penalty", type=int, default=3)
    p.add_argument("--ref-n-positions-tag", default="XN")
    p.add_argument("--original-rname-tag", default="XR")
    p.add_argument("--original-pos-tag", default="XP")
    p.add_argument("--original-rnext-tag", default="YR")
    p.add_argument("--original-pnext-tag", default="YP")
    p.add_argument("--original-alignment-score-tag", default="XS")
    p.add_argument("--new-alignment-score-tag", default="YS")
    p.add_argument("--print-invocation", action="store_true")
    p.add_argument("--print-pid", action="store_true")
    p.add_argument("--print-reference-names", action="store_true")
    p.add_argument(
        "--jobs", type=int, default=1, metavar="N",
        help="worker processes for group scoring (0 = auto); output is "
        "byte-identical to --jobs=1",
    )
    args = p.parse_args(argv)
    _debug_flags(args)

    from ..pipeline.recalculate_mapq import (
        AlignmentScoring,
        MapqTagSpec,
        run_recalculate_mapq,
    )

    stats = run_recalculate_mapq(
        _in_stream(args.alignments),
        _out_stream(args.output_path),
        rescore=args.rescore_alignments,
        scoring=AlignmentScoring(
            min_mismatch_penalty=args.min_mismatch_penalty,
            max_mismatch_penalty=args.max_mismatch_penalty,
            n_penalty=args.n_penalty,
            gap_opening_penalty=args.gap_opening_penalty,
            gap_extension_penalty=args.gap_extension_penalty,
        ),
        tag_spec=MapqTagSpec(
            ref_n_positions=args.ref_n_positions_tag,
            original_rname=args.original_rname_tag,
            original_pos=args.original_pos_tag,
            original_rnext=args.original_rnext_tag,
            original_pnext=args.original_pnext_tag,
            original_alignment_score=args.original_alignment_score_tag,
            new_alignment_score=args.new_alignment_score_tag,
        ),
        output_bam=args.output_bam,
        verbose=args.verbose,
        print_reference_names=args.print_reference_names,
        command_line=" ".join(sys.argv),
        version=__version__,
        jobs=args.jobs,
        status_output_interval=args.status_output_interval,
    )
    print("Done.", file=sys.stderr)
    print(f"\tTotal alignments: {stats.total_alignments}", file=sys.stderr)
    print(f"\tUnpaired alignments: {stats.unpaired_alignments}", file=sys.stderr)
    print(f"\tRecords with mate missing: {stats.mate_not_found}", file=sys.stderr)
    print(
        f"\tReads with and without a mate: {stats.reads_with_and_without_mate}",
        file=sys.stderr,
    )
    print(
        f"\tReads without valid positions: {stats.reads_without_valid_position}",
        file=sys.stderr,
    )
    return 0


# -- subset_alignments ------------------------------------------------------

def cmd_subset_alignments(argv=None) -> int:
    p = _parser(
        prog="panvc3_subset_alignments",
        description="Make a subset of the given alignments.",
    )
    p.add_argument("-a", "--alignments", metavar="filename")
    p.add_argument("-B", "--bam-input", action="store_true")
    p.add_argument("-c", "--chr", metavar="id")
    p.add_argument("-r", "--read-id", action="store_true")
    p.add_argument("-q", "--best-mapq", action="store_true")
    p.add_argument("-o", "--output-path", metavar="path")
    p.add_argument("-b", "--output-bam", action="store_true")
    p.add_argument("--print-invocation", action="store_true")
    p.add_argument("--print-pid", action="store_true")
    args = p.parse_args(argv)
    _debug_flags(args)

    from ..pipeline.subset_alignments import run_subset_alignments

    read_ids = None
    if args.read_id:
        read_ids = [line.rstrip("\n") for line in sys.stdin]
    run_subset_alignments(
        _in_stream(args.alignments),
        _out_stream(args.output_path),
        chr_id=args.chr,
        read_ids=read_ids,
        best_mapq=args.best_mapq,
        output_bam=args.output_bam,
        command_line=" ".join(sys.argv),
        version=__version__,
    )
    return 0


# -- count_supporting_reads -------------------------------------------------

def cmd_count_supporting_reads(argv=None) -> int:
    p = _parser(
        prog="panvc3_count_supporting_reads",
        description="Count the reads that support the reference or the "
        "alternative alleles",
    )
    p.add_argument("-i", "--vcf", required=True, metavar="filename")
    p.add_argument("-a", "--alignments", metavar="filename")
    p.add_argument("-c", "--chr")
    p.add_argument("-r", "--regions", metavar="filename")
    p.add_argument("-z", "--zygosity", type=int, default=-1)
    p.add_argument("-o", "--contig")
    p.add_argument("--contig-prefix", action="store_true")
    p.add_argument("-m", "--primary-only", action="store_true")
    p.add_argument("-s", "--same-ref", action="store_true")
    p.add_argument("-l", "--include-clipping", action="store_true")
    p.add_argument("-n", "--anchor-left", action="store_true")
    p.add_argument("--end-field-id", default="END")
    p.add_argument("--co-field-id", default="CO")
    p.add_argument("--usra-field-id", default="USRA")
    args = p.parse_args(argv)

    from ..pipeline.count_supporting_reads import run_count_supporting_reads

    run_count_supporting_reads(
        args.vcf,
        _in_stream(args.alignments),
        sys.stdout,
        chr_id=args.chr,
        regions_path=args.regions,
        zygosity=args.zygosity,
        contig=args.contig,
        contig_is_prefix=args.contig_prefix,
        primary_only=args.primary_only,
        same_ref=args.same_ref,
        include_clipping=args.include_clipping,
        anchor_left=args.anchor_left,
        end_field_id=args.end_field_id,
        co_field_id=args.co_field_id,
        usra_field_id=args.usra_field_id,
    )
    return 0


# -- rewrite_cigar ----------------------------------------------------------

def cmd_rewrite_cigar(argv=None) -> int:
    p = _parser(
        prog="panvc3_rewrite_cigar",
        description="Rewrite the CIGAR strings in the given alignments",
    )
    p.add_argument("-a", "--alignments", metavar="filename")
    p.add_argument("-B", "--bam-input", action="store_true")
    mode = p.add_mutually_exclusive_group(required=True)
    # reference long names (rewrite-cigar/cmdline.ggo) with short aliases
    mode.add_argument(
        "-M", "--output-alignment-match-ops", "--alignment-match",
        dest="alignment_match", action="store_true",
    )
    mode.add_argument(
        "-S", "--output-sequence-match-ops", "--sequence-match",
        dest="sequence_match", action="store_true",
    )
    p.add_argument("-r", "--reference", metavar="filename")
    p.add_argument("--ref-n-positions-tag", default="XN")
    p.add_argument("-o", "--output-path", metavar="path")
    p.add_argument("-b", "--output-bam", action="store_true")
    p.add_argument("--status-output-interval", type=int, default=5)
    p.add_argument("--print-invocation", action="store_true")
    p.add_argument("--print-pid", action="store_true")
    args = p.parse_args(argv)
    _debug_flags(args)

    from ..pipeline.rewrite_cigar_tool import run_rewrite_cigar

    run_rewrite_cigar(
        _in_stream(args.alignments),
        _out_stream(args.output_path),
        mode="alignment-match" if args.alignment_match else "sequence-match",
        reference_path=args.reference,
        ref_n_positions_tag=args.ref_n_positions_tag,
        output_bam=args.output_bam,
        command_line=" ".join(sys.argv),
        version=__version__,
        status_output_interval=args.status_output_interval,
    )
    return 0


# -- split_alignments_by_reference ------------------------------------------

def cmd_split_alignments(argv=None) -> int:
    p = _parser(
        prog="panvc3_split_alignments_by_reference",
        description="Split the alignments by reference (prefix)",
    )
    p.add_argument("-a", "--alignments", metavar="filename")
    p.add_argument("-B", "--bam-input", action="store_true")
    mode = p.add_mutually_exclusive_group(required=True)
    # reference long names (split-alignments-by-reference/cmdline.ggo)
    mode.add_argument(
        "-S", "--split-alignments", "--split",
        dest="split", action="store_true",
    )
    mode.add_argument(
        "-R", "--read-reference-names", "--list-reference-names",
        dest="list_reference_names", action="store_true",
    )
    p.add_argument("-r", "--reference-names", metavar="filename")
    p.add_argument("-p", "--prefixes", action="store_true")
    p.add_argument("-w", "--rewrite-reference-names", action="store_true")
    p.add_argument("-b", "--basename", default="")
    p.add_argument("-u", "--report-unmatched", action="store_true")
    p.add_argument("--only-used", action="store_true")
    args = p.parse_args(argv)

    from ..pipeline.split_alignments import (
        run_list_reference_names,
        run_split_alignments,
    )

    if args.list_reference_names:
        run_list_reference_names(_in_stream(args.alignments), only_used=args.only_used)
        return 0
    if not args.reference_names:
        p.error("--split requires --reference-names")
    run_split_alignments(
        _in_stream(args.alignments),
        args.reference_names,
        basename=args.basename,
        prefixes=args.prefixes,
        rewrite=args.rewrite_reference_names,
        report_unmatched=args.report_unmatched,
    )
    return 0


# -- alignment_statistics ---------------------------------------------------

def cmd_alignment_statistics(argv=None) -> int:
    p = _parser(
        prog="panvc3_alignment_statistics",
        description="Calculate statistics from the given alignments",
    )
    p.add_argument("-a", "--alignments", metavar="filename")
    p.add_argument("-b", "--bam-input", action="store_true")
    p.add_argument("-r", "--rname", action="append", default=[])
    p.add_argument("-p", "--rname-prefix", action="store_true")
    p.add_argument("-m", "--primary-only", action="store_true")
    p.add_argument("-s", "--same-ref", action="store_true")
    p.add_argument("-l", "--include-clipping", action="store_true")
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("-C", "--coverage", action="store_true")
    mode.add_argument("-O", "--count-alignments", action="store_true")
    mode.add_argument("-M", "--mapq-histogram", action="store_true")
    mode.add_argument("-B", "--mapq-box-plot", action="store_true")
    p.add_argument("--bin-width", type=int, default=100000)
    args = p.parse_args(argv)

    from ..io.sam import SamReader
    from ..pipeline.alignment_statistics import (
        calculate_coverage,
        count_alignments,
        mapq_box_plot,
        mapq_histogram,
    )

    reader = SamReader(_in_stream(args.alignments))
    filters = dict(
        rnames=tuple(args.rname),
        rname_prefix=args.rname_prefix,
        primary_only=args.primary_only,
        same_ref=args.same_ref,
    )
    if args.coverage:
        calculate_coverage(reader, include_clipping=args.include_clipping, **filters)
    elif args.count_alignments:
        count_alignments(reader, **filters)
    elif args.mapq_histogram:
        mapq_histogram(reader, **filters)
    else:
        mapq_box_plot(reader, bin_width=args.bin_width, **filters)
    return 0


# -- convert_bed_positions --------------------------------------------------

def cmd_convert_bed_positions(argv=None) -> int:
    p = _parser(
        prog="panvc3_convert_bed_positions",
        description="Convert the co-ordinate in the given BED file",
    )
    p.add_argument("-b", "--bed", metavar="filename")
    p.add_argument("-m", "--msa-index", required=True, metavar="filename")
    p.add_argument("-c", "--chr", required=True)
    p.add_argument("--dst-chr")
    p.add_argument("-s", "--src-seq", required=True)
    p.add_argument("-d", "--dst-seq", required=True)
    args = p.parse_args(argv)

    from ..pipeline.convert_bed_positions import run_convert_bed_positions

    run_convert_bed_positions(
        args.msa_index,
        args.bed if args.bed else sys.stdin,
        args.chr,
        args.src_seq,
        args.dst_seq,
        dst_chr_id=args.dst_chr,
    )
    return 0


TOOLS = {
    "index_msa": cmd_index_msa,
    "project_alignments": cmd_project_alignments,
    "recalculate_mapq": cmd_recalculate_mapq,
    "subset_alignments": cmd_subset_alignments,
    "count_supporting_reads": cmd_count_supporting_reads,
    "rewrite_cigar": cmd_rewrite_cigar,
    "split_alignments_by_reference": cmd_split_alignments,
    "alignment_statistics": cmd_alignment_statistics,
    "convert_bed_positions": cmd_convert_bed_positions,
}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m panvc3_tpu_torch <tool> [options]\n\ntools:")
        for name in TOOLS:
            print(f"  {name}")
        return 0
    tool = argv[0]
    if tool not in TOOLS:
        print(f"unknown tool {tool!r}", file=sys.stderr)
        return 2
    try:
        return TOOLS[tool](argv[1:])
    except (ValueError, KeyError, FileNotFoundError) as exc:
        # input/config errors exit cleanly like the reference tools
        # OSError args are (errno, strerror) — use the full message
        msg = str(exc) if isinstance(exc, OSError) else (
            exc.args[0] if exc.args else exc
        )
        print(f"ERROR: {msg}", file=sys.stderr)
        return 1
    except BrokenPipeError:
        return 0
