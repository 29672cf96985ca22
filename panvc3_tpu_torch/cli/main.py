"""CLI of the port: ``python -m panvc3_tpu_torch project_alignments ...``.

The options are ``panvc3_tpu``'s ``panvc3_project_alignments`` options
(the reference tool's gengetopt names) plus ``--device {cuda,cpu}``, which
defaults to ``cuda`` and raises when no card is present.  The other tools
of ``panvc3_tpu`` are not ported yet; run them with
``python -m panvc3_tpu <tool>``.
"""

from __future__ import annotations

import argparse
import sys

from .. import __version__


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


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="panvc3_project_alignments",
        description="Project alignments to founder sequences to a given "
        "reference sequence (PyTorch/CUDA port)",
    )
    p.add_argument(
        "--version", action="version", version=f"%(prog)s {__version__}"
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
        help="shard batches over several devices (not ported: raises)",
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
    return p


def cmd_project_alignments(argv=None) -> int:
    args = _parser().parse_args(argv)
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


TOOLS = {"project_alignments": cmd_project_alignments}
NOT_PORTED = (
    "index_msa", "recalculate_mapq", "subset_alignments",
    "count_supporting_reads", "rewrite_cigar",
    "split_alignments_by_reference", "alignment_statistics",
    "convert_bed_positions",
)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m panvc3_tpu_torch <tool> [options]\n\ntools:")
        for name in TOOLS:
            print(f"  {name}")
        return 0
    tool = argv[0]
    if tool in NOT_PORTED:
        print(
            f"{tool!r} is not ported yet (ROADMAP Queue 1 item 8); run "
            f"python -m panvc3_tpu {tool}",
            file=sys.stderr,
        )
        return 2
    if tool not in TOOLS:
        print(f"unknown tool {tool!r}", file=sys.stderr)
        return 2
    try:
        return TOOLS[tool](argv[1:])
    except (ValueError, KeyError, FileNotFoundError) as exc:
        # input/config errors exit cleanly like the reference tools
        msg = str(exc) if isinstance(exc, OSError) else (
            exc.args[0] if exc.args else exc
        )
        print(f"ERROR: {msg}", file=sys.stderr)
        return 1
    except BrokenPipeError:
        return 0
