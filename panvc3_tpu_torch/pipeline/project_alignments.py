"""project_alignments on the port (copy of
``panvc3_tpu.pipeline.project_alignments``, trimmed to what the port
calls).

Header processing splits input RNAMEs (``chr<sep>seq``) and emits one
output reference per distinct chr part; records that are unmapped,
QC-fail, duplicate, lack RNAME/POS or have no sequence are dropped with
per-category statistics; each remaining record's CIGAR and position are
projected, the mate's RNEXT/PNEXT too, and tags are rewritten (a whitelist
of SAM tags plus ``--preserve-tag`` survives, the original alignment goes
to OA, original RNAME/POS/RNEXT/PNEXT to XR/XP/YR/YP, realigned ranges to
XB/YB).  ``engine="device"`` runs on an explicit ``torch.device``: the
port's fast lane (``pipeline/fastlane.run_fast``) where
``fastlane_eligible`` allows, else the object path, which projects parsed
records in batches through ``ops.engine.BatchProjector`` (on its fused
lane when ``cfg.fused_kernel`` is set, by the caller or by the engine-lane
arbiter ``choose_engine_lane``);
``engine="host"`` runs the scalar host oracle (``projector``) record by
record.  ``cfg.data_parallel`` shards the object path's batches over a
device mesh (``parallel.mesh``).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import queue
import sys
import threading
from dataclasses import dataclass, field

import torch

from .. import resolve_device, tracing
from ..alphabet import decode_phred42
from ..cigar import cigar_query_length
from ..io.fasta import FastaReader
from ..io.sam import SamHeader, SamReader, SamRecord, SamWriter
from ..msa_index import MsaIndex, SequenceEntry
from ..projector import project_alignment
from ..seqbuf import SequenceBufferStore
from ..utils import StatusReporter, format_duration, log_time

CHUNK_SIZE = 4
FLAG_SKIP = 0x4 | 0x200 | 0x400  # unmapped | QC fail | duplicate

# SAM spec tags preserved by the reference
# (project-alignments/project_alignments.cc:53-87).
PRESERVED_TAGS = frozenset({
    "AM", "AS", "BC", "BZ", "CB", "CO", "CR", "CS", "CT", "CY", "E2", "FZ",
    "LB", "MI", "ML", "MM", "OA", "OQ", "OX", "PG", "PU", "QT", "QX", "RX",
    "TS",
})


@dataclass
class TagSpec:
    original_rname: str | None = "XR"
    original_pos: str | None = "XP"
    original_rnext: str | None = "YR"
    original_pnext: str | None = "YP"
    realn_query_ranges: str | None = "XB"
    realn_ref_ranges: str | None = "YB"
    rec_idx: str | None = None


@dataclass
class ProjectConfig:
    msa_index_path: str = ""
    reference_path: str = ""
    reference_msa_id: str = ""
    ref_id_separator: str = "_"
    reference_order_path: str | None = None
    preserve_tags: tuple[str, ...] = ()
    tags: TagSpec = field(default_factory=TagSpec)
    use_read_base_qualities: bool = False
    gap_opening_cost: int = 0
    gap_extension_cost: int = -1
    output_realigned_ranges_path: str | None = None
    keep_duplicate_ranges: bool = False
    # --debugging-output: include the task id / QNAME columns in the
    # realigned-ranges TSV (project_alignments.cc:491-497, 1009-1029)
    debugging_output: bool = False
    primary_only: bool = False
    output_bam: bool = False
    status_output_interval: int = 5  # minutes; 0 disables
    command_line: str = "panvc3_tpu project_alignments"
    engine: str = "host"  # "host" or "device"
    device_batch_size: int = 8192  # records per device batch
    pipeline_depth: int = 2  # batches kept in flight on the device
    # run the finish/apply stages on a worker thread so device fetches
    # (GIL-released) overlap the reader loop's parsing
    threaded_pipeline: bool = True
    # (k, n): this host loads only shard k of the chromosomes (round-robin
    # over sorted ids); input must be pre-routed per shard (e.g. with
    # split_alignments_by_reference).  None = whole index.
    chr_shard: tuple[int, int] | None = None
    # data-parallel sharding over several devices (not ported: raises)
    data_parallel: int = 0
    # the single-dispatch fused engines (ops/fused_event.py, ops/fused.py);
    # set by the engine-lane arbiter (PANVC3_ENGINE_LANE=fused forces it)
    fused_kernel: bool = False
    # native batch fast lane (pipeline/fastlane.py): raw SAM lines are
    # parsed/staged/spliced/formatted in C.  False takes the object path
    # (parsed records through BatchProjector)
    fastlane: bool = True


@dataclass
class ProjectStatistics:
    flags_not_matched: int = 0
    ref_id_missing: int = 0
    seq_missing: int = 0
    matched_reads: int = 0
    realigned_range_count: int = 0
    removed_tag_counts: dict[str, int] = field(default_factory=dict)
    # realignment observability (reference delegate hooks + status line,
    # project_alignments.cc:446-481, 931-944): total ns in the realignment
    # DP (batch wall time for the device engine) and total max(ref, query)
    # run length, for the µs/realignment and mean-length status figures
    realignment_time_ns: int = 0
    realigned_range_total_length: int = 0
    # total realignment-DP cells (ref_length x query_length summed over
    # runs) — numerator of the bench's cell-updates/s metric
    realignment_cells: int = 0
    # number of deduplicated ranges written to the ranges TSV
    # ("Re-aligned ranges: N" in the exit stats, :1056-1057)
    written_range_count: int | None = None


def split_ref_id(ref_id: str, separator: str) -> tuple[str, str]:
    """Split ``chr<sep>seq``; the seq part starts one character after the
    separator match (the reference uses substr(1 + pos),
    project_alignments.cc:1330-1334 — single-character separators in
    practice)."""
    pos = ref_id.find(separator)
    if pos < 0:
        raise ValueError(f"separator {separator!r} not found in RNAME {ref_id!r}")
    return ref_id[:pos], ref_id[pos + 1:]


def process_headers(
    input_header: SamHeader,
    separator: str,
    reference_msa_id: str,
    reference_order_path: str | None,
) -> tuple[SamHeader, list[int]]:
    """Build the output header reference set and the input->output reference
    id mapping (mirrors process_headers,
    project-alignments/project_alignments.cc:1092-1253)."""
    input_chr_seq = [split_ref_id(r, separator) for r in input_header.ref_names]

    # Optional user-specified output order.
    order: dict[str, int] = {}
    if reference_order_path:
        unique_chrs = {c for c, _ in input_chr_seq}
        idx = 0
        with open(reference_order_path) as fh:
            for line in fh:
                name = line.rstrip("\n").split("\t")[0]
                if not name:
                    continue
                if name not in unique_chrs:
                    print(
                        f"WARNING: Identifier '{name}' specified in reference "
                        "name order but does not appear in the alignments.",
                        file=sys.stderr,
                    )
                    continue
                if name in order:
                    print(
                        f"WARNING: Identifier '{name}' specified in reference "
                        "name order more than once.",
                        file=sys.stderr,
                    )
                    continue
                order[name] = idx
                idx += 1

    unique: dict[str, int] = {}
    ref_id_mapping: list[int] = []
    next_idx = len(order)
    out_lengths: dict[int, int] = {}
    out_extras: dict[int, str] = {}
    for input_idx, (chr_id, seq_id) in enumerate(input_chr_seq):
        if chr_id in unique:
            out_idx = unique[chr_id]
        elif chr_id in order:
            out_idx = order[chr_id]
            unique[chr_id] = out_idx
        else:
            out_idx = next_idx
            next_idx += 1
            unique[chr_id] = out_idx
            if order:
                print(
                    f"WARNING: Output reference ID '{chr_id}' not found in "
                    "the output order, placing in the end.",
                    file=sys.stderr,
                )
        ref_id_mapping.append(out_idx)
        # LN (and any extra @SQ fields) copied from the projection-target
        # founder's input @SQ entry (project_alignments.cc:1237-1241 copies
        # the whole ref_id_info tuple).
        if seq_id == reference_msa_id:
            out_lengths[out_idx] = input_header.ref_lengths[input_idx]
            if input_idx < len(input_header.ref_extras):
                out_extras[out_idx] = input_header.ref_extras[input_idx]

    n_out = len(unique)
    out_names = [""] * n_out
    for name, i in unique.items():
        out_names[i] = name

    out_header = SamHeader()
    out_header.ref_names = out_names
    # A chromosome whose projection-target founder row is absent from the
    # input header gets LN:0, matching the reference's default-constructed
    # ref_id_info (project_alignments.cc:1229-1240: output_ref_id_info is
    # resize()d and only overwritten for ref_seq_idxs entries).
    out_header.ref_lengths = [out_lengths.get(i, 0) for i in range(n_out)]
    out_header.ref_extras = [out_extras.get(i, "") for i in range(n_out)]
    # Header lines: @HD first (copied or default), then @SQ, then the rest.
    hd = [l for l in input_header.lines if l.startswith("@HD")]
    out_header.lines.extend(hd if hd else ["@HD\tVN:1.6"])
    for name, length, extra in zip(
        out_header.ref_names, out_header.ref_lengths, out_header.ref_extras
    ):
        line = f"@SQ\tSN:{name}\tLN:{length}"
        if extra:
            line += "\t" + extra
        out_header.lines.append(line)
    for line in input_header.lines:
        if line.startswith(("@RG", "@PG", "@CO")):
            out_header.lines.append(line)
    return out_header, ref_id_mapping


def fill_sequence_entries(
    msa_index: MsaIndex,
    input_ref_names: list[str],
    n_output_refs: int,
    separator: str,
    reference_msa_id: str,
    ref_id_mapping: list[int],
    allow_missing: bool = False,
) -> tuple[list[SequenceEntry | None], list[SequenceEntry | None]]:
    """Per input/output ref-id tables of MSA sequence entries (mirrors
    fill_sequence_entries,
    project-alignments/project_alignments.cc:1270-1316).

    With ``allow_missing`` (chromosome-sharded index), header references
    whose chromosome is absent from the index get a None entry — a record
    actually using one then fails as mis-routed input."""
    src_entries: list[SequenceEntry | None] = []
    dst_entries: list[SequenceEntry | None] = [None] * n_output_refs
    for input_idx, ref_id in enumerate(input_ref_names):
        chr_id, seq_id = split_ref_id(ref_id, separator)
        chrom = msa_index.find_chr(chr_id)
        if chrom is None:
            if allow_missing:
                src_entries.append(None)
                continue
            raise KeyError(f"no entry for chromosome ID {chr_id!r} in the MSA index")
        out_idx = ref_id_mapping[input_idx]
        if dst_entries[out_idx] is None:
            dst = chrom.find(reference_msa_id)
            if dst is None:
                raise KeyError(
                    f"no entry for sequence ID {reference_msa_id!r} in the MSA index"
                )
            dst_entries[out_idx] = dst
        src = chrom.find(seq_id)
        if src is None:
            raise KeyError(f"no entry for sequence ID {seq_id!r} in the MSA index")
        src_entries.append(src)
    return src_entries, dst_entries


def _project_record(
    rec: SamRecord,
    input_ref_names: list[str],
    src_entries,
    dst_entries,
    ref_id_mapping,
    ref_seqs: dict[int, bytes],
    cfg: ProjectConfig,
    stats: ProjectStatistics,
    rec_idx_value: int | None,
    realigned_ranges_out: list | None,
    task_id: int = 0,
) -> None:
    """Project one record in place via the scalar host oracle."""
    ref_id = rec.ref_id
    dst_ref_id = ref_id_mapping[ref_id]
    src_entry = src_entries[ref_id]
    dst_entry = dst_entries[dst_ref_id]
    ref_seq = ref_seqs[dst_ref_id]

    quals = None
    if cfg.use_read_base_qualities and rec.qual != "*":
        quals = decode_phred42(rec.qual)

    res = project_alignment(
        rec.pos,
        src_entry,
        dst_entry,
        ref_seq,
        rec.seq,
        rec.cigar,
        quals if cfg.use_read_base_qualities else None,
        cfg.gap_opening_cost,
        cfg.gap_extension_cost,
    )
    apply_projection_result(
        rec,
        res,
        input_ref_names,
        src_entries,
        dst_entries,
        ref_id_mapping,
        cfg,
        stats,
        rec_idx_value,
        realigned_ranges_out,
        task_id,
    )


def apply_projection_result(
    rec: SamRecord,
    res,
    input_ref_names: list[str],
    src_entries,
    dst_entries,
    ref_id_mapping,
    cfg: ProjectConfig,
    stats: ProjectStatistics,
    rec_idx_value: int | None,
    realigned_ranges_out: list | None,
    task_id: int = 0,
) -> None:
    """Apply a computed ProjectionResult to the record: tag surgery, mate
    projection, field updates (project_alignments.cc:735-918)."""
    ref_id = rec.ref_id
    dst_ref_id = ref_id_mapping[ref_id]
    src_pos = rec.pos

    stats.realigned_range_count += res.num_realignments
    stats.realignment_time_ns += res.realignment_time_ns
    stats.realigned_range_total_length += res.realigned_total_length
    for (_, rl), (_, ql) in zip(
        res.realigned_reference_ranges, res.realigned_query_ranges
    ):
        stats.realignment_cells += rl * ql
    if realigned_ranges_out is not None:
        for loc, length in res.realigned_reference_ranges:
            realigned_ranges_out.append((loc, length, rec.qname, task_id))

    # -- tag surgery ------------------------------------------------------
    tags = rec.tags
    original_nm = tags.get("NM", (None, None))[1]

    preserved = PRESERVED_TAGS
    extra = set(cfg.preserve_tags)
    for tag in list(tags):
        if tag in preserved or tag in extra:
            continue
        del tags[tag]
        stats.removed_tag_counts[tag] = stats.removed_tag_counts.get(tag, 0) + 1

    # OA: append "RNAME,pos,strand,CIGAR,MAPQ,NM;".  The reference writes the
    # seqan3 0-based position here (project_alignments.cc:815).
    oa_parts = [
        input_ref_names[ref_id],
        str(src_pos),
        "-" if rec.is_reverse else "+",
        "".join(f"{n}{op}" for n, op in rec.cigar),
        str(rec.mapq),
        "" if original_nm is None else str(original_nm),
    ]
    oa = ",".join(oa_parts) + ";"
    prev_oa = tags.get("OA", ("Z", ""))[1]
    tags["OA"] = ("Z", prev_oa + oa)

    t = cfg.tags
    n_ranges = res.num_realignments
    if t.realn_query_ranges and n_ranges:
        vals: list[int] = []
        for loc, length in res.realigned_query_ranges:
            vals += [loc, loc + length]
        tags[t.realn_query_ranges] = ("B", ("I", vals))
    if t.realn_ref_ranges and n_ranges:
        vals = []
        for loc, length in res.realigned_reference_ranges:
            vals += [loc, loc + length]
        tags[t.realn_ref_ranges] = ("B", ("I", vals))
    if t.rec_idx and rec_idx_value is not None and rec_idx_value <= 0x7FFFFFFF:
        tags[t.rec_idx] = ("i", rec_idx_value)
    if t.original_rname:
        tags[t.original_rname] = ("i", ref_id)
    if t.original_pos:
        tags[t.original_pos] = ("i", src_pos)

    if rec.mate_ref_id >= 0:
        mate_ref_id = rec.mate_ref_id
        dst_mate_ref_id = ref_id_mapping[mate_ref_id]
        rec.mate_ref_id = dst_mate_ref_id
        if t.original_rnext:
            tags[t.original_rnext] = ("i", mate_ref_id)
        if rec.mate_pos >= 0:
            mate_pos = rec.mate_pos
            rec.mate_pos = int(
                src_entries[mate_ref_id].project_position(
                    mate_pos, dst_entries[dst_mate_ref_id]
                )
            )
            if t.original_pnext:
                tags[t.original_pnext] = ("i", mate_pos)
    else:
        rec.mate_pos = -1

    rec.pos = res.dst_pos
    rec.cigar = res.cigar
    rec.ref_id = dst_ref_id


def run_project_alignments(
    input_path_or_fh,
    output_path_or_fh,
    cfg: ProjectConfig,
    *,
    device="cuda",
    version: str = "0.1",
) -> ProjectStatistics:
    """Project the records of ``input_path_or_fh`` to the reference.
    ``device`` is ``'cuda'`` (the default; raises without a card),
    ``'cuda:N'`` or ``'cpu'`` (the plain PyTorch versions, for tests).
    ``cfg.data_parallel`` shards the device engine's batches over a mesh
    (``make_mesh``): the first N devices of ``device``'s type, or all of
    them for -1; a list of devices (repeats allowed, as ``['cpu'] * 8``)
    is the devices the mesh takes them from, and without
    ``data_parallel`` its first entry is the one device."""
    devices = resolve_device(device)
    dev = devices[0] if isinstance(devices, list) else devices
    if cfg.engine not in ("host", "device"):
        raise ValueError(f"unknown engine {cfg.engine!r}")
    # under PANVC3_FASTLANE_PROF=1 the call's spans, set-up first, and its
    # [fastlane prof] line at the end
    tracing.begin_call()
    with tracing.span("setup_header"):
        reader = SamReader(input_path_or_fh)
        input_header = reader.header
        out_header, ref_id_mapping = process_headers(
            input_header, cfg.ref_id_separator, cfg.reference_msa_id,
            cfg.reference_order_path,
        )
        out_header.append_program(
            "panvc3.project-alignments",
            "PanVC 3 project_alignments",
            cfg.command_line,
            version,
        )

    with tracing.span("setup_index_load"):
        msa_index = MsaIndex.load(cfg.msa_index_path, shard=cfg.chr_shard)
    with tracing.span("setup_entries"):
        src_entries, dst_entries = fill_sequence_entries(
            msa_index,
            input_header.ref_names,
            len(out_header.ref_names),
            cfg.ref_id_separator,
            cfg.reference_msa_id,
            ref_id_mapping,
            allow_missing=cfg.chr_shard is not None,
        )

    with tracing.span("setup_fasta_open"):
        fasta = FastaReader(cfg.reference_path)

    def read_contig(rid):
        with tracing.span("setup_reference_read"):
            return fasta.read_sequence(out_header.ref_names[rid])

    # bounded contig buffers: at most 4 unpinned contigs stay resident;
    # batches hold snapshots so in-flight work keeps its buffers alive
    ref_seqs = SequenceBufferStore(read_contig, max_size=4)
    writer = SamWriter(output_path_or_fh, out_header, bam=cfg.output_bam)
    stats = ProjectStatistics()
    # (loc, length, qname, task_id) rows; task ids are sequential from 1
    realigned_ranges: list[tuple[int, int, str, int]] | None = (
        [] if cfg.output_realigned_ranges_path else None
    )

    if cfg.engine == "device":
        from ..native import get_native
        from ..ops.engine import (
            FUSED_ROUTES,
            BatchProjector,
            choose_engine_lane,
            reset_fused_routes,
        )
        from .fastlane import fastlane_eligible, run_fast

        with tracing.span("setup_engine"):
            mesh = None
            if cfg.data_parallel:
                from ..parallel.mesh import make_mesh

                n = cfg.data_parallel
                mesh = make_mesh(n if n > 0 else None, devices if isinstance(devices, list) else dev.type)
            # the engine-lane arbiter: the fused engine where host CPU is
            # scarce and the device-to-host leg is healthy, else the split
            # fast lane.  Not consulted under a mesh, under -q or without
            # the C extension (the fused engine gates itself off there),
            # nor when the caller chose.
            if (
                not cfg.fused_kernel
                and mesh is None
                and not cfg.use_read_base_qualities
                and get_native() is not None
                and os.environ.get("PANVC3_ENGINE_AUTO", "1") != "0"
                and choose_engine_lane(dev) == "fused"
            ):
                cfg = dataclasses.replace(cfg, fused_kernel=True)
            reset_fused_routes()
            batch_engine = BatchProjector(
                src_entries,
                dst_entries,
                ref_id_mapping,
                cfg.gap_opening_cost,
                cfg.gap_extension_cost,
                device=dev,
                mesh=mesh,
            )
        if cfg.fastlane and fastlane_eligible(cfg, mesh, batch_engine):
            run_fast(
                reader, writer, cfg, stats, batch_engine,
                input_header, out_header, src_entries, dst_entries,
                ref_id_mapping, ref_seqs, realigned_ranges,
            )
        else:
            _run_object(
                reader, writer, cfg, stats, batch_engine, input_header,
                src_entries, dst_entries, ref_id_mapping, ref_seqs,
                realigned_ranges,
            )
            if cfg.fused_kernel and tracing.enabled():
                log_time("[fused routes] " + json.dumps(FUSED_ROUTES))
        stats.realignment_time_ns += batch_engine.realignment_time_ns
    else:
        _run_host(
            reader, writer, cfg, stats, input_header, src_entries,
            dst_entries, ref_id_mapping, ref_seqs, realigned_ranges,
        )
    writer.close()
    if cfg.output_realigned_ranges_path and realigned_ranges is not None:
        _write_realigned_ranges(cfg, realigned_ranges, stats)
    if tracing.enabled():
        log_time(tracing.end_call())
    return stats


def _valid_records(reader, cfg, stats, input_header, src_entries, reporter):
    """(record index, record) of each record to project, in input order;
    the others are counted in ``stats`` (the reference's reader-loop
    filters, in its order)."""
    for rec_idx, rec in enumerate(reader):
        if (1 + rec_idx) % 10_000_000 == 0:
            log_time(f"Processed {1 + rec_idx} alignments…")
        reporter.tick(rec_idx)
        if rec.flag & FLAG_SKIP:
            stats.flags_not_matched += 1
            continue
        if cfg.primary_only and rec.flag & 0x100:
            stats.flags_not_matched += 1
            continue
        if rec.ref_id < 0:
            stats.ref_id_missing += 1
            continue
        if rec.pos < 0:
            stats.flags_not_matched += 1
            continue
        if not rec.seq or rec.seq == "*":
            stats.seq_missing += 1
            continue
        qlen = cigar_query_length(rec.cigar)
        if rec.cigar and qlen != len(rec.seq):
            raise ValueError(
                f"record {rec.qname!r}: CIGAR consumes {qlen} query "
                f"bases but SEQ has {len(rec.seq)}"
            )
        if src_entries[rec.ref_id] is None:
            raise ValueError(
                f"record {rec.qname!r} references "
                f"{input_header.ref_names[rec.ref_id]!r}, which is outside "
                "this index shard (--msa-index-chr-shard); route the input "
                "with panvc3_split_alignments_by_reference first"
            )
        stats.matched_reads += 1
        yield rec_idx, rec


def _realign_status(stats, batch_engine=None):
    """The status line's realignment part (the reference's, for the
    periodic status output)."""

    def status() -> str:
        n = stats.realigned_range_count
        msg = f"; realigned {n} ranges"
        if n:
            t_ns = stats.realignment_time_ns
            if batch_engine is not None:
                t_ns += batch_engine.realignment_time_ns
            usecs = t_ns / 1000.0 / n
            mean_len = stats.realigned_range_total_length / n
            msg += (
                f" (in {format_duration(t_ns / 1e9)}; "
                f"{usecs:.2f} µs / realignment, mean length {mean_len:g} characters)"
            )
        return msg

    return status


def _run_object(
    reader, writer, cfg, stats, batch_engine, input_header, src_entries,
    dst_entries, ref_id_mapping, ref_seqs, realigned_ranges,
) -> None:
    """The device engine's object path: parsed records in batches through
    ``batch_engine`` (gap kernel, host finalize, realignment on the
    device), up to ``cfg.pipeline_depth`` batches in each of its three
    stages.  With ``cfg.threaded_pipeline`` one worker thread runs the
    finish stages in FIFO order while the main thread parses.  The
    record-index tag is granular per CHUNK_SIZE group of valid records."""
    batch_size = max(CHUNK_SIZE, (cfg.device_batch_size // CHUNK_SIZE) * CHUNK_SIZE)
    dev = batch_engine.device
    task_counter = 0

    def apply_batch(batch_records, results):
        nonlocal task_counter
        for start in range(0, len(batch_records), CHUNK_SIZE):
            sub = batch_records[start:start + CHUNK_SIZE]
            rec_idx_value = sub[-1][0] - len(sub) + 1
            task_counter += 1
            for off, (_, rec) in enumerate(sub):
                apply_projection_result(
                    rec, results[start + off], input_header.ref_names,
                    src_entries, dst_entries, ref_id_mapping, cfg, stats,
                    rec_idx_value, realigned_ranges, task_counter,
                )
        for _, rec in batch_records:
            writer.write(rec)

    def on_device():
        # threads launch and fetch on the projector's device, whatever
        # their current device
        return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()

    # three stages per batch: start_batch (gap kernel launched; in
    # in_flight), finish_rewrite (host finalize, realignment launched; in
    # realign_flight), finish_realign (fetch, splice, write)
    max_in_flight = max(1, cfg.pipeline_depth)
    in_flight: collections.deque = collections.deque()
    realign_flight: collections.deque = collections.deque()

    def drain_one():
        batch_records, handle = in_flight.popleft()
        realign_flight.append((batch_records, batch_engine.finish_rewrite(handle)))
        if len(realign_flight) >= max_in_flight:
            drain_realign_one()

    def drain_realign_one():
        batch_records, handle2 = realign_flight.popleft()
        apply_batch(batch_records, batch_engine.finish_realign(handle2))

    worker_error: list[BaseException] = []
    work_q = None
    worker = None
    if cfg.threaded_pipeline:
        work_q = queue.Queue(maxsize=max_in_flight)

        def worker_loop():
            try:
                with on_device():
                    while True:
                        item = work_q.get()
                        if item is None:
                            while realign_flight:
                                drain_realign_one()
                            return
                        in_flight.append(item)
                        drain_one()
            except BaseException as exc:  # noqa: BLE001 — re-raised on main
                worker_error.append(exc)
                while work_q.get() is not None:  # unblock the producer
                    pass

        worker = threading.Thread(target=worker_loop, daemon=True)
        worker.start()

    chunk: list[tuple[int, SamRecord]] = []

    def flush_chunk():
        nonlocal chunk
        if not chunk:
            return
        snapshot = ref_seqs.require({ref_id_mapping[r.ref_id] for _, r in chunk})
        handle = batch_engine.start_batch([r for _, r in chunk], snapshot, cfg)
        if work_q is not None:
            if worker_error:
                raise worker_error[0]
            work_q.put((chunk, handle))
        else:
            in_flight.append((chunk, handle))
            if len(in_flight) >= max_in_flight:
                drain_one()
        chunk = []

    reporter = StatusReporter(cfg.status_output_interval)
    reporter.extra_cb = _realign_status(stats, batch_engine)
    try:
        with on_device():
            for item in _valid_records(
                reader, cfg, stats, input_header, src_entries, reporter
            ):
                chunk.append(item)
                if len(chunk) == batch_size:
                    flush_chunk()
            flush_chunk()
    finally:
        # always join the worker: leaving with it mid-dispatch would tear
        # the interpreter down under a device call
        if worker is not None:
            work_q.put(None)
            worker.join()
    if worker_error:
        raise worker_error[0]
    with on_device():
        while in_flight:
            drain_one()
        while realign_flight:
            drain_realign_one()


def _run_host(
    reader, writer, cfg, stats, input_header, src_entries, dst_entries,
    ref_id_mapping, ref_seqs, realigned_ranges,
) -> None:
    """The host engine: each record through the scalar oracle.  The
    record-index tag is granular per CHUNK_SIZE group of valid records:
    every record in a group gets (last record's global index) - group
    size + 1."""
    task_counter = 0
    chunk: list[tuple[int, SamRecord]] = []

    def flush_chunk():
        nonlocal chunk, task_counter
        if not chunk:
            return
        rec_idx_value = chunk[-1][0] - len(chunk) + 1
        task_counter += 1
        for _, rec in chunk:
            _project_record(
                rec,
                input_header.ref_names,
                src_entries,
                dst_entries,
                ref_id_mapping,
                ref_seqs,
                cfg,
                stats,
                rec_idx_value,
                realigned_ranges,
                task_counter,
            )
            writer.write(rec)
        chunk = []

    reporter = StatusReporter(cfg.status_output_interval)
    reporter.extra_cb = _realign_status(stats)
    for item in _valid_records(reader, cfg, stats, input_header, src_entries, reporter):
        chunk.append(item)
        if len(chunk) == CHUNK_SIZE:
            flush_chunk()
    flush_chunk()


def _write_realigned_ranges(
    cfg: ProjectConfig,
    realigned_ranges: list[tuple[int, int, str, int]],
    stats: ProjectStatistics,
) -> None:
    """Write the realigned-ranges TSV (output_realigned_ranges,
    project_alignments.cc:489-503, 1009-1029).

    --keep-duplicate-ranges: per-task output, ranges sorted within each
    task (the reference sorts each task's vector, :756); --debugging-output
    adds the Task and QNAME columns.  Otherwise a global sorted dedup
    (sorted_set_union merge, :986-992); on duplicates the earliest task's
    QNAME is kept, matching the union's keep-first semantics.
    """
    with open(cfg.output_realigned_ranges_path, "w") as fh:
        dbg = cfg.debugging_output
        if cfg.keep_duplicate_ranges:
            fh.write("Location\tLength\tTask\tQNAME\n" if dbg else "Location\tLength\n")
            # rows arrive in task order already; sort within each task
            by_task: dict[int, list] = {}
            task_order: list[int] = []
            for loc, length, qname, tid in realigned_ranges:
                if tid not in by_task:
                    by_task[tid] = []
                    task_order.append(tid)
                by_task[tid].append((loc, length, qname))
            for tid in task_order:
                for loc, length, qname in sorted(by_task[tid], key=lambda r: r[:2]):
                    if dbg:
                        fh.write(f"{loc}\t{length}\t{tid}\t{qname}\n")
                    else:
                        fh.write(f"{loc}\t{length}\n")
        else:
            fh.write("Location\tLength\tQNAME\n" if dbg else "Location\tLength\n")
            seen: dict[tuple[int, int], str] = {}
            for loc, length, qname, _tid in sorted(
                realigned_ranges, key=lambda r: (r[3], r[0], r[1])
            ):
                if (loc, length) not in seen:
                    seen[(loc, length)] = qname
            stats.written_range_count = len(seen)
            for (loc, length), qname in sorted(seen.items()):
                if dbg:
                    fh.write(f"{loc}\t{length}\t{qname}\n")
                else:
                    fh.write(f"{loc}\t{length}\n")
