"""project_alignments on the port: the device engine's fast lane.

Counterpart of ``panvc3_tpu.pipeline.project_alignments
.run_project_alignments``.  Header processing, sequence-entry tables, the
contig buffer store, SAM I/O and the realigned-ranges TSV are the
original's, imported; the device engine runs the port's fast lane
(``pipeline/fastlane.run_fast``) on an explicit ``torch.device``.
``engine="host"`` runs ``panvc3_tpu``'s host object path, which uses no
JAX.  Configurations the port does not cover raise NotImplementedError.
"""

from __future__ import annotations

from panvc3_tpu.io.fasta import FastaReader
from panvc3_tpu.io.sam import SamReader, SamWriter
from panvc3_tpu.msa_index import MsaIndex
from panvc3_tpu.pipeline import project_alignments as _reference
from panvc3_tpu.pipeline.project_alignments import (
    ProjectConfig,
    ProjectStatistics,
    TagSpec,
    _write_realigned_ranges,
    fill_sequence_entries,
    process_headers,
)
from panvc3_tpu.seqbuf import SequenceBufferStore

from .. import resolve_device

__all__ = ["ProjectConfig", "ProjectStatistics", "TagSpec", "run_project_alignments"]


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
    ``'cuda:N'`` or ``'cpu'`` (the plain PyTorch versions, for tests)."""
    dev = resolve_device(device)
    if cfg.engine == "host":
        return _reference.run_project_alignments(
            input_path_or_fh, output_path_or_fh, cfg, version=version
        )
    if cfg.engine != "device":
        raise ValueError(f"unknown engine {cfg.engine!r}")

    from ..ops.engine import BatchProjector
    from .fastlane import check_covered, run_fast

    reader = SamReader(input_path_or_fh)
    check_covered(cfg, reader.is_bam or cfg.output_bam)
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

    msa_index = MsaIndex.load(cfg.msa_index_path, shard=cfg.chr_shard)
    src_entries, dst_entries = fill_sequence_entries(
        msa_index,
        input_header.ref_names,
        len(out_header.ref_names),
        cfg.ref_id_separator,
        cfg.reference_msa_id,
        ref_id_mapping,
        allow_missing=cfg.chr_shard is not None,
    )

    fasta = FastaReader(cfg.reference_path)
    # bounded contig buffers: at most 4 unpinned contigs stay resident
    ref_seqs = SequenceBufferStore(
        lambda rid: fasta.read_sequence(out_header.ref_names[rid]), max_size=4
    )
    batch_engine = BatchProjector(
        src_entries,
        dst_entries,
        ref_id_mapping,
        cfg.gap_opening_cost,
        cfg.gap_extension_cost,
        device=dev,
    )
    writer = SamWriter(output_path_or_fh, out_header, bam=cfg.output_bam)
    stats = ProjectStatistics()
    realigned_ranges = [] if cfg.output_realigned_ranges_path else None
    run_fast(
        reader, writer, cfg, stats, batch_engine,
        input_header, out_header, src_entries, dst_entries,
        ref_id_mapping, ref_seqs, realigned_ranges,
    )
    writer.close()
    stats.realignment_time_ns += batch_engine.realignment_time_ns
    if cfg.output_realigned_ranges_path and realigned_ranges is not None:
        _write_realigned_ranges(cfg, realigned_ranges, stats)
    return stats
