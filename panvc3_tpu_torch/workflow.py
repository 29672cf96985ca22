"""Dependency-free driver for the toy end-to-end pipeline on the port.

A copy of ``workflows/run_test_workflow.py`` that imports only
``panvc3_tpu_torch`` and takes ``--device``.  It runs the DAG of
``workflows/test-workflow/Snakefile`` without snakemake, bowtie2 or
samtools: the aligner stage reads a founder-aligned SAM, or synthesises
founder-aligned reads from the MSA when none is given, then

    index_msa -> project_alignments -> (QNAME sort) -> recalculate_mapq

In a checkout, ``--data`` defaults to the bundled reference data
(``workflows/test-workflow/data``); an installed package does not carry
it, and is given ``--data``:

    python -m panvc3_tpu_torch.workflow --workdir /tmp/wf [--data DIR] [--device cuda|cpu]

``project_alignments`` runs the device engine on ``cuda`` unless told
otherwise, as the port's CLI does; ``cuda`` raises without a card before
any stage runs.

The port's Snakefiles (``panvc3_tpu_torch/workflows/``) run the same
stages through the installed ``panvc3_torch_*`` commands.
"""

from __future__ import annotations

import argparse
import bz2
import pathlib
import sys

from . import checkout_root


def main(argv=None) -> int:
    root = checkout_root()
    data_default = root / "workflows/test-workflow/data" if root is not None else None
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workdir", required=True)
    p.add_argument(
        "--data", default=data_default,
        help="the bundled test-workflow data (default: a checkout's "
        "workflows/test-workflow/data)",
    )
    p.add_argument("--alignments", help="founder-aligned SAM/BAM input")
    p.add_argument("--n-reads", type=int, default=1000)
    p.add_argument("--engine", choices=("host", "device"), default="device")
    p.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="torch device of project_alignments: cuda (the default; raises "
        "without a card) or cpu (the plain PyTorch versions)",
    )
    args = p.parse_args(argv)
    if args.data is None:
        p.error(
            "--data is required: the package is not in a checkout, and an "
            "install carries no workflow data (pass a checkout's "
            "workflows/test-workflow/data)"
        )

    from . import resolve_device
    from .io.sam import SamReader, SamWriter
    from .pipeline.index_msa import build_index_from_tsv
    from .pipeline.project_alignments import ProjectConfig, TagSpec, run_project_alignments
    from .pipeline.recalculate_mapq import run_recalculate_mapq
    from .synth import workflow_reads_sam

    device = resolve_device(args.device)
    work = pathlib.Path(args.workdir)
    work.mkdir(parents=True, exist_ok=True)
    data = pathlib.Path(args.data)

    # 1. index_msa
    tsv = work / "input.tsv"
    rows = []
    for line in (data / "index-input/input.tsv").read_text().splitlines():
        chr_id, seq_id, rel = line.split("\t")
        rows.append(f"{chr_id}\t{seq_id}\t{data / rel}")
    tsv.write_text("\n".join(rows) + "\n")
    index_path = work / "msa-index.npz"
    fasta_path = work / "unaligned.fa"
    with open(fasta_path, "wb") as fh:
        index = build_index_from_tsv(str(tsv), pipe_command="bzip2 -d -c", fasta_out=fh)
    index.save(str(index_path))
    print(f"[workflow] MSA index built: {index_path}", file=sys.stderr)

    # 2. founder alignments (external aligner stand-in)
    if args.alignments:
        aln_path = pathlib.Path(args.alignments)
    else:
        founders = {}
        for line in (data / "index-input/input.tsv").read_text().splitlines():
            chr_id, seq_id, rel = line.split("\t")
            founders[seq_id] = bz2.open(data / rel, "rb").read()
        aln_path = work / "founder.sam"
        aln_path.write_text(workflow_reads_sam(founders, n_reads=args.n_reads))
        print(f"[workflow] synthesised {args.n_reads} founder reads", file=sys.stderr)

    # 3. project
    projected = work / "alignments.projected.sam"
    cfg = ProjectConfig(
        msa_index_path=str(index_path),
        reference_path=str(data / "genome/genome.fa.gz"),
        reference_msa_id="REF",
        ref_id_separator="/",
        tags=TagSpec(rec_idx="XI"),
        preserve_tags=("XS", "YS"),
        engine=args.engine,
    )
    stats = run_project_alignments(str(aln_path), str(projected), cfg, device=device)
    print(f"[workflow] projected {stats.matched_reads} reads", file=sys.stderr)

    # 4. QNAME sort (samtools sort -n stand-in)
    reader = SamReader(str(projected))
    records = list(reader)
    records.sort(key=lambda r: r.qname)
    qsorted = work / "alignments.projected.qname-sorted.sam"
    w = SamWriter(str(qsorted), reader.header)
    for rec in records:
        w.write(rec)
    w.close()

    # 5. recalculate MAPQ
    final = work / "alignments.mapq-recalculated.sam"
    mstats = run_recalculate_mapq(str(qsorted), str(final))
    print(
        f"[workflow] MAPQ recalculated for {mstats.total_alignments} alignments "
        f"-> {final}",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
