"""A cell's inputs, made in set-up from the seed, as the workflows hand
them to ``project_alignments``.

- The MSA index, built by the port's own ``index_msa --build-index`` from
  one aligned row per sequence, as the workflows' ``index_msa`` rule
  builds it.  The rows reach it through FIFOs, so they are never written
  to disk.
- The reference FASTA (the reference row without gaps, 60 bases a line),
  gzipped as the workflows' ``genome.fa.gz``, and the output order file
  (``--reference-order-input``).
- The alignments: the pool as BAM, its record blocks repeated to make a
  call's input; one pass of the pool for the warm-up call; one record for
  the calls that time the fixed cost of a call.
- For the consumer: the start of each record's line in input order, and
  the sampled positions whose lines the plain reference judges.
"""

from __future__ import annotations

import concurrent.futures as cf
import gzip
import os
import pathlib
import threading
import time

import numpy as np

from . import bam, msa, traffic

# lines kept for the plain reference: this many at positions drawn
# evenly from the call, and this many more among the records whose
# projection the tool realigns
SAMPLE_EVEN = 2048
SAMPLE_REALIGNED = 2048
WORKERS = 8


def _feed(path: pathlib.Path, data: bytes) -> None:
    with open(path, "wb") as fh:
        fh.write(data)


def _gzip(data: bytes, parts: int = WORKERS) -> bytes:
    """gzip members of ``data``'s parts, compressed side by side (a gzip
    stream may hold several members)."""
    step = -(-len(data) // parts)
    with cf.ThreadPoolExecutor(parts) as pool:
        return b"".join(pool.map(
            lambda i: gzip.compress(data[i:i + step], compresslevel=1, mtime=0),
            range(0, len(data), step),
        ))


def fasta_lines(name: str, seq: np.ndarray, width: int) -> bytes:
    """FASTA text of one sequence, ``width`` bases a line."""
    n = len(seq)
    rows = -(-n // width)
    padded = np.zeros(rows * width, np.uint8)
    padded[:n] = seq
    grid = np.full((rows, width + 1), 10, np.uint8)
    grid[:, :width] = padded.reshape(rows, width)
    body = grid.reshape(-1)
    last = n - (rows - 1) * width
    body = body[: (rows - 1) * (width + 1) + last]
    return f">{name}\n".encode() + body.tobytes() + b"\n"


class CellInputs:
    """Builds every input file of one run in ``work``.  ``bench`` is the
    benchmark's folder, which holds the configuration's MSA pattern and
    the mix's files."""

    def __init__(self, work: pathlib.Path, seed: int, config: dict, mix: dict, cli_main,
                 bench: pathlib.Path, one_record: bool = False):
        self.work = work
        self.config = config
        self.seconds: dict[str, float] = {}
        t0 = time.perf_counter()
        ids = msa.row_ids(config)
        chrom = config["chromosome"]
        sep = config["ref_id_separator"]
        names = [f"{chrom}{sep}{sid}" for sid in ids]
        made = msa.Msa(seed, config, bench / "configs")
        self.seconds["rows"] = time.perf_counter() - t0
        self.index = self._index(ids, made, cli_main)
        self.seconds["index_msa"] = time.perf_counter() - t0 - sum(self.seconds.values())

        self.fasta = work / "genome.fa.gz"
        self.fasta.write_bytes(_gzip(fasta_lines(chrom, made.stripped_row(0), int(config["fasta_line_width"]))))
        self.order = work / "sequence-output-order.txt"
        self.order.write_text(f"{chrom}\n")
        self.seconds["fasta"] = time.perf_counter() - t0 - sum(self.seconds.values())

        rows = traffic.Rows(made)
        lengths = rows.lengths
        self.pool = traffic.make_pool(seed, mix, rows, int(config["aligner_k"]), bench / "traffic")
        del rows, made
        self.seconds["records"] = time.perf_counter() - t0 - sum(self.seconds.values())
        self.pool_records = len(self.pool["row"])
        per_call = int(config["records_per_call"])
        if per_call % self.pool_records:
            raise ValueError("records_per_call must be a whole number of pool passes")
        self.records_per_call = per_call
        header = "@HD\tVN:1.6\n" + "".join(
            f"@SQ\tSN:{name}\tLN:{n}\n" for name, n in zip(names, lengths.tolist())
        )
        head = bam.header_bytes(header, list(zip(names, lengths.tolist())))
        records = bam.encode_records(self.pool, int(mix["mapq"]))
        self.alignments = work / "alignments.sorted.bam"
        self.bytes_written = bam.write_bam(self.alignments, head, records, per_call // self.pool_records)
        self.one_pass = work / "one-pass.bam"
        self.bytes_written += bam.write_bam(self.one_pass, head, records, 1)
        self.one_record = None
        if one_record:
            self.one_record = work / "one-record.bam"
            first = int(np.frombuffer(records[:4], "<i4")[0]) + 4
            self.bytes_written += bam.write_bam(self.one_record, head, records[:first], 1)
        self.line_starts = self._line_starts()
        self.sample = sample_positions(seed, self.pool, per_call)
        self.seconds["bam"] = time.perf_counter() - t0 - sum(self.seconds.values())

    def _index(self, ids, made, cli_main) -> pathlib.Path:
        tsv_lines, feeders = [], []
        for r, sid in enumerate(ids):
            fifo = self.work / f"row.{sid}.txt"
            os.mkfifo(fifo)
            tsv_lines.append(f"{self.config['chromosome']}\t{sid}\t{fifo}")
            data = made.aligned_row(r).tobytes() + b"\n"
            feeder = threading.Thread(target=_feed, args=(fifo, data), daemon=True)
            feeder.start()
            feeders.append(feeder)
        tsv = self.work / "input.tsv"
        tsv.write_text("\n".join(tsv_lines) + "\n")
        index = self.work / "msa-index.npz"
        rc = cli_main(["index_msa", "--build-index", f"--sequence-inputs={tsv}",
                       f"--msa-index-output={index}"])
        if rc != 0:
            raise RuntimeError(f"index_msa exited {rc}")
        for feeder in feeders:
            feeder.join()
        return index

    def _line_starts(self) -> np.ndarray:
        """(pool, width) uint8: QNAME, tab, FLAG's first byte of each record."""
        width = len(str(int(self.pool["pair"].max())))
        names = [f"p{int(p):0{width}d}\t{int(f)}"[: width + 3] for p, f in
                 zip(self.pool["pair"].tolist(), self.pool["flag"].tolist())]
        return np.frombuffer("".join(names).encode(), np.uint8).reshape(len(names), width + 3)


def sample_positions(seed: int, pool: dict, records_per_call: int) -> np.ndarray:
    """Sorted positions in a call whose lines the reference judges: drawn
    evenly, among the records whose projection the tool realigns, and the
    first and last record."""
    rng = np.random.default_rng([seed, 3])
    n, p = records_per_call, len(pool["pos"])
    even = rng.choice(n, min(SAMPLE_EVEN, n), replace=False)
    realigned = np.flatnonzero(pool["realigns"])
    pick = rng.choice(realigned, min(SAMPLE_REALIGNED, len(realigned)), replace=False)
    passes = rng.integers(0, n // p, len(pick))
    return np.unique(np.concatenate([even, passes * p + pick, [0, n - 1]])).astype(np.int64)
