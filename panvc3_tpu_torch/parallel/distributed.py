"""Multi-process execution helpers (copy of
``panvc3_tpu.parallel.distributed``; ``initialise`` sets up
``torch.distributed`` where the JAX version sets up ``jax.distributed``).

Scaling the projection pipeline across processes is data-parallel over
reads:

- each process parses its own slice of the input (byte-range splits of the
  SAM/BAM, aligned to record boundaries),
- the MSA index and reference bytes are replicated per process,
- the mesh's ``dp`` axis spans all processes' shards; per-batch execution
  is that of one process, and the only collectives are the v4 engine's
  exchange of per-shard run totals and the reduction of its flags,
- downstream MAPQ recalculation requires whole QNAME groups on one shard:
  :func:`qname_shard` routes reads by QNAME hash so groups stay
  process-local.
"""

from __future__ import annotations

import hashlib


def initialise(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, device: str = "cuda") -> None:
    """Join ``torch.distributed``'s default process group when running as
    one of several processes (a no-op for one): ``nccl`` for a mesh of
    CUDA devices, ``gloo`` for the CPU, rendezvous at
    ``tcp://<coordinator_address>`` (``host:port``)."""
    if num_processes is None or num_processes <= 1:
        return
    import torch.distributed as dist

    dist.init_process_group(
        backend="nccl" if str(device).startswith("cuda") else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
    )


def qname_shard(qname: str, n_shards: int) -> int:
    """Stable shard id for a read name.

    Uses a fixed hash (not Python's randomized ``hash``) so every process
    routes identically.  All records of a template share a QNAME, so MAPQ
    groups and mate pairs land on the same shard.
    """
    h = hashlib.blake2b(qname.encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") % n_shards


def split_records_by_qname(records, n_shards: int):
    """Partition an iterable of SamRecords into n_shards lists, QNAME-local."""
    shards = [[] for _ in range(n_shards)]
    for rec in records:
        shards[qname_shard(rec.qname, n_shards)].append(rec)
    return shards


def byte_ranges(total_size: int, n_shards: int) -> list[tuple[int, int]]:
    """Even byte-range splits for per-process input reading; the reader
    must scan forward to the first record boundary inside its range."""
    step = total_size // n_shards
    ranges = []
    for i in range(n_shards):
        start = i * step
        end = total_size if i == n_shards - 1 else (i + 1) * step
        ranges.append((start, end))
    return ranges


def split_chromosomes(chr_ids, n_shards: int) -> list[list[str]]:
    """Deterministic round-robin assignment of sorted chromosome ids to
    shards.  Every process computes the same assignment without
    communication; pair with MsaIndex.load(shard=(k, n)) and
    split_alignments_by_reference-style record routing so each process
    holds only its chromosomes' bitvectors."""
    if n_shards <= 0:
        raise ValueError("n_shards must be positive")
    shards: list[list[str]] = [[] for _ in range(n_shards)]
    for i, chr_id in enumerate(sorted(chr_ids)):
        shards[i % n_shards].append(chr_id)
    return shards


def chr_shard(chr_id: str, chr_ids, n_shards: int) -> int:
    """The shard that holds chr_id under split_chromosomes."""
    for k, ids in enumerate(split_chromosomes(chr_ids, n_shards)):
        if chr_id in ids:
            return k
    raise KeyError(f"chromosome {chr_id!r} not in the id list")


def split_records_by_chr(records, ref_chr_ids, chr_ids, n_shards: int):
    """Group records by the shard owning their reference's chromosome.

    ``ref_chr_ids`` maps a record's ref_id to its chromosome id (the chr
    part of the founder RNAME).  Returns a list of n_shards record
    lists, preserving input order within each shard."""
    assignment = {}
    for k, ids in enumerate(split_chromosomes(chr_ids, n_shards)):
        for c in ids:
            assignment[c] = k
    shards = [[] for _ in range(n_shards)]
    for rec in records:
        shards[assignment[ref_chr_ids[rec.ref_id]]].append(rec)
    return shards
