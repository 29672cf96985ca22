"""The ``split_alignments_by_reference`` tool.

Copy of ``panvc3_tpu.pipeline.split_alignments``.
The C host extension always exists in the port, so the raw lane is
gated by ``PANVC3_SPLIT_FAST`` alone.

Reimplements split-alignments-by-reference/main.cc: route
records to per-reference-name (or prefix; checked prefix-free) BAM files
named ``<basename><name>.bam``, with optional RNAME rewriting from a
tab-separated map; plus a listing mode that prints reference names
(optionally only those with records)."""

from __future__ import annotations

import bisect
import os
import sys
from dataclasses import dataclass

from ..io.sam import SamHeader, SamReader, SamWriter


@dataclass
class ReferenceNameRecord:
    reference_name: str
    new_reference_name: str = ""
    matches: int = 0


def read_reference_names(
    path_or_fh, prefixes: bool, rewrite: bool
) -> list[ReferenceNameRecord]:
    records: list[ReferenceNameRecord] = []
    fh = open(path_or_fh) if isinstance(path_or_fh, str) else path_or_fh
    for lineno, line in enumerate(fh, 1):
        line = line.rstrip("\n")
        if not line:
            continue
        if rewrite:
            if "\t" not in line:
                raise ValueError(f"unable to parse reference name on line {lineno}")
            name, new_name = line.split("\t", 1)
            records.append(ReferenceNameRecord(name, new_name))
        else:
            records.append(ReferenceNameRecord(line))
    if not records:
        raise ValueError("the reference name list was empty")
    records.sort(key=lambda r: r.reference_name)
    for a, b in zip(records, records[1:]):
        if prefixes:
            if b.reference_name.startswith(a.reference_name):
                raise ValueError(
                    f"contig prefixes must be prefix-free but "
                    f"{a.reference_name!r} is a prefix of {b.reference_name!r}"
                )
        elif a.reference_name == b.reference_name:
            raise ValueError(f"duplicate contig name: {a.reference_name}")
    return records


def run_split_alignments(
    input_path_or_fh,
    reference_names_path_or_fh,
    *,
    basename: str = "",
    prefixes: bool = False,
    rewrite: bool = False,
    report_unmatched: bool = False,
    out=sys.stdout,
) -> dict[str, int]:
    """Route records to <basename><name>.bam files; returns match counts."""
    records = read_reference_names(reference_names_path_or_fh, prefixes, rewrite)
    names = [r.reference_name for r in records]

    reader = SamReader(input_path_or_fh)
    header = reader.header

    if rewrite:
        out_header = SamHeader()
        out_header.ref_lengths = list(header.ref_lengths)
        rewrite_map = {r.reference_name: r.new_reference_name for r in records}
        out_header.ref_names = []
        for name in header.ref_names:
            if name not in rewrite_map:
                raise ValueError(f"no entry for reference ID {name!r}")
            out_header.ref_names.append(rewrite_map[name])
        out_header.lines = [l for l in header.lines if not l.startswith("@SQ")]
        sq = [
            f"@SQ\tSN:{n}\tLN:{l}"
            for n, l in zip(out_header.ref_names, out_header.ref_lengths)
        ]
        # keep @SQ right after @HD like the input ordering convention
        hd = [l for l in out_header.lines if l.startswith("@HD")]
        rest = [l for l in out_header.lines if not l.startswith("@HD")]
        out_header.lines = hd + sq + rest
    else:
        out_header = header

    for r in records:
        if "/" in r.reference_name:
            raise ValueError(
                f"reference name {r.reference_name!r} contains '/' and "
                f"would produce an invalid output filename "
                f"({basename}{r.reference_name}.bam); use names/prefixes "
                "without path separators"
            )
    writers = [
        SamWriter(f"{basename}{r.reference_name}.bam", out_header, bam=True)
        for r in records
    ]

    ref_id_missing = 0
    no_match = 0

    # Raw fast lane: route raw text lines by RNAME and bulk-convert each
    # writer's buffer to BAM in C (sam_text_to_bam + the parallel BGZF
    # codec); the slot decision per header name is precomputed once.
    if os.environ.get("PANVC3_SPLIT_FAST") != "0":
        route: dict[bytes, int] = {}
        for name in header.ref_names:
            i = bisect.bisect_right(names, name)
            slot = -1
            if i > 0:
                cand = records[i - 1]
                if (prefixes and name.startswith(cand.reference_name)) or (
                    not prefixes and name == cand.reference_name
                ):
                    slot = i - 1
            route[name.encode()] = slot
        in_names = header.ref_names
        bufs: list[list[bytes]] = [[] for _ in records]
        buffered = 0

        def flush() -> None:
            nonlocal buffered
            for s, lst in enumerate(bufs):
                if lst:
                    writers[s].write_raw(b"".join(lst), names=in_names)
                    lst.clear()
            buffered = 0

        for block in reader.raw_record_line_blocks():
            for ln in block:
                a = ln.find(b"\t")
                b = ln.find(b"\t", a + 1)
                c = ln.find(b"\t", b + 1)
                name_b = ln[b + 1:c]
                if name_b == b"*":
                    ref_id_missing += 1
                    continue
                slot = route.get(name_b)
                if slot is None:
                    raise ValueError(f"unknown reference {name_b.decode()!r}")
                if slot < 0:
                    no_match += 1
                    if report_unmatched:
                        print(
                            "WARNING: No reference name found that would "
                            f"match '{name_b.decode()}'.",
                            file=sys.stderr,
                        )
                    continue
                records[slot].matches += 1
                if not ln.endswith(b"\n"):
                    ln += b"\n"
                bufs[slot].append(ln)
                buffered += 1
            if buffered >= 16384:
                flush()
        flush()
    else:
        for rec in reader:
            if rec.ref_id < 0:
                ref_id_missing += 1
                continue
            name = header.ref_names[rec.ref_id]
            i = bisect.bisect_right(names, name)
            matched = False
            if i > 0:
                cand = records[i - 1]
                if (prefixes and name.startswith(cand.reference_name)) or (
                    not prefixes and name == cand.reference_name
                ):
                    cand.matches += 1
                    writers[i - 1].write(rec)
                    matched = True
            if not matched:
                no_match += 1
                if report_unmatched:
                    print(
                        f"WARNING: No reference name found that would match '{name}'.",
                        file=sys.stderr,
                    )

    for w in writers:
        w.close()
    for r in records:
        print(f"{r.reference_name}\t{r.matches}", file=out)
    print(f"Reference ID missing\t{ref_id_missing}", file=out)
    print(f"No matching reference ID\t{no_match}", file=out)
    return {r.reference_name: r.matches for r in records}


def run_list_reference_names(
    input_path_or_fh, *, only_used: bool = False, out=sys.stdout
) -> list[str]:
    """-R mode: list reference names, optionally only those with records
    (main.cc:352-377)."""
    reader = SamReader(input_path_or_fh)
    names = reader.header.ref_names
    if not only_used:
        for n in names:
            print(n, file=out)
        return list(names)
    used = [False] * len(names)
    for rec in reader:
        if rec.ref_id >= 0:
            used[rec.ref_id] = True
    result = [n for n, u in zip(names, used) if u]
    for n in result:
        print(n, file=out)
    return result
