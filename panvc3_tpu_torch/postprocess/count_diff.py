"""Diff two count_supporting_reads V/R streams by variant id (copy of
``panvc3_tpu.postprocess.count_diff``).

Own implementation of the behaviour of the reference's ``count_diff.py``
(count-supporting-reads/count_diff.py:8-40)."""

from __future__ import annotations

import sys
from dataclasses import dataclass, field


@dataclass
class SupportRecord:
    pos: int
    var_id: str
    ref: str
    alt: str
    support: list[tuple[str, int]] = field(default_factory=list)

    def key(self):
        return (self.var_id, self.ref, self.alt, self.support)

    def support_string(self) -> str:
        return " ".join(f"{s}:{c}" for s, c in self.support)


def parse_stream(fp) -> list[SupportRecord]:
    records: list[SupportRecord] = []
    cur: SupportRecord | None = None
    for raw in fp:
        fields = raw.rstrip("\n").split("\t")
        if fields[0] == "V":
            if cur is not None:
                cur.support.sort()
                records.append(cur)
            cur = SupportRecord(int(fields[2]), fields[3], fields[4], fields[5])
        elif fields[0] == "R" and cur is not None:
            cur.support.append((fields[2], int(fields[1])))
    if cur is not None:
        cur.support.sort()
        records.append(cur)
    records.sort(key=lambda r: r.var_id)
    return records


def diff_streams(lhs_fp, rhs_fp, out=sys.stdout) -> int:
    """Print differing variants; returns the number of differences."""
    lhs = parse_stream(lhs_fp)
    rhs = parse_stream(rhs_fp)

    li = ri = 0
    diffs: list[tuple[SupportRecord | None, SupportRecord | None]] = []
    while li < len(lhs) and ri < len(rhs):
        a, b = lhs[li], rhs[ri]
        if a.var_id < b.var_id:
            diffs.append((a, None))
            li += 1
        elif a.var_id > b.var_id:
            diffs.append((None, b))
            ri += 1
        else:
            if a.key() != b.key():
                diffs.append((a, b))
            li += 1
            ri += 1
    diffs.extend((a, None) for a in lhs[li:])
    diffs.extend((None, b) for b in rhs[ri:])

    diffs.sort(key=lambda pair: (pair[0] or pair[1]).pos)
    for a, b in diffs:
        if a is None:
            out.write(f"{b.var_id}\t\t{b.ref}\t\t{b.alt}\t\t{b.support_string()}\n")
        elif b is None:
            out.write(f"{a.var_id}\t{a.ref}\t\t{a.alt}\t\t{a.support_string()}\t\n")
        else:
            out.write(
                f"{a.var_id}\t{a.ref}\t{b.ref}\t{a.alt}\t{b.alt}\t"
                f"{a.support_string()}\t{b.support_string()}\n"
            )
    return len(diffs)


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="Compare two sets of supporting reads")
    p.add_argument("lhs", type=argparse.FileType("r"))
    p.add_argument("rhs", type=argparse.FileType("r"))
    args = p.parse_args(argv)
    diff_streams(args.lhs, args.rhs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
