"""CIGAR utilities (copy of ``panvc3_tpu.cigar``, trimmed to what the port
calls).

A CIGAR is a ``list[(count, op_char)]``.  Op codes follow the BAM encoding
("MIDNSHP=X" -> 0..8).
"""

from __future__ import annotations

import re

from .native import get_native

OPS = "MIDNSHP=X"
OP_TO_CODE = {op: i for i, op in enumerate(OPS)}
CODE_TO_OP = {i: op for i, op in enumerate(OPS)}

M, I, D, N, S, H, P, EQ, X = range(9)

# Which ops consume the query (SAMv1 table).
CONSUMES_QUERY = frozenset("MIS=X")

_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")

Cigar = list  # list[tuple[int, str]]


def parse_cigar(text: str) -> Cigar:
    """Parse a CIGAR string into a list of (count, op_char)."""
    if text == "*" or not text:
        return []
    out = []
    pos = 0
    for m in _CIGAR_RE.finditer(text):
        if m.start() != pos:
            raise ValueError(f"invalid CIGAR: {text!r}")
        out.append((int(m.group(1)), m.group(2)))
        pos = m.end()
    if pos != len(text):
        raise ValueError(f"invalid CIGAR: {text!r}")
    return out


def format_cigar(cigar: Cigar) -> str:
    if not cigar:
        return "*"
    return "".join(f"{n}{op}" for n, op in cigar)


def collapse_cigar(cigar: Cigar) -> Cigar:
    """Merge adjacent operations of the same type, dropping zero counts
    (in C: the native extension's ``collapse_cigar``)."""
    return get_native().collapse_cigar(cigar)


class CigarBuffer:
    """Run-length-merging append buffer."""

    def __init__(self) -> None:
        self._ops: Cigar = []
        self._cur_op: str | None = None
        self._cur_n = 0

    def push_back(self, op: str, count: int = 1) -> None:
        if count == 0:
            return
        if op == self._cur_op:
            self._cur_n += count
        else:
            if self._cur_op is not None and self._cur_n:
                self._ops.append((self._cur_n, self._cur_op))
            self._cur_op = op
            self._cur_n = count

    def finish(self) -> None:
        if self._cur_op is not None and self._cur_n:
            self._ops.append((self._cur_n, self._cur_op))
        self._cur_op = None
        self._cur_n = 0

    def clear(self) -> None:
        self._ops = []
        self._cur_op = None
        self._cur_n = 0

    @property
    def operations(self) -> Cigar:
        return self._ops


def cigar_query_length(cigar: Cigar) -> int:
    return sum(n for n, op in cigar if op in CONSUMES_QUERY)
