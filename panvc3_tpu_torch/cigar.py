"""CIGAR utilities (copy of ``panvc3_tpu.cigar``, trimmed to what the port
calls).

A CIGAR is a ``list[(count, op_char)]``.  Op codes follow the BAM encoding
("MIDNSHP=X" -> 0..8).
"""

from __future__ import annotations

import re

import numpy as np

from .native import get_native

OPS = "MIDNSHP=X"
OP_TO_CODE = {op: i for i, op in enumerate(OPS)}
CODE_TO_OP = {i: op for i, op in enumerate(OPS)}

M, I, D, N, S, H, P, EQ, X = range(9)

# Which ops consume query / reference (SAMv1 table).
CONSUMES_QUERY = frozenset("MIS=X")
CONSUMES_REF = frozenset("MDN=X")

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


def cigar_eq(lhs: Cigar, rhs: Cigar, count_padding: bool = False) -> bool:
    """Order-insensitive equality over indel runs.

    Two CIGARs are equal iff their non-indel operations match exactly and
    every maximal run of I/D (optionally P) operations has the same total
    insertion and deletion counts.
    """

    def count_indels(seq: Cigar, idx: int):
        ins = dels = 0
        while idx < len(seq):
            n, op = seq[idx]
            if op == "I":
                ins += n
                idx += 1
            elif op == "D":
                dels += n
                idx += 1
            elif count_padding and op == "P":
                idx += 1
            else:
                break
        return idx, ins, dels

    li = ri = 0
    while True:
        li, lins, ldel = count_indels(lhs, li)
        ri, rins, rdel = count_indels(rhs, ri)
        if (lins, ldel) != (rins, rdel):
            return False
        l_has = li < len(lhs)
        r_has = ri < len(rhs)
        if not l_has and not r_has:
            return True
        if l_has != r_has:
            return False
        if lhs[li] != rhs[ri]:
            return False
        li += 1
        ri += 1


def cigar_query_length(cigar: Cigar) -> int:
    return sum(n for n, op in cigar if op in CONSUMES_QUERY)


def cigar_ref_length(cigar: Cigar) -> int:
    return sum(n for n, op in cigar if op in CONSUMES_REF)


# -- numpy codecs -------------------------------------------------------------

def cigar_to_arrays(cigar: Cigar, pad_to: int | None = None):
    """Encode a CIGAR as (counts:int32[K], opcodes:int8[K]) arrays.

    If ``pad_to`` is given, pads with zero counts / op code 0.
    """
    k = len(cigar)
    n = pad_to if pad_to is not None else k
    if k > n:
        raise ValueError(f"CIGAR with {k} ops does not fit in {n}")
    counts = np.zeros(n, dtype=np.int32)
    codes = np.zeros(n, dtype=np.int8)
    for i, (cnt, op) in enumerate(cigar):
        counts[i] = cnt
        codes[i] = OP_TO_CODE[op]
    return counts, codes


def arrays_to_cigar(counts, codes) -> Cigar:
    """Decode (counts, opcodes) arrays into a collapsed CIGAR list."""
    out: Cigar = []
    for cnt, code in zip(np.asarray(counts).tolist(), np.asarray(codes).tolist()):
        if cnt <= 0:
            continue
        op = CODE_TO_OP[int(code)]
        if out and out[-1][1] == op:
            out[-1] = (out[-1][0] + int(cnt), op)
        else:
            out.append((int(cnt), op))
    return out
