"""The consumer of the tool's output: drains the FIFO the tool writes, as
``| gzip`` drains its standard output in the workflows, and keeps nothing
the size of the output.

Run as ``python3 consumer.py FIFO NAMES SAMPLE KEPT``.  ``NAMES`` is a
``.npy`` of the pool's records in input order, each row the bytes a line
has to start with (QNAME, a tab and the first byte of FLAG); ``SAMPLE``
a ``.npy`` of the sorted record positions whose lines are kept for the
plain reference.  Each line of standard input, ``CALL RECORDS``, announces
a call: the consumer opens the FIFO, reads until the tool closes it, and
answers with one JSON line: the records read and the lines that do not
start as the record at their position must (a record left out, written
twice or out of order).  ``stop`` ends it: it writes the header and the
kept lines to ``KEPT`` as JSON and prints the forbidden modules it has
loaded, which must be none.
"""

from __future__ import annotations

import fcntl
import json
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from harness.modules import PROGRAM, forbidden_loaded  # noqa: E402

READ = 1 << 23  # bytes gathered before a block of lines is checked
F_SETPIPE_SZ = 1031  # fcntl.F_SETPIPE_SZ, Linux


def widen(fd: int) -> None:
    """The FIFO's buffer at the largest size the system allows, so that the
    tool's writer waits on the consumer as seldom as it can."""
    try:
        with open("/proc/sys/fs/pipe-max-size") as fh:
            fcntl.fcntl(fd, F_SETPIPE_SZ, int(fh.read()))
    except OSError:
        pass


class Drain:
    """One call's output, read in blocks of whole lines."""

    def __init__(self, names: np.ndarray, sample: np.ndarray):
        self.names, self.sample = names, sample
        self.records = 0
        self.out_of_order = 0
        self.header: list[str] = []
        self.kept: list[tuple[int, str]] = []

    def lines(self, data: bytes) -> None:
        buf = np.frombuffer(data, np.uint8)
        ends = np.flatnonzero(buf == 10)
        starts = np.concatenate([[0], ends[:-1] + 1])
        first = 0
        if not self.records:
            while first < len(starts) and buf[starts[first]] == ord("@"):
                self.header.append(data[starts[first]:ends[first]].decode())
                first += 1
        starts, ends = starts[first:], ends[first:]
        k = len(starts)
        if not k:
            return
        at = self.records + np.arange(k)
        width = self.names.shape[1]
        got = buf[np.minimum(starts[:, None] + np.arange(width)[None, :], len(buf) - 1)]
        want = self.names[at % len(self.names)]
        self.out_of_order += int((got != want).any(axis=1).sum())
        lo, hi = np.searchsorted(self.sample, [self.records, self.records + k])
        for pos in self.sample[lo:hi].tolist():
            i = pos - self.records
            self.kept.append((pos, data[starts[i]:ends[i]].decode()))
        self.records += k


def drain(fifo: str, names: np.ndarray, sample: np.ndarray) -> Drain:
    out = Drain(names, sample)
    rest = b""
    with open(fifo, "rb", buffering=0) as fh:
        widen(fh.fileno())
        eof = False
        while not eof:
            parts, size = [rest], len(rest)
            while size < READ:
                block = fh.read(READ - size)
                if not block:
                    eof = True
                    break
                parts.append(block)
                size += len(block)
            data = b"".join(parts)
            cut = data.rfind(b"\n") + 1
            rest = data[cut:]
            if cut:
                out.lines(data[:cut])
    if rest:
        out.lines(rest + b"\n")
    return out


def main(argv: list[str]) -> int:
    fifo, names_path, sample_path, kept_path = argv
    names = np.load(names_path)
    sample = np.load(sample_path)
    header: list[str] = []
    kept: list[tuple[int, int, str]] = []
    for command in sys.stdin:
        words = command.split()
        if words == ["stop"]:
            break
        call = int(words[0])
        got = drain(fifo, names, sample)
        header = header or got.header
        kept += [(call, pos, line) for pos, line in got.kept]
        print(json.dumps({"call": call, "records": got.records,
                          "out_of_order": got.out_of_order}), flush=True)
    with open(kept_path, "w") as fh:
        json.dump({"header": header, "lines": kept}, fh)
    print(json.dumps({"forbidden_modules": forbidden_loaded((PROGRAM,))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
