"""Whole calls of the port's CLI entry, in this process, with the output
drained by the consumer process.

A call is ``panvc3_tpu_torch.cli.main.main(argv)`` with the argv of the
configuration's workflow rule, what ``panvc3_torch_project_alignments``
runs.  Its standard error is caught at the descriptor (the program's
threads write there), read for the ``[fastlane prof]`` line,
and passed on.  The program's counters (kernel launches, the aggregate
dispatch diagnostics) are process-wide, so a call's are read as deltas.
"""

from __future__ import annotations

import contextlib
import json
import os
import pathlib
import re
import subprocess
import sys
import time

PROF = re.compile(r"\[fastlane prof\] (.*) \(sum [0-9.]+s\)")
STAGE = re.compile(r"([a-z_0-9]+) ([0-9.]+)s")


def prof_stages(text: str) -> dict[str, float] | None:
    """The per-stage seconds of a call's ``[fastlane prof]`` line, or None."""
    hit = PROF.search(text)
    if not hit:
        return None
    return {k: float(v) for k, v in STAGE.findall(hit.group(1))}


@contextlib.contextmanager
def caught_stderr(path: pathlib.Path):
    """Descriptor 2 sent to ``path`` for the block; yields the path.  What
    was caught is written to standard error afterwards, also where the
    block raised."""
    sys.stderr.flush()
    saved = os.dup(2)
    try:
        with open(path, "wb") as fh:
            os.dup2(fh.fileno(), 2)
            try:
                yield path
            finally:
                sys.stderr.flush()
                os.dup2(saved, 2)
    finally:
        os.close(saved)
        sys.stderr.write(path.read_text(errors="replace"))
        sys.stderr.flush()


class Consumer:
    """The consumer process (``consumer.py``) and its protocol."""

    def __init__(self, work: pathlib.Path, line_starts, sample):
        import numpy as np

        self.fifo = work / "projected.sam"
        os.mkfifo(self.fifo)
        names, samples = work / "line-starts.npy", work / "sample.npy"
        np.save(names, line_starts)
        np.save(samples, sample)
        self.kept = work / "kept.json"
        script = pathlib.Path(__file__).with_name("consumer.py")
        self.proc = subprocess.Popen(
            [sys.executable, str(script), str(self.fifo), str(names), str(samples), str(self.kept)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
        )
        self.calls = 0

    def announce(self) -> int:
        call = self.calls
        self.calls += 1
        self.proc.stdin.write(f"{call}\n")
        self.proc.stdin.flush()
        return call

    def answer(self) -> dict:
        line = self.proc.stdout.readline()
        if not line:
            raise RuntimeError("the consumer ended before answering")
        return json.loads(line)

    def stop(self) -> list[str]:
        """Ends the consumer, which writes the kept lines to ``self.kept``;
        returns the forbidden modules it loaded."""
        self.proc.stdin.write("stop\n")
        self.proc.stdin.close()
        last = json.loads(self.proc.stdout.readline())
        self.proc.wait(timeout=60)
        return last["forbidden_modules"]

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=60)


class Tool:
    """Runs calls and records each: seconds, records, prof stages and the
    counters' deltas."""

    def __init__(self, cli_main, template: list[str], fill: dict, consumer: Consumer,
                 work: pathlib.Path, sync, counters):
        """``template`` is the configuration's argv, each word filled by
        ``fill`` and, per call, ``alignments`` and ``output``."""
        self.cli_main, self.template, self.fill = cli_main, template, fill
        self.consumer, self.work = consumer, work
        self.sync, self.counters = sync, counters

    def call(self, alignments: pathlib.Path, records: int, around=contextlib.nullcontext) -> dict:
        fill = {**self.fill, "alignments": alignments, "output": self.consumer.fifo}
        argv = [a.format_map(fill) for a in self.template]
        before = self.counters()
        n = self.consumer.announce()
        with caught_stderr(self.work / f"call-{n}.err") as err:
            t0 = time.perf_counter()
            try:
                with around():
                    rc = self.cli_main(argv)
                    self.sync()
            except BaseException:
                self.consumer.kill()
                raise
            if rc != 0:
                # the tool may leave the FIFO open: the consumer would
                # wait for its end for ever
                self.consumer.kill()
                raise RuntimeError(f"project_alignments exited {rc} on {alignments}")
            answer = self.consumer.answer()
            seconds = time.perf_counter() - t0
        text = err.read_text(errors="replace")
        err.unlink()
        after = self.counters()
        return {
            "rc": rc, "seconds": seconds, "expected": records, "records": answer["records"],
            "out_of_order": answer["out_of_order"], "prof": prof_stages(text),
            "counters": {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)},
        }
