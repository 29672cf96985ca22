"""The control of the ``-q`` cells' comparison, at a cell's own size.

    python3 portbench/control_q.py --workload CELL --seeds N [N ...] [--shifts 7 4 float64]

The plain reference of ``-q`` is put in the program's place with its
scores quantised otherwise than the configuration states: to 1/2**shift
units for each ``--shifts`` value, where the configuration states 1/256
(shift 8), or, for ``float64``, not at all, as the upstream tool scores
(what the configuration departs from).  For each seed it makes the
cell's inputs and draws the positions a run samples, exactly as a run
does, and counts the
sampled lines of one call that the control writes otherwise than the
reference: what a run's ``sampled_lines_wrong`` would read with the
control in the program's place.  The limit is 0.  The benchmark's runs do
not run this; it needs no card and loads nothing of the program.  Prints
one JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

from harness import msa, traffic  # noqa: E402
from harness.inputs import sample_positions  # noqa: E402
from harness.spec import Spec  # noqa: E402
from reference import project_alignments as base  # noqa: E402
from reference import project_alignments_q as refq  # noqa: E402


def control_reading(seed: int, config: dict, mix: dict, shifts, bench: pathlib.Path = HERE) -> dict:
    """Sampled lines of one call, and how many of them the control at each
    shift writes otherwise than the reference."""
    rows = traffic.Rows(msa.Msa(seed, config, bench / "configs"))
    pool = traffic.make_pool(seed, mix, rows, int(config["aligner_k"]), bench / "traffic")
    del rows
    positions = sample_positions(seed, pool, int(config["records_per_call"]))
    inputs = base.Inputs(seed, config, mix, positions % len(pool["pos"]), bench)
    expected = dict(zip(positions.tolist(), refq.expected_lines(inputs, config, mix, positions)))
    wrong = {}
    for shift in shifts:
        lines = ["\t".join(fields + sorted(tags))
                 for fields, tags in refq.expected_lines(inputs, config, mix, positions, shift)]
        compared, wrong["float64" if shift is None else str(shift)], _ = base.judge(
            lines, positions, expected)
    return {"seed": seed, "compared": compared, "wrong_by_shift": wrong}


def main(argv=None, root: pathlib.Path = HERE.parent, bench: pathlib.Path = HERE) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--shifts", type=lambda v: None if v == "float64" else int(v), nargs="+",
                   default=[refq.MALDE_SHIFT - 1, 4, None])
    args = p.parse_args(argv)
    spec = Spec(root, bench)
    cell = spec.cell(args.workload)
    config, mix = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    for seed in (s % (1 << 63) for s in args.seeds):
        t0 = time.perf_counter()
        reading = control_reading(seed, config, mix, args.shifts, bench)
        reading.update(workload=args.workload, seconds=time.perf_counter() - t0)
        print(json.dumps(reading), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
