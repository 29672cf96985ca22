"""The control of the benchmark's comparison, at a cell's own size.

    python3 portbench/control.py --workload CELL --seeds N [N ...]

The plain reference is put in the program's place with one guarantee the
configuration states broken: its realignment DP breaks ties deletion
before insertion and extending before opening, where the configuration
states insertion before deletion and opening before extending.  For each
seed it makes the cell's inputs and draws the positions a run samples,
exactly as a run does, and counts the sampled lines of one call that
the control writes otherwise than the reference: what a run's
``sampled_lines_wrong`` would read with the control in the program's
place.  The limit is 0, so the control has to read more on every seed.
The benchmark's runs do not run this; it needs no card and loads nothing
of the program.  Prints one JSON line per seed.
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
from reference import project_alignments as ref  # noqa: E402


def control_reading(seed: int, config: dict, mix: dict, bench: pathlib.Path = HERE) -> dict:
    """Sampled lines of one call, and how many of them the control writes
    otherwise than the reference."""
    rows = traffic.Rows(msa.Msa(seed, config, bench / "configs"))
    pool = traffic.make_pool(seed, mix, rows, int(config["aligner_k"]), bench / "traffic")
    del rows
    positions = sample_positions(seed, pool, int(config["records_per_call"]))
    inputs = ref.Inputs(seed, config, mix, positions % len(pool["pos"]), bench)
    frozen = ref.expected_lines(inputs, config, mix, positions, ref.FROZEN)
    broken = ref.expected_lines(inputs, config, mix, positions, ref.BROKEN)
    lines = ["\t".join(fields + sorted(tags)) for fields, tags in broken]
    compared, wrong, _ = ref.judge(lines, positions, dict(zip(positions.tolist(), frozen)))
    return {"seed": seed, "compared": compared, "wrong": wrong}


def main(argv=None, root: pathlib.Path = HERE.parent, bench: pathlib.Path = HERE) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    spec = Spec(root, bench)
    cell = spec.cell(args.workload)
    config, mix = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    for seed in (s % (1 << 63) for s in args.seeds):
        t0 = time.perf_counter()
        reading = control_reading(seed, config, mix, bench)
        reading.update(workload=args.workload, seconds=time.perf_counter() - t0)
        print(json.dumps(reading), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
