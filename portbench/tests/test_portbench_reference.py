"""The plain reference: its DP on hand-made ties and against every
alignment of small pairs, the options it reads, and its control."""

from __future__ import annotations

import itertools

import numpy as np
import pytest

from reference import project_alignments as ref


def text(ops) -> str:
    return "".join(f"{c}{op}" for c, op in ops)


# (reference slice, query slice, frozen ties, broken ties), worked out by
# hand from the recurrences: a gap of g bases costs 0 + g * -1, as one
# mismatch per base does, so gaps and mismatches tie often
TIES = [
    ("A", "C", "1X", "1X"),
    ("AA", "A", "1D1=", "1D1="),
    ("A", "AA", "1I1=", "1I1="),
    ("AC", "G", "1D1X", "1D1X"),
    ("AC", "CA", "2X", "2X"),
    ("C", "CCG", "1I1=1I", "1=2I"),
    ("GAGC", "G", "2D1=1D", "1=3D"),
]


@pytest.mark.parametrize("ref_slice,query,frozen,broken", TIES)
def test_ties(ref_slice, query, frozen, broken):
    r, q = ref_slice.encode(), query.encode()
    assert text(ref.align_runs([r], [q], 0, -1)[0]) == frozen
    assert text(ref.align_runs([r], [q], 0, -1, ref.BROKEN)[0]) == broken


def score(ops, r: bytes, q: bytes, go: int, ge: int) -> int:
    total, i, j = 0, 0, 0
    for count, op in ops:
        if op in "=X":
            total -= sum(q[i + k] != r[j + k] for k in range(count))
            i, j = i + count, j + count
        else:
            total += go + count * ge
            i, j = (i + count, j) if op == "I" else (i, j + count)
    assert (i, j) == (len(q), len(r))
    return total


def best_score(r: bytes, q: bytes, go: int, ge: int) -> int:
    """The best score over every alignment, by enumeration."""
    best = None
    for moves in itertools.product("MID", repeat=len(r) + len(q)):
        i = j = 0
        ops: list = []
        for mv in moves:
            if i == len(q) and j == len(r):
                break
            if mv == "M" and i < len(q) and j < len(r):
                ref._push(ops, "=" if q[i] == r[j] else "X", 1)
                i, j = i + 1, j + 1
            elif mv == "I" and i < len(q):
                ref._push(ops, "I", 1)
                i += 1
            elif mv == "D" and j < len(r):
                ref._push(ops, "D", 1)
                j += 1
            else:
                break
        if (i, j) == (len(q), len(r)):
            s = score(ops, r, q, go, ge)
            best = s if best is None else max(best, s)
    return best


@pytest.mark.parametrize("costs", [(0, -1), (-2, -1)])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_dp_is_optimal(seed, costs):
    """Every pair's alignment, both tie rules, scores what the best of all
    its alignments scores; the pairs run through one padded DP."""
    rng = np.random.default_rng(seed)
    pairs = [(rng.choice(list(b"ACG"), rng.integers(1, 4)).astype(np.uint8).tobytes(),
              rng.choice(list(b"ACG"), rng.integers(1, 4)).astype(np.uint8).tobytes())
             for _ in range(12)]
    refs, queries = [p[0] for p in pairs], [p[1] for p in pairs]
    for ties in (ref.FROZEN, ref.BROKEN):
        for (r, q), ops in zip(pairs, ref.align_runs(refs, queries, *costs, ties)):
            assert score(ops, r, q, *costs) == best_score(r, q, *costs)


def test_options_read_the_argv(real_spec):
    opts = ref.options(real_spec.config("grch38_chr21_f3")["tool_argv"])
    assert opts["preserve-tag"] == ["XS", "YS"]
    assert opts["record-index-tag"] == "XI"
    assert (opts["gap-opening-cost"], opts["gap-extension-cost"]) == ("0", "-1")


@pytest.mark.parametrize("arg", ["-q", "--use-read-base-qualities=1", "--keep-duplicate-ranges"])
def test_options_refuse_what_the_reference_does_not_model(arg):
    with pytest.raises(ValueError):
        ref.options(["project_alignments", "--reference-msa-id=REF", arg])


# the control's own size: as many realigned records as a run samples
# (the tiny cells hold a few dozen), still small enough for the CPU
CONTROL_COLUMNS = 2_000_000
CONTROL_POOL = 65_536


@pytest.mark.parametrize("workload", ["chr21_f4.test_pairs", "chr21_f3.test_pairs"])
def test_control_fails_at_a_small_size(real_spec, workload):
    """The control (the reference with its ties broken) in the program's
    place reads over the limit of 0 on three seeds."""
    import control

    cell = real_spec.cell(workload)
    config = dict(real_spec.config(cell["config"]), msa_columns=CONTROL_COLUMNS,
                  records_per_call=8 * CONTROL_POOL)
    mix = dict(real_spec.traffic(cell["traffic"]), pool_records=CONTROL_POOL)
    for seed in (5, 6, 2**31 + 5):
        reading = control.control_reading(seed, config, mix)
        assert reading["compared"] > 2500 and reading["wrong"] > 10, reading
