"""Founder MSA rows made from a seed, in the shape of the test workflow's
founder MSA.

A configuration names a pattern (``configs/<msa_pattern>``: one aligned
row per line, ``id<TAB>row``, copied from the source's test data) and the
rows it takes.  Of each pattern column the generator keeps its shape: for
every row, a gap, the column's base, or another base (by how far along
A, C, G, T).  The column's base is the reference row's, or where that is a
gap the first row's that has one.  The pattern is cut between every two
neighbouring columns that both carry no variant (no gap, no other base),
so that no variant is cut, and the MSA is those segments, as many whole
copies of the pattern as fit and then its first segments, in an order
drawn from the seed, to the configuration's number of columns (the last
few columns variant-free).  The bases are
drawn from the seed.  So every seed gets the pattern's gap columns, their
runs, which rows share them and its substitutions, in the same amounts,
at other places.
"""

from __future__ import annotations

import pathlib

import numpy as np

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
GAP = ord("-")
GAP_CODE = 4  # a shape: 0 the column's base, 1-3 another base, 4 a gap
_INDEX = np.full(256, 255, np.uint8)
_INDEX[ACGT] = np.arange(4, dtype=np.uint8)


def row_ids(config: dict) -> list[str]:
    """The MSA's sequence ids in header order: the reference row, then
    the founders."""
    return [config["reference_msa_id"], *config["founders"]]


def pattern_shapes(path: pathlib.Path, ids: list[str]) -> np.ndarray:
    """(rows, columns) uint8 shapes of the pattern's rows ``ids``, in that
    order, without the columns that are gaps in all of them."""
    rows = dict(line.rstrip("\n").split("\t") for line in path.read_text().splitlines() if line)
    text = np.stack([np.frombuffer(rows[i].upper().encode(), np.uint8) for i in ids])
    gap = text == GAP
    if (_INDEX[text[~gap]] == 255).any():
        raise ValueError(f"{path}: bases other than A, C, G, T")
    keep = ~gap.all(axis=0)
    text, gap = text[:, keep], gap[:, keep]
    first = np.argmax(~gap, axis=0)
    column = _INDEX[text[first, np.arange(text.shape[1])]]
    shape = (_INDEX[text].astype(np.int16) - column[None, :]) % 4
    shape[gap] = GAP_CODE
    return shape.astype(np.uint8)


def segments(shape: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(starts, lengths) of the pattern's segments: cut between every two
    neighbouring variant-free columns."""
    quiet = ~shape.any(axis=0)
    cut = np.flatnonzero(quiet[1:] & quiet[:-1]) + 1
    starts = np.concatenate([[0], cut])
    return starts, np.diff(np.concatenate([starts, [shape.shape[1]]]))


class Msa:
    """The configuration's MSA for one seed.  ``source[c]`` is the pattern
    column that column ``c`` takes its shape from."""

    def __init__(self, seed: int, config: dict, configs_dir: pathlib.Path):
        self.ids = row_ids(config)
        self.shape = pattern_shapes(configs_dir / config["msa_pattern"], self.ids)
        n_cols = int(config["msa_columns"])
        starts, lengths = segments(self.shape)
        rng = np.random.default_rng([seed, 0])
        # whole copies of the pattern, then its first segments as far as
        # they fit: the same segments for every seed
        copies, rest = divmod(n_cols, self.shape.shape[1])
        head = int(np.searchsorted(np.cumsum(lengths), rest, side="right"))
        order = rng.permutation(np.concatenate([
            np.resize(np.arange(len(starts)), copies * len(starts)), np.arange(head)]))
        taken = int(lengths[order].sum())
        quiet = int(np.flatnonzero(~self.shape.any(axis=0))[0])
        at = np.cumsum(lengths[order]) - lengths[order]
        source = np.full(n_cols, quiet, np.int32)
        source[:taken] = np.repeat(starts[order] - at, lengths[order]) + np.arange(taken)
        self.source = source
        self.n_cols = n_cols
        self.column_base = rng.integers(0, 4, n_cols, dtype=np.uint8)

    @property
    def n_rows(self) -> int:
        return len(self.ids)

    def gap(self, row: int) -> np.ndarray:
        """True where row ``row`` (its place in ``ids``) has a gap."""
        return self.shape[row][self.source] == GAP_CODE

    def base_index(self, row: int) -> np.ndarray:
        """Row ``row``'s bases as 0-3 (A, C, G, T) in every column, gaps
        included (read them where ``gap`` is False)."""
        return (self.column_base + self.shape[row][self.source]) & 3

    def aligned_row(self, row: int) -> np.ndarray:
        """The row as index_msa reads it: bases, '-' in its gap columns."""
        out = ACGT[self.base_index(row)]
        out[self.gap(row)] = GAP
        return out

    def stripped_row(self, row: int) -> np.ndarray:
        """The row's sequence without gaps (what an aligner indexes)."""
        return ACGT[self.base_index(row)[~self.gap(row)]]
