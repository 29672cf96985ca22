"""Vectorised rank0/select0 over packed gap bitvectors, on tensors.

Counterpart of ``panvc3_tpu.ops.rank_select``: the host ``GapBitVector``
arrays (packed words and per-word cumulative zero counts) are concatenated
across sequences into flat buffers on one device, and queries are batched
tensors of (sequence id, position), answered with gathers, a popcount and
fixed-trip binary searches.  Plain PyTorch (no hand-written kernel): the
same code runs on the CPU for the tests and on the card.

Two things the JAX version gets from XLA are written out here:

- out-of-range gather indices.  XLA wraps a negative index once and clamps
  the result into the array; ``take`` does the same, so garbage and padding
  rows (entries past a record's units, past a sequence's zeros) read what
  they read on the TPU, where PyTorch would raise or fault;
- unsigned 32-bit words.  ``words`` is int64 holding the uint32 values, so
  shifts are logical, and ``popcount32`` is a SWAR popcount (PyTorch has
  none).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..bitvec import GapBitVector, unpack_bits
from ..utils import log_time

# Acceleration-table budget where the device reports no free memory (the
# CPU): 2 GB, the JAX package's default, so that the CPU decides the
# tables as the JAX package does on the CPU.
DEFAULT_TABLE_BUDGET_BYTES = 2 * 1024 * 1024 * 1024

# Fraction of free device memory the acceleration tables may claim.  They
# are a pure speed/space trade (the block-rank fallback answers the same
# queries), so they must never crowd out batch buffers.
TABLE_BUDGET_FRACTION = 0.25

_U32 = 0xFFFFFFFF


def _table_budget_bytes(device: torch.device) -> int:
    """Budget for the zsel/rtab tables: a quarter of the card's free memory,
    or ``DEFAULT_TABLE_BUDGET_BYTES`` on the CPU."""
    if device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        return max(0, int(free * TABLE_BUDGET_FRACTION))
    return DEFAULT_TABLE_BUDGET_BYTES


def take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` along dim 0 with XLA's gather semantics: a negative
    index counts from the end once, then every index is clamped into the
    table."""
    n = table.shape[0]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    return table[idx]


def clamped(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` along dim 0 with every index clamped into the table
    (the JAX version's explicit ``jnp.clip`` before a gather)."""
    return table[idx.long().clamp(0, table.shape[0] - 1)]


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit value held in an int64 tensor (SWAR)."""
    x = x & _U32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


@dataclass
class DeviceGapIndex:
    """Flattened stack of gap bitvectors on one device.

    Sequences are identified by dense ids (order of construction).
    ``zsel`` is the optional explicit select table (the aligned position of
    every zero, concatenated per sequence, plus a ``SELECT_SLICE_PAD``
    tail): select0 becomes one gather instead of a binary search.
    ``rtab`` is the optional dense table ``(rank0(pos) << 1) | bit(pos)``
    per aligned position (n + 1 per sequence; the one-past-end bit is 0).
    Both are dropped when they do not fit the budget.
    """

    words: torch.Tensor         # int64[total_words], uint32 values
    brank: torch.Tensor         # int32[total_brank] zeros before each word (nwords+1 per seq)
    seq_word_off: torch.Tensor  # int32[S]
    seq_brank_off: torch.Tensor  # int32[S]
    seq_nwords: torch.Tensor    # int32[S]
    seq_nzeros: torch.Tensor    # int32[S]
    zsel: torch.Tensor | None   # int32[total_zeros+PAD]
    seq_zsel_off: torch.Tensor  # int32[S]
    rtab: torch.Tensor | None   # int32[total_cols+S]
    seq_rtab_off: torch.Tensor  # int32[S]
    search_steps: int           # ceil(log2(max nwords + 1))

    # zsel tail padding so consecutive-rank select can load R-length slices
    # without clamping away valid entries (R above this falls back to the
    # elementwise select)
    SELECT_SLICE_PAD = 4096

    # array fields in the order of the JAX pytree
    FIELDS = (
        "words", "brank", "seq_word_off", "seq_brank_off", "seq_nwords",
        "seq_nzeros", "zsel", "seq_zsel_off", "rtab", "seq_rtab_off",
    )

    @property
    def device(self) -> torch.device:
        return self.words.device

    @classmethod
    def build(
        cls,
        vectors: list[GapBitVector],
        with_select_table: bool | None = None,
        with_rank_table: bool | None = None,
        device="cuda",
    ) -> "DeviceGapIndex":
        """The index of ``vectors``, built in numpy and moved once to
        ``device``.  A table left as ``None`` is built while it fits the
        budget, the select table first."""
        device = torch.device(device)
        words_parts, brank_parts = [], []
        word_off, brank_off, nwords, nzeros = [], [], [], []
        woff = boff = 0
        for gv in vectors:
            words_parts.append(gv.words)
            wr = gv._word_rank0().astype(np.int32)
            brank_parts.append(wr)
            word_off.append(woff)
            brank_off.append(boff)
            nwords.append(len(gv.words))
            nzeros.append(gv.n_zeros)
            woff += len(gv.words)
            boff += len(wr)
        max_nwords = max(nwords) if nwords else 1

        total_zeros = sum(nzeros)
        total_cols = sum(gv.n for gv in vectors)
        zsel_cost = 4 * total_zeros
        rtab_cost = 4 * (total_cols + len(vectors))
        if with_select_table is None or with_rank_table is None:
            budget = _table_budget_bytes(device)
            decided = []
            if with_select_table is None:
                with_select_table = zsel_cost <= budget
                decided.append(
                    f"select table {zsel_cost / 2**20:.0f} MB "
                    f"{'on' if with_select_table else 'OFF (over budget)'}"
                )
            remaining = budget - (zsel_cost if with_select_table else 0)
            if with_rank_table is None:
                with_rank_table = rtab_cost <= remaining
                decided.append(
                    f"rank table {rtab_cost / 2**20:.0f} MB "
                    f"{'on' if with_rank_table else 'OFF (over budget)'}"
                )
            if not (with_select_table and with_rank_table) or (
                zsel_cost + rtab_cost > 128 * 2**20
            ):
                log_time(
                    "Device gap index tables: " + ", ".join(decided)
                    + f" (budget {budget / 2**20:.0f} MB)."
                )

        zsel = None
        zsel_off = np.zeros(max(1, len(vectors)), np.int32)
        if with_select_table:
            parts = []
            zoff = 0
            for i, gv in enumerate(vectors):
                zsel_off[i] = zoff
                bits = unpack_bits(gv.words, gv.n)
                parts.append(np.flatnonzero(bits == 0).astype(np.int32))
                zoff += gv.n_zeros
            flat = np.concatenate(parts) if parts else np.zeros(1, np.int32)
            # tail pad: slice loads at the last sequence's end never clamp
            pad = np.full(cls.SELECT_SLICE_PAD, flat[-1], np.int32)
            zsel = np.concatenate([flat, pad])

        rtab = None
        rtab_off = np.zeros(max(1, len(vectors)), np.int32)
        if with_rank_table:
            parts = []
            roff = 0
            for i, gv in enumerate(vectors):
                rtab_off[i] = roff
                bits = unpack_bits(gv.words, gv.n)
                r = np.zeros(gv.n + 1, np.int32)
                np.cumsum(bits == 0, out=r[1:])
                c = r << 1
                c[:-1] |= bits.astype(np.int32)
                parts.append(c)
                roff += gv.n + 1
            rtab = np.concatenate(parts) if parts else np.zeros(1, np.int32)
        state = {
            "words": np.concatenate(words_parts) if words_parts else np.zeros(1, np.uint32),
            "brank": np.concatenate(brank_parts) if brank_parts else np.zeros(1, np.int32),
            "seq_word_off": np.array(word_off, np.int32),
            "seq_brank_off": np.array(brank_off, np.int32),
            "seq_nwords": np.array(nwords, np.int32),
            "seq_nzeros": np.array(nzeros, np.int32),
            "zsel": zsel,
            "seq_zsel_off": zsel_off,
            "rtab": rtab,
            "seq_rtab_off": rtab_off,
            "search_steps": max(1, math.ceil(math.log2(max_nwords + 1))),
        }
        return cls.from_numpy_state(state, device)

    @classmethod
    def from_numpy_state(cls, state: dict, device) -> "DeviceGapIndex":
        """The index from numpy arrays under the keys of ``FIELDS`` plus
        ``search_steps`` (``numpy_state``'s layout, which is the JAX index's
        pytree: ``np.asarray`` of each field)."""
        device = torch.device(device)
        arrays = {}
        for key in cls.FIELDS:
            a = state[key]
            if a is None:
                arrays[key] = None
            elif key == "words":
                arrays[key] = torch.from_numpy(
                    np.asarray(a, np.uint32).astype(np.int64)
                ).to(device)
            else:
                arrays[key] = torch.from_numpy(
                    np.require(a, np.int32, ["C", "W"])
                ).to(device)
        return cls(**arrays, search_steps=int(state["search_steps"]))

    def to(self, device) -> "DeviceGapIndex":
        """The index on ``device``: each table copied once, device to
        device (self where it is there already); it is never rebuilt."""
        device = torch.device(device)
        if device == self.device:
            return self
        return dataclasses.replace(self, **{
            key: None if getattr(self, key) is None else getattr(self, key).to(device)
            for key in self.FIELDS
        })

    def numpy_state(self) -> dict:
        """Every array as numpy, in the JAX index's dtypes (uint32 words,
        int32 elsewhere), plus ``search_steps``."""
        out = {}
        for key in self.FIELDS:
            t = getattr(self, key)
            if t is None:
                out[key] = None
            elif key == "words":
                out[key] = t.cpu().numpy().astype(np.uint32)
            else:
                out[key] = t.cpu().numpy()
        out["search_steps"] = self.search_steps
        return out

    # -- queries (element-wise over same-shaped integer tensors) -----------

    def _word_rank(self, seq, pos):
        """(zeros before the word of ``pos``, the word, the bit index) from
        the block-rank structure."""
        wi = pos >> 5
        bi = pos & 31
        base = take(self.brank, take(self.seq_brank_off, seq) + wi)
        w = take(self.words, take(self.seq_word_off, seq) + wi)
        return base, w, bi

    def rank0(self, seq: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """Zeros strictly before ``pos`` in sequence ``seq`` (int32)."""
        pos = pos.long()
        if self.rtab is not None:
            return clamped(self.rtab, take(self.seq_rtab_off, seq) + pos) >> 1
        base, w, bi = self._word_rank(seq, pos)
        inword = popcount32((~w) & ((1 << bi) - 1))
        return (base + inword).int()

    def bit(self, seq: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """The gap bit at ``pos`` (int32)."""
        pos = pos.long()
        if self.rtab is not None:
            return clamped(self.rtab, take(self.seq_rtab_off, seq) + pos) & 1
        w = take(self.words, take(self.seq_word_off, seq) + (pos >> 5))
        return ((w >> (pos & 31)) & 1).int()

    def rank0_and_bit(self, seq: torch.Tensor, pos: torch.Tensor):
        """(rank0(pos), bit(pos)) sharing their gathers."""
        pos = pos.long()
        if self.rtab is not None:
            v = clamped(self.rtab, take(self.seq_rtab_off, seq) + pos)
            return v >> 1, v & 1
        base, w, bi = self._word_rank(seq, pos)
        inword = popcount32((~w) & ((1 << bi) - 1))
        return (base + inword).int(), ((w >> bi) & 1).int()

    def select0_consecutive(self, seq: torch.Tensor, k0: torch.Tensor, R: int):
        """``select0(seq, k0 + r)`` for r in [0, R): ``seq``/``k0`` are
        (B,), the result (B, R).  With the select table each row is one
        contiguous slice of ``zsel`` (its start clamped as the JAX slice
        gather clamps it); entries past the sequence's zero count read the
        tail pad or the next sequence and must be masked by the caller."""
        if self.zsel is None or R > self.SELECT_SLICE_PAD:
            r = torch.arange(R, dtype=torch.int64, device=k0.device)[None, :]
            return self.select0(seq[:, None], k0.long()[:, None] + r)
        size = self.zsel.shape[0]
        base = take(self.seq_zsel_off, seq) + (k0.long() - 1).clamp(min=0)
        # jnp.clip(base, 0, size - 1 - R), then the slice gather's own clamp
        base = base.clamp(min=0).clamp(max=size - 1 - R).clamp(0, size - R)
        lane = torch.arange(R, dtype=torch.int64, device=base.device)[None, :]
        return self.zsel[base[:, None] + lane]

    def select0(self, seq: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        """Aligned position of the k-th zero (1-based) in sequence ``seq``
        (int32): one gather with the select table, else a binary search over
        the block ranks (``search_steps`` trips) and a 5-step in-word
        popcount search."""
        k = k.long()
        if self.zsel is not None:
            return clamped(self.zsel, take(self.seq_zsel_off, seq) + (k - 1).clamp(min=0))
        boff = take(self.seq_brank_off, seq).long()
        n = take(self.seq_nwords, seq).long()

        # largest j in [0, n-1] with brank[boff + j] < k
        lo = torch.zeros_like(k)
        hi = n - 1
        for _ in range(self.search_steps):
            mid = (lo + hi + 1) >> 1
            go_right = take(self.brank, boff + mid) < k
            lo = torch.where(go_right, mid, lo)
            hi = torch.where(go_right, hi, mid - 1)
        wi = lo
        rem = k - take(self.brank, boff + wi)  # 1-based zero rank in the word
        inv = (~take(self.words, take(self.seq_word_off, seq) + wi)) & _U32

        pos = torch.zeros_like(k)
        cur = torch.zeros_like(k)
        shifted = inv
        width = 16
        while width:
            lower = shifted & ((1 << width) - 1)
            cnt = popcount32(lower)
            go_right = cnt < rem - cur
            cur = torch.where(go_right, cur + cnt, cur)
            pos = torch.where(go_right, pos + width, pos)
            shifted = torch.where(go_right, shifted >> width, lower)
            width >>= 1
        return ((wi << 5) + pos).int()
