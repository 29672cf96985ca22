"""Packed gap bitvectors with rank0 and select0 (copy of
``panvc3_tpu.bitvec``, trimmed to what the port calls).

- ``words``:     uint32[ceil(n/32)] packed bits (bit i of word w =
                 position 32*w + i; 1 == gap),
- ``sb_rank0``:  int64[ceil(nw/256)+1] zeros strictly before each
                 256-word (8192-bit) superblock, final entry = total,
- ``rel_rank0``: uint16[ceil(nw/8)] zeros from the enclosing superblock
                 start to each 8-word (256-bit) block start.

rank0(pos)   = sb + rel + masked popcounts over the block's 8 words
select0(k)   = binary search superblocks, fixed-trip search of the 32
               in-superblock blocks, popcount scan of the 8 block words,
               then an in-word popcount binary search.
"""

from __future__ import annotations

import numpy as np

BLOCK_WORDS = 8    # 256-bit rank block
SB_BLOCKS = 32     # 32 blocks = 256 words = 8192 bits per superblock


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """Pack a bool/0-1 array into uint32 words (little-endian bit order)."""
    bits = np.asarray(bits, dtype=np.uint8)
    n = bits.shape[0]
    n_words = (n + 31) // 32
    # little-endian bit order within bytes + little-endian byte order within
    # uint32 == bit k of word w is bits[32w + k]
    packed = np.packbits(bits, bitorder="little")
    out = np.zeros(n_words * 4, dtype=np.uint8)
    out[: len(packed)] = packed
    return out.view("<u4")


def unpack_bits(words: np.ndarray, n: int) -> np.ndarray:
    """Inverse of :func:`pack_bits`; returns uint8[n]."""
    words = np.ascontiguousarray(words, dtype=np.uint32)
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    return bits[:n]


def _popcount32(x: np.ndarray) -> np.ndarray:
    if hasattr(np, "bitwise_count"):  # numpy >= 2.0
        return np.bitwise_count(np.asarray(x, dtype=np.uint32)).astype(np.int64)
    x = x.astype(np.uint32)
    x = x - ((x >> 1) & np.uint32(0x55555555))
    x = (x & np.uint32(0x33333333)) + ((x >> 2) & np.uint32(0x33333333))
    x = (x + (x >> 4)) & np.uint32(0x0F0F0F0F)
    # sum the four bytes; go through uint64 to avoid intended-wraparound warnings
    return (((x.astype(np.uint64) * np.uint64(0x01010101)) >> np.uint64(24)) & np.uint64(0xFF)).astype(np.int64)


class GapBitVector:
    """Gap bitvector (1 == gap) with rank0/select0 support.

    Positions are over the *aligned* (MSA column) coordinate space; zeros
    correspond to actual sequence characters ("unaligned" positions).
    """

    __slots__ = (
        "n", "n_zeros", "words", "sb_rank0", "rel_rank0",
        "_s0_cache", "_r0_cache",
    )

    def __init__(
        self,
        words: np.ndarray,
        n: int,
        sb_rank0: np.ndarray | None = None,
        rel_rank0: np.ndarray | None = None,
    ):
        self.words = np.ascontiguousarray(words, dtype=np.uint32)
        self.n = int(n)
        nw = len(self.words)
        if sb_rank0 is None or rel_rank0 is None:
            cum = self._word_rank0()
            sbw = BLOCK_WORDS * SB_BLOCKS
            n_sb = (nw + sbw - 1) // sbw
            n_blocks = (nw + BLOCK_WORDS - 1) // BLOCK_WORDS
            sb_idx = np.minimum(np.arange(n_sb + 1, dtype=np.int64) * sbw, nw)
            sb_rank0 = cum[sb_idx]
            blk_idx = np.minimum(
                np.arange(n_blocks, dtype=np.int64) * BLOCK_WORDS, nw
            )
            rel_rank0 = (
                cum[blk_idx] - sb_rank0[np.arange(n_blocks) // SB_BLOCKS]
            ).astype(np.uint16)
        self.sb_rank0 = np.ascontiguousarray(sb_rank0, dtype=np.int64)
        self.rel_rank0 = np.ascontiguousarray(rel_rank0, dtype=np.uint16)
        self.n_zeros = int(self.sb_rank0[-1])
        # consecutive-query caches for the scalar paths (the host oracle
        # walks select0(k), select0(k+1), ... per CIGAR base).  Stored as
        # single tuples so a concurrent reader always sees a consistent
        # (key, value) pair; the structure itself is immutable.
        self._s0_cache = (-2, -1)  # (k, select0(k))
        self._r0_cache = (-1, 0)   # (pos, rank0(pos))

    def _word_rank0(self) -> np.ndarray:
        """int64[nw+1] zeros strictly before each word boundary (transient;
        built on demand, not kept resident)."""
        zeros_per_word = 32 - _popcount32(self.words)
        # padding bits beyond n are zeros in the packed representation —
        # mask them out of the last word's count
        tail = self.n & 31
        if tail and len(zeros_per_word):
            zeros_per_word[-1] -= 32 - tail
        cum = np.zeros(len(self.words) + 1, dtype=np.int64)
        np.cumsum(zeros_per_word, out=cum[1:])
        return cum

    @classmethod
    def from_gap_string(cls, seq: str | bytes, gap: str = "-") -> "GapBitVector":
        """Build from an aligned sequence string; ``gap`` chars set bits."""
        if isinstance(seq, str):
            seq = seq.encode("ascii")
        arr = np.frombuffer(seq, dtype=np.uint8)
        bits = (arr == ord(gap)).astype(np.uint8)
        return cls(pack_bits(bits), len(bits))

    @classmethod
    def from_bits(cls, bits: np.ndarray) -> "GapBitVector":
        bits = np.asarray(bits, dtype=np.uint8)
        return cls(pack_bits(bits), len(bits))

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, pos: int) -> int:
        return int((self.words[pos >> 5] >> np.uint32(pos & 31)) & 1)

    def bit_at(self, pos) -> np.ndarray:
        """Vectorised bit read at aligned positions."""
        pos = np.asarray(pos, dtype=np.int64)
        return ((self.words[pos >> 5] >> (pos & 31).astype(np.uint32)) & 1).astype(np.uint8)

    @property
    def nbytes(self) -> int:
        """Resident bytes of the packed bits + rank directory."""
        return self.words.nbytes + self.sb_rank0.nbytes + self.rel_rank0.nbytes

    # -- rank/select -------------------------------------------------------

    def _rank0_scalar(self, pos: int) -> int:
        """Pure-Python rank0 for single positions (same directory walk as
        the vector path below, ~100x faster per call than the numpy
        machinery for the host oracle's per-base queries).  Nearby
        monotone queries (the oracle's per-base walk) are answered by
        counting zeros forward from the previous answer."""
        words = self.words
        last_pos, last_rank = self._r0_cache
        if 0 <= last_pos <= pos <= self.n and pos - last_pos <= 2048:
            r = last_rank
            a = last_pos
            # whole/partial words in [a, pos)
            while a < pos:
                w = int(words[a >> 5])
                lo = a & 31
                hi = min(32, lo + (pos - a))
                seg = (w >> lo) & ((1 << (hi - lo)) - 1)
                r += (hi - lo) - seg.bit_count()
                a += hi - lo
            self._r0_cache = (pos, r)
            return r
        nw = len(words)
        n_blocks = len(self.rel_rank0)
        blk = pos >> 8
        cap = n_blocks - 1
        if blk > cap:
            blk = cap if cap > 0 else 0
        base = int(self.sb_rank0[blk >> 5]) + int(self.rel_rank0[blk])
        inword = 0
        w0 = blk << 3
        for j in range(BLOCK_WORDS):
            lane = w0 + j
            lim = pos - (lane << 5)
            if lim <= 0:
                break
            if lim > 32:
                lim = 32
            wv = int(words[lane if lane < nw else nw - 1])
            inword += ((wv ^ 0xFFFFFFFF) & ((1 << lim) - 1)).bit_count()
        r = base + inword
        if pos <= self.n:
            self._r0_cache = (pos, r)
        return r

    def _select0_scalar(self, k: int) -> int:
        """Pure-Python select0 for single ranks (mirrors the vector path).

        Consecutive ranks (the oracle asks select0(k), select0(k+1), ...
        one CIGAR base at a time) short-circuit to a next-clear-bit scan
        from the previous answer."""
        words = self.words
        last_k, last_pos = self._s0_cache
        if last_pos >= 0 and 1 <= k <= self.n_zeros:
            if k == last_k:
                return last_pos
            if k == last_k + 1:
                p = last_pos + 1
                i = p >> 5
                inv = (int(words[i]) ^ 0xFFFFFFFF) >> (p & 31)
                while inv == 0:
                    i += 1
                    p = i << 5
                    inv = int(words[i]) ^ 0xFFFFFFFF
                pos = p + (inv & -inv).bit_length() - 1
                self._s0_cache = (k, pos)
                return pos
        sb = self.sb_rank0
        rel = self.rel_rank0
        nw = len(words)
        n_blocks = len(rel)
        s = int(np.searchsorted(sb, k, side="left")) - 1
        cap = len(sb) - 2
        if s < 0:
            s = 0
        elif s > cap:
            s = cap if cap > 0 else 0
        rem_s = k - int(sb[s])
        lo = s << 5
        hi = lo + SB_BLOCKS
        if hi > n_blocks:
            hi = n_blocks
        while lo < hi:
            mid = (lo + hi) >> 1
            if int(rel[mid]) < rem_s:
                lo = mid + 1
            else:
                hi = mid
        b = lo - 1 if lo > 0 else 0
        rem_b = rem_s - int(rel[b])
        w0 = b << 3
        # lane = last j in the block whose exclusive zero-cumsum < rem_b
        lane = 0
        rem = rem_b
        c = 0
        for j in range(BLOCK_WORDS):
            if c < rem_b:
                lane = j
                rem = rem_b - c
            else:
                break
            idx = w0 + j
            w = int(words[idx if idx < nw else nw - 1])
            c += (w ^ 0xFFFFFFFF).bit_count()
        word_idx = w0 + lane
        inv = int(words[word_idx]) ^ 0xFFFFFFFF
        pos = 0
        cur = 0
        width = 16
        shifted = inv
        while width:
            lower = shifted & ((1 << width) - 1)
            cnt = lower.bit_count()
            if cnt < rem - cur:
                cur += cnt
                pos += width
                shifted >>= width
            else:
                shifted = lower
            width >>= 1
        out = (word_idx << 5) + pos
        if 1 <= k <= self.n_zeros:
            self._s0_cache = (k, out)
        return out

    def rank0(self, pos) -> np.ndarray:
        """Number of zeros strictly before aligned position ``pos``.

        Matches sdsl rank0 semantics used by project_aligned_position
        (include/panvc3/msa_index.hh:246-250).  Vectorised;
        single positions take the pure-Python scalar walk.
        """
        if isinstance(pos, (int, np.integer)):
            return self._rank0_scalar(int(pos))
        pos = np.asarray(pos, dtype=np.int64)
        nw = len(self.words)
        n_blocks = len(self.rel_rank0)
        blk = np.minimum(pos >> 8, max(n_blocks - 1, 0))
        base = self.sb_rank0[blk >> 5] + self.rel_rank0[blk]
        lanes = (blk << 3)[..., None] + np.arange(BLOCK_WORDS, dtype=np.int64)
        wv = self.words[np.minimum(lanes, max(nw - 1, 0))]
        # bits of lane j counted: max(0, min(pos - 32*lane, 32)); padding
        # bits (>= n >= pos) are excluded by the limit automatically
        lim = np.clip(pos[..., None] - (lanes << 5), 0, 32).astype(np.uint64)
        mask = ((np.uint64(1) << lim) - np.uint64(1)).astype(np.uint32)
        inword = _popcount32((~wv) & mask).sum(axis=-1)
        return base + inword

    def select0(self, k) -> np.ndarray:
        """Aligned position of the k-th zero (1-based k, sdsl semantics).

        ``select0(1 + unaligned_pos)`` converts an unaligned position to its
        aligned position, as in sequence_entry::aligned_position
        (include/panvc3/msa_index.hh:239-243).  Vectorised;
        single ranks take the pure-Python scalar walk.
        """
        if isinstance(k, (int, np.integer)):
            return self._select0_scalar(int(k))
        k = np.asarray(k, dtype=np.int64)
        nw = len(self.words)
        n_blocks = len(self.rel_rank0)
        # superblock containing the k-th zero
        s = np.searchsorted(self.sb_rank0, k, side="left") - 1
        s = np.clip(s, 0, max(len(self.sb_rank0) - 2, 0))
        rem_s = k - self.sb_rank0[s]
        # last block b in the superblock with rel_rank0[b] < rem_s
        lo = s << 5
        hi = np.minimum(lo + SB_BLOCKS, n_blocks)
        for _ in range(6):  # fixed-trip bisect over <= 32 blocks
            mid = (lo + hi) >> 1
            relv = self.rel_rank0[np.minimum(mid, max(n_blocks - 1, 0))].astype(np.int64)
            go = (relv < rem_s) & (mid < hi)
            lo = np.where(go, mid + 1, lo)
            hi = np.where(go, hi, mid)
        b = np.maximum(lo - 1, 0)
        rem_b = rem_s - self.rel_rank0[b].astype(np.int64)
        # word within the block (padding zeros sit above all real zeros,
        # so the exclusive-cumulative comparison is unaffected by them)
        lanes = (b << 3)[..., None] + np.arange(BLOCK_WORDS, dtype=np.int64)
        wv = self.words[np.minimum(lanes, max(nw - 1, 0))]
        zc = _popcount32(~wv)
        cum = np.cumsum(zc, axis=-1)
        cumexcl = cum - zc
        lane = np.sum(cumexcl < rem_b[..., None], axis=-1) - 1
        word_idx = (b << 3) + lane
        rem = rem_b - np.take_along_axis(cumexcl, lane[..., None], -1)[..., 0]
        inv = (~self.words[word_idx]).astype(np.uint32)
        # in-word binary search over 5 levels using prefix popcounts
        pos = np.zeros_like(k)
        cur = np.zeros_like(k)
        width = 16
        shifted = inv
        while width:
            lower = shifted & ((np.uint32(1) << np.uint32(width)) - np.uint32(1))
            cnt = _popcount32(lower)
            go_right = cnt < rem - cur
            cur = np.where(go_right, cur + cnt, cur)
            pos = np.where(go_right, pos + width, pos)
            shifted = np.where(go_right, shifted >> np.uint32(width), lower).astype(np.uint32)
            width >>= 1
        return (word_idx << 5) + pos

    # -- (de)serialisation -------------------------------------------------

    def state(self) -> dict:
        return {
            "words": self.words,
            "n": np.int64(self.n),
            "sb_rank0": self.sb_rank0,
            "rel_rank0": self.rel_rank0,
        }

    @classmethod
    def from_state(cls, words, n, sb_rank0=None, rel_rank0=None) -> "GapBitVector":
        sb = None if sb_rank0 is None else np.asarray(sb_rank0, dtype=np.int64)
        rel = None if rel_rank0 is None else np.asarray(rel_rank0, dtype=np.uint16)
        return cls(np.asarray(words, dtype=np.uint32), int(n), sb, rel)
