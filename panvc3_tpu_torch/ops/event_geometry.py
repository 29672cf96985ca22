"""Event-based projection geometry: O(#MSA-differences) instead of
O(reads x read-length) (copy of the host half of
``panvc3_tpu.ops.event_geometry``; ``DeviceEventGeometry`` is ROADMAP
Queue 1 item 3).

The per-unit gap geometry the rewrite needs (which destination columns
are gaps, how many destination bases fall between consecutive source
units) is fully determined by the columns where the source and
destination gap bitvectors DIFFER.  Real MSAs differ rarely (one indel
site per ~100 bp), so precomputing the difference *runs* per (src, dst)
sequence pair turns the per-record work into two `searchsorted` calls
plus a handful of event decodes — microseconds per batch on the host.

Per pair, from ``xor`` of the packed gap words:

- **gap events** ``[gap_start, gap_end]``: maximal runs of consecutive
  source ranks whose aligned column is a destination gap (these emit I
  in place of M/=/X — rewrite_cigar.hh:96-116);
- **del events** ``(del_b, del_len)``: for each inter-unit boundary
  ``b``, the number of destination bases strictly between the aligned
  columns of source units ``b-1`` and ``b`` (these emit D runs —
  rewrite_cigar.hh:88-94,117-133).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..bitvec import GapBitVector
from ..native import get_native


@dataclass
class PairEvents:
    gap_start: np.ndarray  # int64[] first unit rank of a dst-gap run
    gap_end: np.ndarray    # int64[] last unit rank (inclusive)
    del_b: np.ndarray      # int64[] boundary rank (strictly increasing)
    del_len: np.ndarray    # int64[] dst bases between units b-1 and b
    gap_clen: np.ndarray   # int64[n_gap+1] cumulative gap-run lengths
    del_clen: np.ndarray   # int64[n_del+1] cumulative deleted-base counts


def _make_pair_events(gap_start, gap_end, del_b, del_len) -> PairEvents:
    gap_clen = np.zeros(len(gap_start) + 1, np.int64)
    np.cumsum(gap_end - gap_start + 1, out=gap_clen[1:])
    del_clen = np.zeros(len(del_b) + 1, np.int64)
    np.cumsum(del_len, out=del_clen[1:])
    return PairEvents(gap_start, gap_end, del_b, del_len, gap_clen, del_clen)


def build_pair_events(src: GapBitVector, dst: GapBitVector) -> PairEvents:
    """Difference events of one (src, dst) pair from the packed words."""
    mw = min(len(src.words), len(dst.words))
    wd = src.words[:mw] ^ dst.words[:mw]
    empty = np.zeros(0, np.int64)
    # set-bit positions via a C-level unpack: at genome scale the previous
    # per-word (nzw, 32) expansion built multi-hundred-MB int64
    # intermediates and dominated engine start-up
    bits_all = np.unpackbits(
        np.ascontiguousarray(wd).view(np.uint8), bitorder="little"
    )
    cols = np.flatnonzero(bits_all).astype(np.int64)
    cols = cols[cols < min(src.n, dst.n)]
    if cols.size == 0:
        return _make_pair_events(empty, empty, empty, empty)
    # src bit + rank0 at every difference column without a full-length
    # cumulative array: gaps are sparse, so rank0(c) = c - (# gap
    # positions < c) via one searchsorted over the gap-position list
    # (the general gather-based rank0 and a full int64 cumsum both
    # dominated genome-scale engine start-up)
    up_to = int(cols[-1]) + 1
    src_bits = np.unpackbits(
        np.ascontiguousarray(src.words).view(np.uint8),
        count=up_to,
        bitorder="little",
    )
    src_gap_pos = np.flatnonzero(src_bits)
    sbit = src_bits[cols]
    srank = cols - np.searchsorted(src_gap_pos, cols, side="left")

    # src zero + dst gap: the unit itself projects onto a gap column
    g = srank[sbit == 0]
    if g.size:
        cut = np.r_[True, np.diff(g) > 1]
        gap_start = g[cut]
        gap_end = g[np.r_[cut[1:], True]]
    else:
        gap_start = gap_end = empty

    # src gap + dst zero: a dst base between consecutive units
    d = srank[sbit == 1]
    if d.size:
        del_b, del_len = np.unique(d, return_counts=True)
        del_len = del_len.astype(np.int64)
    else:
        del_b = del_len = empty
    return _make_pair_events(gap_start, gap_end, del_b, del_len)


def project_unit(pe: PairEvents, u: np.ndarray) -> np.ndarray:
    """Destination position of source unit ``u`` from the events alone.

    Identity: ``dst.rank0(src.select0(u + 1)) == u - G(u) + D(u)`` where
    ``G(u)`` counts source units below ``u`` that project onto destination
    gaps (gap-event coverage of ``[0, u)``) and ``D(u)`` counts
    destination-only bases at boundaries ``<= u`` (del-event prefix sum).
    Proof sketch: the aligned columns before ``select0(u+1)`` hold exactly
    ``u`` source units plus the source gaps of rank ``<= u``; a column is
    a destination zero unless it is a gap/del difference event.  This
    replaces the rank/select evaluation of project_position with two
    binary searches over the O(#MSA-differences) event tables.
    """
    u = np.asarray(u, dtype=np.int64)
    if pe.gap_start.size:
        j = np.searchsorted(pe.gap_end, u, side="left")
        i = np.searchsorted(pe.gap_start, u, side="left")
        straddle = np.where(
            i > j, u - pe.gap_start[np.minimum(j, pe.gap_start.size - 1)], 0
        )
        g = pe.gap_clen[j] + straddle
    else:
        g = np.zeros_like(u)
    if pe.del_b.size:
        d = pe.del_clen[np.searchsorted(pe.del_b, u, side="right")]
    else:
        d = np.zeros_like(u)
    return u - g + d


def _ranges(cnt: np.ndarray) -> np.ndarray:
    """[0..cnt0), [0..cnt1), ... concatenated."""
    total = int(cnt.sum())
    out = np.arange(total, dtype=np.int64)
    starts = np.r_[np.int64(0), np.cumsum(cnt)[:-1]]
    return out - np.repeat(starts, cnt)


class EventGeometry:
    """Per-input-reference event tables + batched geometry queries.

    Produces exactly the arrays the native ``finalize_reconstruct``
    consumes (dst_pos, gapbits bitmask, sparse-or-full deletion runs).
    """

    def __init__(self, src_entries, dst_entries, ref_id_mapping):
        self.src_gv = [e.gaps if e is not None else None for e in src_entries]
        self.dst_gv = [
            dst_entries[ref_id_mapping[i]].gaps
            if src_entries[i] is not None
            and dst_entries[ref_id_mapping[i]] is not None
            else None
            for i in range(len(src_entries))
        ]
        # dedupe identical pairs (many input refs share gap vectors)
        cache: dict[tuple[int, int], PairEvents] = {}
        self.events: list[PairEvents | None] = []
        for s, d in zip(self.src_gv, self.dst_gv):
            if s is None or d is None:
                self.events.append(None)
                continue
            key = (id(s), id(d))
            if key not in cache:
                cache[key] = build_pair_events(s, d)
            self.events.append(cache[key])

        # native fast path (the C host extension's event_geometry_batch):
        # per-rid buffer tuples; PANVC3_EVENT_GEOMETRY_NATIVE=0 keeps the
        # numpy path
        self._native = None
        self._native_group: list[tuple | None] = []
        if os.environ.get("PANVC3_EVENT_GEOMETRY_NATIVE") != "0":
            self._native = get_native()
            for pe, s in zip(self.events, self.src_gv):
                if pe is None:
                    self._native_group.append(None)
                    continue
                self._native_group.append((
                    np.ascontiguousarray(pe.gap_start),
                    np.ascontiguousarray(pe.gap_end),
                    np.ascontiguousarray(pe.del_b),
                    np.ascontiguousarray(pe.del_len),
                    np.ascontiguousarray(pe.gap_clen),
                    np.ascontiguousarray(pe.del_clen),
                    int(s.n_zeros),
                ))

    def batch(
        self,
        ref_ids: np.ndarray,   # int32[B] input reference id per record
        pos: np.ndarray,       # int32[B] source position
        n_units: np.ndarray,   # int32[B] ref-consuming CIGAR length
        R: int,                # padded unit count (multiple of 8)
        K: int,                # sparse deletion slots
    ):
        """(dst_pos i32[B], gapbits u8[B, R/8], d_vals u8[B, K],
        d_pos u8[B, K], d_n u8[B], use_full, d_full i32[B*R or 0])."""
        B = len(pos)
        if self._native is not None:
            gs = (R + 7) // 8
            dp_b, gap_b, dv_b, dpos_b, dn_b, use_full, df_b = (
                self._native.event_geometry_batch(
                    np.ascontiguousarray(ref_ids, dtype=np.int32),
                    np.ascontiguousarray(pos, dtype=np.int32),
                    np.ascontiguousarray(n_units, dtype=np.int32),
                    R, K, self._native_group,
                )
            )
            return (
                np.frombuffer(dp_b, np.int32),
                np.frombuffer(gap_b, np.uint8).reshape(B, gs),
                np.frombuffer(dv_b, np.uint8).reshape(B, K),
                np.frombuffer(dpos_b, np.uint8).reshape(B, K),
                np.frombuffer(dn_b, np.uint8),
                use_full,
                np.frombuffer(df_b, np.int32),
            )
        dst_pos = np.zeros(B, np.int32)
        paint = np.zeros((B, R + 1), np.int16)
        rows_parts: list[np.ndarray] = []
        rr_parts: list[np.ndarray] = []
        ll_parts: list[np.ndarray] = []

        for rid in np.unique(ref_ids):
            idx = np.flatnonzero(ref_ids == rid)
            pe = self.events[rid]
            sgv = self.src_gv[rid]
            if pe is None:
                raise ValueError(f"record references index-less ref id {rid}")
            p = pos[idx].astype(np.int64)
            n = np.minimum(n_units[idx].astype(np.int64), R)

            u = np.clip(p, 0, max(0, sgv.n_zeros - 1))
            dst_pos[idx] = project_unit(pe, u).astype(np.int32)

            if pe.gap_start.size:
                lo = np.searchsorted(pe.gap_end, p, side="left")
                hi = np.searchsorted(pe.gap_start, p + n, side="left")
                cnt = np.maximum(hi - lo, 0)
                if cnt.any():
                    rows = np.repeat(idx, cnt)
                    ev = np.repeat(lo, cnt) + _ranges(cnt)
                    pr = np.repeat(p, cnt)
                    a = np.maximum(pe.gap_start[ev] - pr, 0)
                    b = np.minimum(pe.gap_end[ev] - pr, np.repeat(n, cnt) - 1)
                    keep = a <= b
                    np.add.at(paint, (rows[keep], a[keep]), 1)
                    np.add.at(paint, (rows[keep], b[keep] + 1), -1)

            if pe.del_b.size:
                lo = np.searchsorted(pe.del_b, p + 1, side="left")
                hi = np.searchsorted(pe.del_b, p + n, side="left")
                cnt = np.maximum(hi - lo, 0)
                if cnt.any():
                    rows = np.repeat(idx, cnt)
                    ev = np.repeat(lo, cnt) + _ranges(cnt)
                    rows_parts.append(rows)
                    rr_parts.append(pe.del_b[ev] - np.repeat(p, cnt))
                    ll_parts.append(pe.del_len[ev])

        isgap = np.cumsum(paint[:, :R], axis=1) > 0
        gapbits = np.packbits(isgap, axis=1, bitorder="little")

        if rows_parts:
            rows = np.concatenate(rows_parts)
            rr = np.concatenate(rr_parts)
            ll = np.concatenate(ll_parts)
        else:
            rows = rr = ll = np.zeros(0, np.int64)
        counts = np.bincount(rows, minlength=B) if rows.size else np.zeros(B, np.int64)
        use_full = (
            R > 255
            or (counts > K).any()
            or bool(ll.size and ll.max() > 255)
        )
        d_vals = np.zeros((B, K), np.uint8)
        d_pos = np.zeros((B, K), np.uint8)
        d_n = np.zeros(B, np.uint8)
        d_full = np.zeros(0, np.int32)
        if use_full:
            d_full = np.zeros((B, R), np.int32)
            if rows.size:
                np.add.at(d_full, (rows, rr), ll)
            d_full = d_full.reshape(-1)
        elif rows.size:
            # per-row instances are contiguous and rr-ascending (events
            # are scanned in boundary order within each record)
            starts = np.r_[np.int64(0), np.flatnonzero(np.diff(rows)) + 1]
            run_lens = np.diff(np.r_[starts, rows.size])
            rel = np.arange(rows.size, dtype=np.int64) - np.repeat(
                np.arange(rows.size, dtype=np.int64)[starts], run_lens
            )
            d_vals[rows, rel] = ll
            d_pos[rows, rel] = rr
            d_n[:] = counts.astype(np.uint8)
        return dst_pos, gapbits, d_vals, d_pos, d_n, int(use_full), d_full
