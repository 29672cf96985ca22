"""Event-based projection geometry: O(#MSA-differences) instead of
O(reads x read-length) (counterpart of ``panvc3_tpu.ops.event_geometry``:
the host ``EventGeometry`` is a copy, ``DeviceEventGeometry`` the same
device math in plain PyTorch).

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

``build_pair_events`` derives them with whole-row NumPy passes and is the
reference; ``build_pair_events_c`` gets the same arrays from one C scan of
the packed words (``csrc_host/event_tables.c``, built with the host
compiler at first use and bound by ``ctypes``), which ``EventGeometry``
takes unless ``PANVC3_EVENT_GEOMETRY_NATIVE=0``.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shlex
import sysconfig
import threading
from dataclasses import dataclass

import numpy as np
import torch

from .._build import build_once, digest, run_compiler
from ..bitvec import GapBitVector
from ..native import cpu_id, get_native
from .rank_select import clamped, take
from .rewrite_batch import D_SPARSE_SLOTS, as_device, pos_bytes


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


SCAN_SOURCE = pathlib.Path(__file__).resolve().parent / "csrc_host" / "event_tables.c"
# -march=native: a build is only valid on the CPU it was made for
SCAN_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared")

_scan_lock = threading.Lock()
_scan_fn = None


def scan_library() -> pathlib.Path:
    """Path of the built scan (``build_root()/host/<digest>/``), building
    it first if needed."""
    cmd = shlex.split(sysconfig.get_config_var("CC") or "cc") + list(SCAN_FLAGS)
    key = digest([SCAN_SOURCE], cmd + [cpu_id()])

    def build(out: pathlib.Path, work: pathlib.Path) -> None:
        run_compiler([*cmd, "-o", str(out), str(SCAN_SOURCE)], "the event-table scan")

    return build_once("host", key, "libevent_tables.so", build)


def _scan():
    global _scan_fn
    with _scan_lock:
        if _scan_fn is None:
            fn = ctypes.CDLL(str(scan_library())).event_tables_scan
            P = ctypes.c_void_p
            fn.argtypes = [P, P, ctypes.c_int64, ctypes.c_int64, P, P, P, P, P]
            fn.restype = ctypes.c_int
            _scan_fn = fn
        return _scan_fn


def build_pair_events_c(src: GapBitVector, dst: GapBitVector) -> PairEvents:
    """``build_pair_events`` by one C scan of the packed words: the same
    arrays, byte for byte (two passes: count, then fill)."""
    fn = _scan()
    s = np.ascontiguousarray(src.words, dtype=np.uint32)
    d = np.ascontiguousarray(dst.words, dtype=np.uint32)
    n_words = min(len(s), len(d))
    limit = min(src.n, dst.n)
    counts = np.zeros(2, np.int64)
    fn(s.ctypes.data, d.ctypes.data, n_words, limit, None, None, None, None,
       counts.ctypes.data)
    gap_start, gap_end = np.empty(counts[0], np.int64), np.empty(counts[0], np.int64)
    del_b, del_len = np.empty(counts[1], np.int64), np.empty(counts[1], np.int64)
    fn(s.ctypes.data, d.ctypes.data, n_words, limit, gap_start.ctypes.data,
       gap_end.ctypes.data, del_b.ctypes.data, del_len.ctypes.data, counts.ctypes.data)
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
    ``PANVC3_EVENT_GEOMETRY_NATIVE=0`` builds the tables and answers
    ``batch`` in NumPy; otherwise both run in C.  ``pairs_built`` counts
    the distinct pairs whose tables were built, by path
    (``event_pairs_c``, ``event_pairs_numpy``).
    """

    def __init__(self, src_entries, dst_entries, ref_id_mapping):
        native = os.environ.get("PANVC3_EVENT_GEOMETRY_NATIVE") != "0"
        build = build_pair_events_c if native else build_pair_events
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
                cache[key] = build(s, d)
            self.events.append(cache[key])
        self.pairs_built = {
            "event_pairs_c": len(cache) if native else 0,
            "event_pairs_numpy": 0 if native else len(cache),
        }

        # native fast path (the C host extension's event_geometry_batch):
        # per-rid buffer tuples
        self._native = None
        self._native_group: list[tuple | None] = []
        if native:
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


class DeviceEventGeometry:
    """Event tables on one device and the event-geometry kernel.

    Counterpart of ``panvc3_tpu.ops.event_geometry.DeviceEventGeometry``:
    the kernel binary-searches the per-pair difference-event tables
    (fixed trips, optionally narrowed by a rank-bucket index) and decodes a
    bounded number of events per record with one-hot compares.  Outputs
    are bit-identical to the gap kernel's packed outputs on the valid
    region whenever no record overflows the event slots; ``overflow``
    reports slot and width overruns, and the caller then falls back to the
    host event path.  Plain PyTorch: the gathers clamp as XLA's do
    (``take``, ``clamped``).

    The tables come from the host ``EventGeometry`` (a few MB per genome:
    events scale with MSA differences, not length); ``numpy_state`` /
    ``from_numpy_state`` carry them in the JAX object's attribute names.
    """

    GAP_SLOTS = 8   # dst-gap runs a record may overlap
    DEL_SLOTS = 8   # deletion boundaries a record may overlap (= K)

    # tables that live on the device; every other state entry is host data
    DEVICE_TABLES = ("search_tab", "bucket_tab", "meta_tab", "post_tab")

    def __init__(self, host_geo: "EventGeometry", device="cuda"):
        self._load(self._tables(host_geo), torch.device(device))

    @classmethod
    def from_numpy_state(cls, state: dict, device) -> "DeviceEventGeometry":
        geo = cls.__new__(cls)
        geo._load(state, torch.device(device))
        return geo

    def numpy_state(self) -> dict:
        """Every table and scalar, the device tables as numpy."""
        return {
            k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in self._state.items()
        }

    def _load(self, state: dict, device: torch.device) -> None:
        self._state = {}
        for key, val in state.items():
            if key in self.DEVICE_TABLES:
                val = torch.from_numpy(np.require(val, np.int32, ["C", "W"])).to(device)
            elif isinstance(val, np.ndarray):
                val = val.copy()
            self._state[key] = val
            setattr(self, key, val)
        self.device = device
        self._meta_t = self.meta_tab.t().contiguous()  # one row per pair
        self._eff_cache: dict[int, tuple[int, int]] = {}

    def to(self, device) -> "DeviceEventGeometry":
        """The geometry on ``device``: each device table copied once,
        device to device, the host data shared (self where it is there
        already)."""
        device = torch.device(device)
        if device == self.search_tab.device:
            return self
        geo = type(self).__new__(type(self))
        geo._state = {
            k: (v.to(device) if isinstance(v, torch.Tensor) else v) for k, v in self._state.items()
        }
        for key, val in geo._state.items():
            setattr(geo, key, val)
        geo.device = device
        geo._meta_t = self._meta_t.to(device)
        geo._eff_cache = self._eff_cache  # a function of the host tables alone
        return geo

    @staticmethod
    def _tables(host_geo) -> dict:
        """The tables of the JAX object, in numpy, under its attribute
        names."""
        gs_parts, ge_parts, db_parts, dl_parts = [], [], [], []
        gap_off, del_off = [0], [0]
        nzeros = []
        for pe, sgv in zip(host_geo.events, host_geo.src_gv):
            nzeros.append(sgv.n_zeros if sgv is not None else 0)
            if pe is None:
                gap_off.append(gap_off[-1])
                del_off.append(del_off[-1])
                continue
            gs_parts.append(pe.gap_start)
            ge_parts.append(pe.gap_end)
            db_parts.append(pe.del_b)
            dl_parts.append(pe.del_len)
            gap_off.append(gap_off[-1] + len(pe.gap_start))
            del_off.append(del_off[-1] + len(pe.del_b))

        def cat(parts):
            a = np.concatenate(parts).astype(np.int32) if parts else np.zeros(0, np.int64)
            # one sentinel so fixed-trip searches can clamp safely
            return np.r_[a, np.int32(2**31 - 1)].astype(np.int32)

        def catsum(parts):
            # global cumulative sums; per-pair values are differences
            # against the value at the pair's base offset
            a = np.concatenate(parts).astype(np.int64) if parts else np.zeros(0, np.int64)
            return np.r_[np.int64(0), np.cumsum(a)].astype(np.int32)

        st = {}
        st["gap_start"] = gap_start = cat(gs_parts)
        st["gap_end"] = gap_end = cat(ge_parts)
        st["del_b"] = del_b = cat(db_parts)
        st["del_len"] = del_len = cat(dl_parts)
        st["gap_clen"] = gap_clen = catsum(
            [pe_ge - pe_gs + 1 for pe_gs, pe_ge in zip(gs_parts, ge_parts)]
        )
        st["del_clen"] = del_clen = catsum(dl_parts)
        st["max_gap"] = int(np.max(np.diff(gap_off), initial=0))
        st["max_del"] = int(np.max(np.diff(del_off), initial=0))
        # one concatenated search table: the kernel's searches run as one
        # fixed-trip loop over stacked queries
        ge_n = int(gap_end.shape[0])
        gs_n = int(gap_start.shape[0])
        st["search_tab"] = tab = np.concatenate([gap_end, gap_start, del_b])
        st["base_gap_end"] = 0
        st["base_gap_start"] = ge_n
        st["base_del_b"] = ge_n + gs_n

        # Two-level search: bucket j of pair p holds the first table index
        # with value >= j << BUCKET_SHIFT; query q searches [bucket[q>>S],
        # bucket[q>>S + 1]].  S auto-tunes so the densest pair averages ~2
        # events per bucket, clamped to [6, 12];
        # PANVC3_EVENT_BUCKET_SHIFT overrides.
        go_h = np.asarray(gap_off, np.int64)
        do_h = np.asarray(del_off, np.int64)
        n_pairs = len(go_h) - 1
        env_s = os.environ.get("PANVC3_EVENT_BUCKET_SHIFT")
        if env_s:
            S = max(1, int(env_s))
        else:
            S = 12
            for pp in range(n_pairs):
                ev_n = max(
                    int(go_h[pp + 1] - go_h[pp]), int(do_h[pp + 1] - do_h[pp]), 1
                )
                nz_p = max(int(nzeros[pp]), 1)
                S = min(S, max(6, int(np.log2(max(2 * nz_p // ev_n, 1)))))
        st["BUCKET_SHIFT"] = S
        bucket_parts = []
        bucket_off = [0]
        max_occ = 0
        for p in range(n_pairs):
            nz = int(nzeros[p])
            nb = (max(nz + 1, 1) >> S) + 1
            thresholds = np.arange(nb + 1, dtype=np.int64) << S
            row_parts = []
            for base, off in (
                (st["base_gap_end"], go_h),
                (st["base_gap_start"], go_h),
                (st["base_del_b"], do_h),
            ):
                lo = base + int(off[p])
                hi = base + int(off[p + 1])
                bs = lo + np.searchsorted(tab[lo:hi], thresholds, side="left")
                max_occ = max(max_occ, int(np.max(np.diff(bs), initial=0)))
                row_parts.append(bs.astype(np.int32))
            # per pair: [gap_end | gap_start | del_b] rows of nb+1 entries
            bucket_parts.append(np.concatenate(row_parts))
            bucket_off.append(bucket_off[-1] + 3 * (nb + 1))
        st["bucket_tab"] = (
            np.concatenate(bucket_parts) if bucket_parts else np.zeros(1, np.int32)
        )
        st["bucket_steps"] = max(1, int(np.ceil(np.log2(max_occ + 1))) + 1)

        # per-pair scalars in one gather (rows 7-9 let the kernel derive
        # the initial-position searches, see slots())
        last_ge = np.where(
            go_h[1:] > go_h[:-1], gap_end[np.maximum(go_h[1:] - 1, 0)], np.int32(-1)
        ).astype(np.int32)
        first_db = np.where(
            do_h[1:] > do_h[:-1],
            del_b[np.minimum(do_h[:-1], max(len(del_b) - 1, 0))],
            np.int32(-1),
        ).astype(np.int32)
        last_db = np.where(
            do_h[1:] > do_h[:-1], del_b[np.maximum(do_h[1:] - 1, 0)], np.int32(-1)
        ).astype(np.int32)
        st["meta_tab"] = np.stack([
            np.asarray(gap_off[:-1], np.int32),   # 0: g_lo0
            np.asarray(gap_off[1:], np.int32),    # 1: g_hi0
            np.asarray(del_off[:-1], np.int32),   # 2: d_lo
            np.asarray(del_off[1:], np.int32),    # 3: d_hi
            np.asarray(nzeros, np.int32),         # 4: n_zeros
            np.asarray(bucket_off[:-1], np.int32),  # 5: bucket base
            np.asarray(np.diff(bucket_off) // 3, np.int32),  # 6: row len
            last_ge,                              # 7: pair's last gap_end
            first_db,                             # 8: pair's first del_b
            last_db,                              # 9: pair's last del_b
        ])

        # interleaved post-search table:
        #   [gs0 ge0 gs1 ge1 ... | db0 dl0 db1 dl1 ... | gap_clen | del_clen]
        ndel = int(del_b.shape[0])
        slot_np = np.empty(2 * (ge_n + ndel), np.int32)
        slot_np[0:2 * ge_n:2] = gap_start
        slot_np[1:2 * ge_n:2] = gap_end
        st["base_del_il"] = 2 * ge_n
        slot_np[2 * ge_n::2] = del_b
        slot_np[2 * ge_n + 1::2] = del_len
        st["base_gap_clen"] = len(slot_np)
        st["base_del_clen"] = len(slot_np) + len(gap_clen)
        st["post_tab"] = np.concatenate([slot_np, gap_clen, del_clen])
        st["_gap_off_np"] = go_h
        st["_del_off_np"] = do_h
        return st

    def effective_slots(self, R: int) -> tuple[int, int]:
        """Tight slot widths for records spanning <= R units: for a window
        whose first overlapped gap event is i, the overlap count is at most
        searchsorted(gap_start, gap_end[i] + R) - i; deletions likewise.
        Records can never overflow these, which are clamped to the wire
        maxima GAP_SLOTS/DEL_SLOTS."""
        hit = self._eff_cache.get(R)
        if hit is not None:
            return hit
        kg = kd = 1
        go, do = self._gap_off_np, self._del_off_np
        for pp in range(len(go) - 1):
            gs = self.gap_start[go[pp]:go[pp + 1]]
            ge = self.gap_end[go[pp]:go[pp + 1]]
            if len(gs):
                kg = max(kg, int(np.max(
                    np.searchsorted(gs, ge.astype(np.int64) + R) - np.arange(len(gs))
                )))
            db = self.del_b[do[pp]:do[pp + 1]]
            if len(db):
                kd = max(kd, int(np.max(
                    np.searchsorted(db, db.astype(np.int64) + R) - np.arange(len(db))
                )))
        out = (min(kg, self.GAP_SLOTS), min(kd, self.DEL_SLOTS))
        self._eff_cache[R] = out
        return out

    def slots(self, ref_ids, pos, n_units, R: int):
        """Decode the record-relative event slots.

        Returns ``(initial, a, b, gcnt, d_rel, d_len, dcnt, overflow)``:
        ``a``/``b`` [B, kg] record-relative ref-rank bounds of the
        overlapping dst-gap runs (clipped to [0, n-1]; invalid slots a=R,
        b=-1), ``d_rel``/``d_len`` [B, kd] record-relative deletion
        boundaries and their dst-base counts (invalid slots zero);
        (kg, kd) = ``effective_slots(R)``.  ``overflow`` counts records
        whose events exceed the slots."""
        dev = self.device
        ref_ids = as_device(ref_ids, dev)
        p = as_device(pos, dev).long()
        n = torch.clamp(as_device(n_units, dev).long(), max=R)

        def searchsorted(table, off_lo, off_hi, value, steps):
            # first index in [off_lo, off_hi) with table[i] >= value
            lo, hi = off_lo, off_hi
            for _ in range(steps):
                mid = (lo + hi) >> 1
                go_right = (clamped(table, mid) < value) & (mid < hi)
                lo = torch.where(go_right, mid + 1, lo)
                hi = torch.where(go_right, hi, mid)
            return lo

        gsteps = max(1, int(np.ceil(np.log2(self.max_gap + 1))) + 1)
        dsteps = max(1, int(np.ceil(np.log2(self.max_del + 1))) + 1)
        meta = take(self._meta_t, ref_ids).long().t()       # (10, B)
        g_lo0, g_hi0, d_lo, d_hi = meta[0], meta[1], meta[2], meta[3]

        # initial = u - G(u) + D(u) over the event prefix sums (see
        # project_unit)
        last_rank = torch.clamp(meta[4] - 1, min=0)
        u = torch.minimum(torch.clamp(p, min=0), last_rank)

        # four stacked searches; the initial-position searches derive from
        # them (see the JAX version's lane-derivation note)
        bgs = self.base_gap_start
        bdb = self.base_del_b
        steps = max(gsteps, dsteps)
        q_val = torch.stack([p, p + n, p + 1, p + n])
        if (
            self.bucket_steps + 2 < steps
            and os.environ.get("PANVC3_EVENT_BUCKETS") != "0"
        ):
            # two-level: the rank-bucket index narrows each search window
            row_len = meta[6][None, :]
            r_t = torch.tensor([0, 1, 2, 2], dtype=torch.int64, device=dev)[:, None]
            j = torch.minimum(
                torch.clamp(q_val >> self.BUCKET_SHIFT, min=0), row_len - 2
            )
            slot = meta[5][None, :] + r_t * row_len + j
            bt = take(self.bucket_tab, torch.stack([slot, slot + 1])).long()
            res = searchsorted(self.search_tab, bt[0], bt[1], q_val, self.bucket_steps)
        else:
            q_lo = torch.stack([g_lo0, g_lo0 + bgs, d_lo + bdb, d_lo + bdb])
            q_hi = torch.stack([g_hi0, g_hi0 + bgs, d_hi + bdb, d_hi + bdb])
            res = searchsorted(self.search_tab, q_lo, q_hi, q_val, steps)
        lo = res[0]
        hi = res[1] - bgs
        dlo = res[2] - bdb
        dhi = res[3] - bdb
        # meta rows 7-9 are -1 for empty tables, so these compares are false
        # there
        over_end = p > last_rank
        ju = torch.where(
            over_end,
            g_hi0 - ((meta[7] == meta[4] - 1) & (g_hi0 > g_lo0)).long(),
            lo,
        )
        jd = torch.where(
            over_end,
            d_hi - ((meta[9] == meta[4]) & (meta[4] >= 1)).long(),
            torch.where(p >= 0, dlo, d_lo + (meta[8] == 0).long()),
        )

        gcnt = torch.clamp(hi - lo, min=0)
        dcnt = torch.clamp(dhi - dlo, min=0)

        # every post-search lookup in one gather over the interleaved table
        KG, K = self.effective_slots(R)
        kk = torch.arange(KG, dtype=torch.int64, device=dev)[None, :]
        dk = torch.arange(K, dtype=torch.int64, device=dev)[None, :]
        n_gs = self.gap_start.shape[0]
        ev = 2 * torch.clamp(lo[:, None] + kk, 0, n_gs - 1)
        dev_i = self.base_del_il + 2 * torch.clamp(
            dlo[:, None] + dk, 0, self.del_b.shape[0] - 1
        )
        ju_c = 2 * torch.clamp(ju, 0, n_gs - 1)
        bgc = self.base_gap_clen
        bdc = self.base_del_clen
        post_idx = torch.cat(
            [
                ev, ev + 1, dev_i, dev_i + 1,
                ju_c[:, None],
                (bgc + ju)[:, None], (bgc + g_lo0)[:, None],
                (bdc + jd)[:, None], (bdc + d_lo)[:, None],
            ],
            dim=1,
        )
        vals = take(self.post_tab, post_idx).long()   # (B, 2KG + 2K + 5)
        gs_v = vals[:, :KG]
        ge_v = vals[:, KG:2 * KG]
        db_v = vals[:, 2 * KG:2 * KG + K]
        dl_v = vals[:, 2 * KG + K:2 * KG + 2 * K]
        c0 = 2 * KG + 2 * K

        # iu > ju  <=>  gap_start[ju] < u
        straddle = torch.where(ju < g_hi0, torch.clamp(u - vals[:, c0], min=0), 0)
        g_cov = vals[:, c0 + 1] - vals[:, c0 + 2] + straddle
        d_cov = vals[:, c0 + 3] - vals[:, c0 + 4]
        initial = (u - g_cov + d_cov).int()

        ev_valid = kk < gcnt[:, None]
        a = torch.where(ev_valid, gs_v - p[:, None], R)
        b = torch.where(ev_valid, ge_v - p[:, None], -1)
        a = torch.clamp(a, min=0)
        b = torch.minimum(b, n[:, None] - 1)

        dvalid = dk < dcnt[:, None]
        d_pos_i = torch.where(dvalid, db_v - p[:, None], 0)
        d_len_i = torch.where(dvalid, dl_v, 0)

        overflow = ((gcnt > KG).sum() + (dcnt > K).sum()).int()
        return initial, a, b, gcnt, d_pos_i, d_len_i, dcnt, overflow

    def pack_isgap(self, a, b, R: int):
        """Little-endian per-record gap bitmask u8[B, R/8] from the clipped
        gap-run slot bounds: a (B, slots, R) interval compare, any-reduced."""
        B = a.shape[0]
        r = torch.arange(R, dtype=torch.int64, device=a.device)[None, None, :]
        isgap = ((a[:, :, None] <= r) & (r <= b[:, :, None])).any(dim=1)
        bits = isgap.int().reshape(B, R // 8, 8)
        weights = (1 << torch.arange(8, dtype=torch.int32, device=a.device))[None, None, :]
        return (bits * weights).sum(dim=2).to(torch.uint8)

    def kernel(self, ref_ids, pos, n_units, R: int):
        """(initial, gapbits, d_vals, d_pos, d_n8, overflow): the layout of
        the gap kernel's packed outputs minus the full deletion runs."""
        initial, a, b, gcnt, d_pos_i, d_len_i, dcnt, ov_slots = self.slots(
            ref_ids, pos, n_units, R
        )
        gapbits = self.pack_isgap(a, b, R)
        # zero-pad the effective slot widths back to the wire width
        wpad = D_SPARSE_SLOTS - d_len_i.shape[1]
        d_vals = torch.nn.functional.pad(
            torch.clamp(d_len_i, max=255) & 0xFF, (0, wpad)
        ).to(torch.uint8)
        d_pos = torch.nn.functional.pad(
            torch.clamp(d_pos_i, max=255) & 0xFF, (0, wpad)
        ).to(torch.uint8)
        d_n8 = torch.clamp(dcnt, max=255).to(torch.uint8)
        overflow = (
            ov_slots + (d_len_i >= 255).sum() + (1 if R > 255 else 0)
        ).int()
        return initial, gapbits, d_vals, d_pos, d_n8, overflow

    def kernel_wire(self, ref_ids, pos, n_units, R: int):
        """One u8 buffer in the gap wire's row layout: [dst_pos i32 LE |
        d_n u8 | gapbits R/8 | d_pos K | d_vals K], and ``overflow``
        (callers fall back to the host event geometry when it is not 0)."""
        initial, gapbits, d_vals, d_pos, d_n8, overflow = self.kernel(
            ref_ids, pos, n_units, R
        )
        wire = torch.cat(
            [pos_bytes(initial), d_n8[:, None], gapbits, d_pos, d_vals], dim=1
        )
        return wire, overflow
