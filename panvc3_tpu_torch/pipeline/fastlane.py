"""Native-batch fast lane for project_alignments (SAM text -> SAM text).

Counterpart of ``panvc3_tpu.pipeline.fastlane.run_fast``.  Records stay
native end to end: raw line bytes -> C ``parse_stage_batch`` -> host
event geometry -> C ``finalize_reconstruct`` -> C ``stage_realign_runs``
-> realignment -> C ``splice_apply_format`` -> SAM text.  Python moves
numpy arrays between those steps.  BAM input skips the text: the BAM
ingest (``io/bam_ingest.py``) stages its batches straight from the binary
records, on a thread of its own ahead of the main thread.

The realignment of each batch's indel runs takes one of two lanes, chosen
per batch by a ``LaneController``: the host C DP, or the device lane,
which runs the DP as the hand-written CUDA kernels (``ops/csrc``).  With
the threaded drain, device-lane batches defer their runs; the writer
thread pools the runs of several batches into one aggregate dispatch
(``_dispatch_aggregate``): gathered from the flat reference resident on
the device (the ref-gather wires), length-sorted, and restored to input
order at fetch.  Each dispatch copies its result into pinned host memory
on the stream that ran the kernel and records an event after the copy;
the fetch pool waits on that event.

The rewrite geometry of each batch comes from one of three places, chosen
by ``PANVC3_EVENT_GEOMETRY``: the host event geometry (unset or ``1``), the
device event geometry (``device``: ``DeviceEventGeometry.kernel_wire``,
with the host event path as the fallback on event-slot overflow), or the
gap kernel over the device gap index (``0``: ``rewrite_gap_kernel_wire``,
with a fetch of the full deletion runs on overflow).  Integer scoring and
quality scoring (``-q``: the Malde tables with the reference qualities
pinned to phred42 max, gap costs x ``MALDE_SCALE`` on every lane) are
covered.  Output is byte-identical to ``panvc3_tpu``'s fast lane and
object path; the ordering invariants are those of the original
(CLAUDE.md): one writer thread emits in submission order, every fetch
goes through ``_restore``, and ``PANVC3_FASTLANE_CHAOS`` jitters every
cross-thread handoff.
"""

from __future__ import annotations

import json
import os
import threading
import time as _time

import numpy as np
import torch

from .. import tracing
from ..align import MALDE_SCALE, malde_tables
from ..io.bam_ingest import BamIngest, IngestThread
from ..native import get_native
from ..ops import _kernels
from ..ops.engine import next_pow2
from ..ops.event_geometry import DeviceEventGeometry, EventGeometry, project_unit
from ..ops.fetch import DeviceFetch
from ..ops.realign_batch import (
    QUAL_MAX_STEPS,
    _realign_wire,
    _realign_wire_q,
    _realign_wire_refgather,
    _realign_wire_refgather2,
    _realign_wire_refgather2_q,
    _realign_wire_refgather_q,
    pack_realign_refgather2_input,
    pack_realign_refgather2_input_q,
    pack_realign_refgather_input,
    pack_realign_refgather_input_q,
    pack_realign_wire_input,
    pack_realign_wire_input_q,
    query_wire2_eligible,
    realign_device_kernel,
    unpack_realign_refgather_wire,
    unpack_realign_wire,
)
from ..ops.rewrite_batch import (
    D_SPARSE_SLOTS,
    pack_gap_wire_input,
    rewrite_gap_kernel_wire,
    unpack_gap_wire,
)
from ..utils import StatusReporter, format_duration, log_time

FLAG_SKIP = 0x4 | 0x200 | 0x400  # unmapped | QC fail | duplicate

# Diagnostics (read by tests and printed as the [fastlane diag] line under
# PANVC3_FASTLANE_PROF=1), process-wide running totals: counts of
# aggregate dispatches and of the wire/layout variants that engaged, the
# realignment runs and their cells (rl x ql) by lane (``dp_runs_host``,
# ``dp_cells_host``, ``dp_runs_dev``, ``dp_cells_dev``) and the cells the
# device lane's kernels compute, padding included
# (``dp_cells_dev_launched``) and, under ``-q``, the bytes of query phreds
# staged and copied to the card (``qual_bytes_dev``: the wire's phred
# bytes, or the unwired dispatch's u8 rows), all mutated only on the writer
# thread; of batches whose device rewrite geometry overflowed
# (``geometry_overflow``, under _DIAG_LOCK); of the runs of batches that
# ``-q`` keeps off the host lane, too long for the quantised scores
# (``qual_runs_off_host``: Rp + Qp > QUAL_MAX_STEPS, under _DIAG_LOCK; both
# device paths then refuse the batch); and of the distinct (src, dst)
# pairs whose event tables a call built, by path (``event_pairs_c``,
# ``event_pairs_numpy``: ``EventGeometry.pairs_built``, added on the main
# thread at set-up; the line shows the call's own); and of the batches
# staged, by path (``ingest_batches_bam``: the BAM ingest's;
# ``ingest_batches_text``: ``parse_stage_batch``'s over text lines; under
# _DIAG_LOCK; the line shows the call's own, beside its ``batches``).
AGG_DIAG = {
    "dispatches": 0, "wire2": 0, "sorted": 0, "refgather": 0,
    "geometry_overflow": 0,
    "dp_runs_host": 0, "dp_cells_host": 0, "dp_runs_dev": 0, "dp_cells_dev": 0,
    "dp_cells_dev_launched": 0, "qual_bytes_dev": 0, "qual_runs_off_host": 0,
    "event_pairs_c": 0, "event_pairs_numpy": 0,
    "ingest_batches_bam": 0, "ingest_batches_text": 0,
}
INGEST_KEYS = ("ingest_batches_bam", "ingest_batches_text")
# staged batches the BAM ingest's thread keeps ready for the main thread
INGEST_DEPTH = 4
_DIAG_LOCK = threading.Lock()


class LaneController:
    """End-to-end adaptive host/device realign-lane choice (copy of
    ``panvc3_tpu.pipeline.fastlane.LaneController``; its priors and
    constants were tuned on the TPU and are to be re-tuned on the card,
    ROADMAP Queue 1 item 2).

    A pure cost inequality (cells x host_ns_cell <= device_batch_ns)
    compares raw per-batch costs, but the two lanes load different parts
    of the pipeline: the host C DP runs inside the worker pool while the
    device lane adds writer-thread dispatch and fetch to the ordered
    drain's critical path.  This controller measures per-lane throughput
    over epochs — contiguous same-lane spans of emitted batches, clocked
    from the span's first emit to its last — with periodic probe windows
    on the other lane and a 10% switch hysteresis.  Per-batch inter-emit
    gaps would be biased: a deferred device batch at the drain's head dams
    completed host payloads, which then emit back to back.  The raw cost
    EMAs survive as overrides for extreme batches only.

    Process-global: the EMAs describe the hardware, so every run in the
    process shares and refines them; ``begin_run`` resets only the per-run
    span state.
    """

    PROBE_PERIOD = 48    # decisions between probe windows
    PROBE_LEN = 6        # consecutive probe decisions (one measurable span)
    # an unmeasured (or once-measured) lane is probed at this shorter
    # period, so a short adaptive run does not finish on the slow initial
    # mode
    BOOTSTRAP_PERIOD = 24
    BOOTSTRAP_SPANS = 2  # spans a lane needs before normal cadence applies
    HYSTERESIS = 0.9     # switch only on a >=10% measured win
    # cost ratios that force a lane; wide, because dev_ns_batch is
    # amortized over an aggregate window and reads several times the true
    # per-batch cost
    OVERRIDE_HOST = 64.0
    OVERRIDE_DEV = 64.0
    BACKOFF_MAX = 16     # probe-period multiplier when the probe keeps losing
    # a probe that loses by more than this ratio grows the back-off, so a
    # clearly decided race is probed rarely and a near tie closely
    BACKOFF_LOSS_RATIO = 1.3
    # close and restart a long same-lane span every N batches, so the
    # active lane's EMA refreshes and its degradation shows without a probe
    SPAN_CLOSE_BATCHES = 12
    # shorter spans measure lane-transition turbulence, not throughput:
    # discard them (probe windows count PROBE_LEN-1 batches and stay)
    MIN_SPAN_BATCHES = 5
    # a drain dam burst can emit a whole span in near-zero wall time: clamp
    # a span far faster than every lane's EMA to this fraction of the best
    BURST_FLOOR_FRACTION = 0.25

    def __init__(self):
        self.lock = threading.Lock()
        # cost EMAs; priors reproduce the historical 4e6-cell threshold
        self.host_ns_cell = 4.0
        self.dev_ns_batch = 16e6
        self.ns_read = {"host": None, "dev": None}
        self.span_count = {"host": 0, "dev": 0}
        self.span_discards = {"host": 0, "dev": 0}
        self.regime_cells_per_read = None
        self._regime_outliers = 0
        self._regime_cooldown = 0
        # burst floor carried across a regime reset (dam bursts are a
        # steady-state artifact, so the first post-reset span needs the
        # protection too); imperfect across regimes but directionally
        # conservative
        self._carried_floor = None
        self.mode = "host"
        self.tick = 0
        self.backoff = 1
        # current same-lane span: lane, first-emit clock, reads since
        self.span_lane = None
        self.span_start_ns = 0
        self.span_last_ns = 0
        self.span_reads = 0
        self.span_batches = 0

    def begin_run(self):
        with self.lock:
            # CLOSE the previous run's open span (its clock ends at its
            # last emit, so cross-run idle time is not counted) instead
            # of dropping it: probe windows fire at the END of each
            # period, which can align with the end of a run, and dropping
            # the open span would discard every bootstrap probe
            # measurement, locking the controller on the initial mode
            self._close_span()
            self.span_lane = None
            self.span_reads = 0
            self.span_batches = 0
            # a tail fragment at stream end is structural, not evidence
            # of chronic fragmentation — don't let run boundaries arm the
            # fragment escape hatch across runs
            self.span_discards = {"host": 0, "dev": 0}

    def decide(self, real_cells: int) -> bool:
        """True -> host C DP; False -> device lane."""
        with self.lock:
            host_ns = real_cells * self.host_ns_cell
            if host_ns > self.OVERRIDE_DEV * self.dev_ns_batch:
                return False
            if self.OVERRIDE_HOST * host_ns < self.dev_ns_batch:
                return True
            self.tick += 1
            # probe at the END of each period (a start-of-period window
            # would penalize short streams, whose first batches all land
            # in it), with exponential back-off while probes keep losing
            period = self.PROBE_PERIOD * self.backoff
            other = "dev" if self.mode == "host" else "host"
            if self.span_count[other] < self.BOOTSTRAP_SPANS:
                # bootstrap cadence; the first PROBE_LEN batches stay on
                # the current mode so the pipeline settles before a span
                # is worth measuring
                if self.tick <= self.PROBE_LEN:
                    return self.mode == "host"
                period = self.BOOTSTRAP_PERIOD
            elif self.backoff == 1 and os.environ.get(
                "PANVC3_LANE_MIX", "0"
            ) == "1":
                # graduated duty (opt-in, default off): when the lanes
                # measure close, send the "losing" lane real work at a
                # higher duty cycle.  On the TPU host the rare-probe
                # cadence measured better end to end (higher duty
                # fragments the aggregate windows and loads the writer
                # thread more than the overlap repays); kept for wider
                # hosts, and to be measured on the card's.
                h, d = self.ns_read["host"], self.ns_read["dev"]
                if h is not None and d is not None:
                    ratio = max(h, d) / max(min(h, d), 1e-9)
                    if ratio <= 1.15:
                        period = 2 * self.PROBE_LEN  # alternate 50/50
                    elif ratio <= 1.5:
                        period = 4 * self.PROBE_LEN
            if self.tick % period >= period - self.PROBE_LEN:
                return self.mode != "host"  # probe the other lane
            return self.mode == "host"

    def observe_host_dp(self, ns: float, cells: int):
        with self.lock:
            self.host_ns_cell = 0.7 * self.host_ns_cell + 0.3 * ns / cells

    def observe_dev_batch(self, total_ns: float):
        with self.lock:
            self.dev_ns_batch = 0.7 * self.dev_ns_batch + 0.3 * total_ns

    def _close_span(self):
        # record the finished span's ns/read (clocked from its FIRST emit,
        # so the lane-transition turbulence of batch 1 is excluded)
        elapsed = self.span_last_ns - self.span_start_ns
        if self.span_lane is not None and self.span_reads > 0 and elapsed > 0:
            if self.span_batches < self.MIN_SPAN_BATCHES:
                # fragment — but a workload whose spans are ALWAYS cut
                # short (e.g. trivial override-routed batches interleaving
                # every few heavy ones) must not freeze the EMAs entirely:
                # after 3 consecutive discards on a lane, accept >=2-batch
                # fragments until a full span records again
                if not (
                    self.span_discards[self.span_lane] >= 3
                    and self.span_batches >= 2
                ):
                    self.span_discards[self.span_lane] += 1
                    return
            was_probe = self.span_lane != self.mode
            ns_read = elapsed / self.span_reads
            cur = self.ns_read[self.span_lane]
            known = [v for v in self.ns_read.values() if v is not None]
            if known or self._carried_floor is not None:
                floor = (
                    self.BURST_FLOOR_FRACTION * min(known)
                    if known
                    else self._carried_floor
                )
                if ns_read < floor:
                    # dam-burst span: cap its influence.  This applies to a
                    # lane's FIRST span too (adopt the floor, don't
                    # discard): a genuinely much faster lane measures below
                    # the floor legitimately, and discarding would lock
                    # bootstrap on the slow lane.  In the bogus-burst case
                    # the refresh spans pull the adopted value to reality.
                    ns_read = floor
            self.span_discards[self.span_lane] = 0
            self.ns_read[self.span_lane] = (
                ns_read if cur is None else 0.7 * cur + 0.3 * ns_read
            )
            self.span_count[self.span_lane] += 1
            h, d = self.ns_read["host"], self.ns_read["dev"]
            if h is not None and d is not None:
                if self.mode == "host" and d < self.HYSTERESIS * h:
                    self.mode = "dev"
                elif self.mode == "dev" and h < self.HYSTERESIS * d:
                    self.mode = "host"
                if was_probe:
                    mine = d if self.span_lane == "dev" else h
                    other = h if self.span_lane == "dev" else d
                    if self.span_lane == self.mode:
                        self.backoff = 1  # probe won: watch closely again
                    elif (
                        mine > self.BACKOFF_LOSS_RATIO * other
                        and self.span_count[self.span_lane]
                        >= self.BOOTSTRAP_SPANS
                    ):
                        # never back off on a lane's first spans: the
                        # very first device window may carry a fresh
                        # kernel compile, and parking the probe for
                        # BACKOFF_MAX periods on that evidence would
                        # freeze a wrong verdict
                        self.backoff = min(self.backoff * 2, self.BACKOFF_MAX)
                    else:
                        self.backoff = 1

    def observe_emit(
        self,
        dev_lane: bool,
        reads: int,
        now_ns: int,
        attribute: bool = True,
        cells: int = 0,
    ):
        """Writer-thread signal: one batch emitted.  ``attribute=False``
        (no realign runs — lane-neutral) joins the open span, if any,
        without being able to start or switch one.  ``cells`` (the
        batch's realignment DP cells) feeds workload-regime detection."""
        with self.lock:
            if not attribute:
                if self.span_lane is not None:
                    self.span_reads += reads
                    self.span_last_ns = now_ns
                return
            # ns/read EMAs are only comparable within one workload
            # regime: a mixed-workload span (realignment a tiny slice of
            # each batch) says nothing about a lane's rate on a
            # realign-heavy stream.  Track cells/read; when it shifts >4x,
            # reset to a fresh bootstrap.
            if reads > 0 and cells > 0:
                cpr = cells / reads
                reg = self.regime_cells_per_read
                if self._regime_cooldown > 0:
                    self._regime_cooldown -= 1
                if reg is None:
                    self.regime_cells_per_read = cpr
                elif cpr > 4.0 * reg or cpr < 0.25 * reg:
                    # two consecutive out-of-band batches = a real regime
                    # shift; one is just an outlier batch.  At most one
                    # reset per cooldown window: an OSCILLATING bimodal
                    # stream would otherwise re-bootstrap forever and
                    # never record a span — during cooldown the regime
                    # EMA blends fast (0.3) instead, so a persistent new
                    # regime re-centres without a second reset and an
                    # oscillation lands the centre mid-band where the 4x
                    # band covers both poles (pre-reset blended
                    # behaviour).
                    self._regime_outliers += 1
                    if self._regime_outliers >= 2:
                        self._regime_outliers = 0
                        if self._regime_cooldown == 0:
                            # carry a floor across the reset so the first
                            # post-reset span keeps dam-burst protection
                            known = [
                                v for v in self.ns_read.values()
                                if v is not None
                            ]
                            if known:
                                self._carried_floor = (
                                    self.BURST_FLOOR_FRACTION * min(known)
                                )
                            self.regime_cells_per_read = cpr
                            self.ns_read = {"host": None, "dev": None}
                            self.span_count = {"host": 0, "dev": 0}
                            self.span_discards = {"host": 0, "dev": 0}
                            self.backoff = 1
                            self.span_lane = None  # span mixes regimes
                            self._regime_cooldown = 96
                        else:
                            self.regime_cells_per_read = (
                                0.7 * reg + 0.3 * cpr
                            )
                else:
                    self._regime_outliers = 0
                    self.regime_cells_per_read = 0.9 * reg + 0.1 * cpr
            lane = "dev" if dev_lane else "host"
            if lane != self.span_lane:
                self._close_span()
                self.span_lane = lane
                self.span_start_ns = now_ns
                self.span_last_ns = now_ns
                self.span_reads = 0  # first batch only starts the clock
                self.span_batches = 0
            else:
                self.span_reads += reads
                self.span_last_ns = now_ns
                self.span_batches += 1
                if self.span_batches >= self.SPAN_CLOSE_BATCHES:
                    # periodic refresh: record the chunk and restart the
                    # span on the same lane (this emit is the new clock
                    # start) so active-lane degradation surfaces and the
                    # cross-lane switch check runs without a probe
                    self._close_span()
                    self.span_start_ns = now_ns
                    self.span_last_ns = now_ns
                    self.span_reads = 0
                    self.span_batches = 0


# the adaptive host/device realign-lane choice; process-global, since its
# EMAs describe the hardware (begin_run resets the per-run span state)
_ADAPT = LaneController()


def fastlane_eligible(cfg, mesh=None, batch_engine=None) -> bool:
    """Whether the fast lane runs this configuration; the caller takes the
    object path otherwise.  BAM input and output go through the C
    BAM<->SAM-text converters.  The fast lane is single-device: a mesh
    takes the object path.  Device sequence ids must fit the gap wire's
    u16 fields (a >65k-sequence index should be sharded with
    ``--msa-index-chr-shard``)."""
    return not cfg.fused_kernel and mesh is None and (
        batch_engine is None
        or max(
            max(batch_engine.src_dev_ids, default=0),
            max(batch_engine.dst_dev_ids, default=0),
        )
        < 65536
    )


def _pad_rows(a: np.ndarray, n_pad: int) -> np.ndarray:
    """``a`` with ``n_pad`` copies of its first row appended."""
    if not n_pad:
        return a
    return np.concatenate([a, np.repeat(a[:1], n_pad, axis=0)], axis=0)


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.require(a, requirements=["C", "W"])).to(device)


def run_fast(
    reader,
    writer,
    cfg,
    stats,
    batch_engine,
    input_header,
    out_header,
    src_entries,
    dst_entries,
    ref_id_mapping,
    ref_seqs,
    realigned_ranges,
):
    """Drive the full projection pipeline over raw line batches."""
    from .project_alignments import PRESERVED_TAGS

    bp = batch_engine
    nat = get_native()
    device = bp.device

    # the rewrite geometry: host event geometry (default), the device event
    # geometry (=device, host event path on overflow) or the gap kernel
    # over the device gap index (=0)
    event_geo = dev_event = dev_event_host = None
    ev_mode = os.environ.get("PANVC3_EVENT_GEOMETRY", "1")
    with tracing.span("setup_event_tables"):
        if ev_mode == "device":
            dev_event_host = EventGeometry(src_entries, dst_entries, ref_id_mapping)
            dev_event = DeviceEventGeometry(dev_event_host, device)
        elif ev_mode != "0":
            event_geo = EventGeometry(src_entries, dst_entries, ref_id_mapping)
    host_geo = event_geo or dev_event_host
    pairs_built = (host_geo.pairs_built if host_geo is not None
                   else {"event_pairs_c": 0, "event_pairs_numpy": 0})
    with _DIAG_LOCK:
        for key, n in pairs_built.items():
            AGG_DIAG[key] += n
        ingest_base = {key: AGG_DIAG[key] for key in INGEST_KEYS}

    refmap = {name.encode(): i for i, name in enumerate(input_header.ref_names)}
    rim = np.asarray(ref_id_mapping, dtype=np.int32)
    src_dev = np.asarray(bp.src_dev_ids, dtype=np.int32)
    dst_dev = np.asarray(bp.dst_dev_ids, dtype=np.int32)
    preserved = b"".join(
        sorted(
            t.encode()
            for t in (PRESERVED_TAGS | set(cfg.preserve_tags))
            if len(t) == 2
        )
    )
    t = cfg.tags
    tag_names = (
        t.original_rname, t.original_pos, t.original_rnext, t.original_pnext,
        t.realn_query_ranges, t.realn_ref_ranges, t.rec_idx,
    )
    out_names = list(out_header.ref_names)
    in_names = list(input_header.ref_names)
    primary_mask = 0x100 if cfg.primary_only else 0
    want_ranges = 1 if realigned_ranges is not None else 0

    batch_size = max(4, cfg.device_batch_size)
    # parse_stage_batch's least pads (O, R, Lq): the device event kernel
    # packs its gap bits 8 units per byte
    stage_pads = (4, 8 if dev_event is not None else 2, 2)
    go = np.float32(cfg.gap_opening_cost)
    ge = np.float32(cfg.gap_extension_cost)
    # quality scoring (-q): the DP runs in the quantised Malde units, so
    # every lane takes the gap costs scaled to match
    use_quality = bool(cfg.use_read_base_qualities)
    kgo, kge = (go * MALDE_SCALE, ge * MALDE_SCALE) if use_quality else (go, ge)

    # Host C DP lane (realign_runs_host, byte-identical to the kernel):
    # integral gap costs only, so f32 arithmetic is exact on both lanes.
    # PANVC3_HOST_DP=0 disables it; PANVC3_HOST_DP_CELLS sets a hard
    # cell-count threshold, unset the LaneController chooses per batch.
    host_dp_eligible = (
        float(go).is_integer()
        and float(ge).is_integer()
        and os.environ.get("PANVC3_HOST_DP") != "0"
    )
    _hdc_env = os.environ.get("PANVC3_HOST_DP_CELLS")
    host_dp_cells = int(_hdc_env) if _hdc_env else None
    adapt = _ADAPT
    adapt.begin_run()

    # Cross-batch DP aggregation (threaded drain only): device-lane batches
    # defer the dispatch and the writer thread pools the staged runs of the
    # in-flight window into one dispatch.  PANVC3_DP_AGGREGATE=0 disables;
    # PANVC3_DP_AGG_RUNS is the target runs per dispatch,
    # PANVC3_DP_AGG_BATCHES the most batches per window and
    # PANVC3_DP_AGG_MIN_RUNS the flush-on-idle floor.
    defer_dp = (
        cfg.threaded_pipeline
        and os.environ.get("PANVC3_DP_AGGREGATE", "1") != "0"
    )
    agg_target_runs = int(os.environ.get("PANVC3_DP_AGG_RUNS", "16384"))
    agg_max_batches = int(os.environ.get("PANVC3_DP_AGG_BATCHES", "16"))
    agg_min_runs = int(os.environ.get("PANVC3_DP_AGG_MIN_RUNS", "16384"))
    # Ref-gather wires: reference rows are gathered on the device from the
    # resident flat reference.  PANVC3_DP_REFGATHER=0 ships staged rows;
    # PANVC3_REFGATHER_MAX_H2D caps the flat-reference upload.
    refgather_ok = os.environ.get("PANVC3_DP_REFGATHER", "1") != "0"
    refgather_max_h2d = int(
        os.environ.get("PANVC3_REFGATHER_MAX_H2D", str(256 << 20))
    )
    # sort aggregate windows by run length (order restored at fetch) —
    # PANVC3_DP_AGG_SORT=0 reverts
    agg_sort = os.environ.get("PANVC3_DP_AGG_SORT", "1") != "0"
    diag = AGG_DIAG

    # shard-aware check data: dev id -1 == entry outside this index shard
    shard_check = cfg.chr_shard is not None

    reporter = StatusReporter(cfg.status_output_interval)

    state = {
        "rec_global": 0,   # input records consumed before current batch
        "task_counter": 0,  # 4-record task groups emitted
        "realign_fetch_ns": 0,  # fetch half of the realignment timing
        "realign_stage_ns": 0,  # staging/dispatch half (folded at emit)
        "batches": 0,  # batch ids, in submission order (the spans' batch)
    }

    def realign_status() -> str:
        n = stats.realigned_range_count
        msg = f"; realigned {n} ranges"
        if n:
            t_ns = stats.realignment_time_ns + bp.realignment_time_ns
            usecs = t_ns / 1000.0 / n
            mean_len = stats.realigned_range_total_length / n
            msg += (
                f" (in {format_duration(t_ns / 1e9)}; "
                f"{usecs:.2f} µs / realignment, mean length {mean_len:g} characters)"
            )
        return msg

    reporter.extra_cb = realign_status

    # fetch pool: waits for device results off the writer thread, so
    # several dispatches' copies overlap host work
    fetch_pool = None
    if cfg.threaded_pipeline:
        from concurrent.futures import ThreadPoolExecutor

        fetch_pool = ThreadPoolExecutor(max_workers=4, thread_name_prefix="fastlane-fetch")

    # Flat-reference ingestion for the ref-gather wires: grow-only
    # accumulation of the contigs batches reference, rebuilt when pending
    # growth reaches 25%, abandoned once the total would exceed the cap.
    _rg_accum: dict[int, bytes] = {}
    _rg_state = {"flat": 0, "pending": 0, "idle": 0, "disabled": not refgather_ok}
    _rg_lock = threading.Lock()

    def _ingest_refs(snap):
        if _rg_state["disabled"]:
            return
        with _rg_lock:
            if _rg_state["disabled"]:
                return
            new = 0
            for rid, seq in snap.items():
                if rid not in _rg_accum:
                    _rg_accum[rid] = seq
                    new += len(seq)
            if new:
                _rg_state["pending"] += new
                _rg_state["idle"] = 0
            elif _rg_state["pending"]:
                # a deferred rebuild must not starve
                _rg_state["idle"] += 1
            if not _rg_state["pending"]:
                return
            total = _rg_state["flat"] + _rg_state["pending"]
            if total > refgather_max_h2d:
                _rg_state["disabled"] = True
                _rg_accum.clear()
                return
            if (
                _rg_state["flat"]
                and _rg_state["pending"] * 4 < _rg_state["flat"]
                and _rg_state["idle"] < 4
            ):
                return  # defer the rebuild while new contigs keep arriving
            with tracing.span("setup_reference_flat"):
                bp._ensure_refs(_rg_accum)
            _rg_state["flat"] = total
            _rg_state["pending"] = 0
            _rg_state["idle"] = 0

    def project_mates(fields) -> np.ndarray:
        """Host mate projection on the event prefix sums, per distinct mate
        reference (project_position); without event tables (=0) through
        the index entries."""
        geo = event_geo if event_geo is not None else dev_event_host
        mate_dst = np.full(len(fields), -1, dtype=np.int32)
        mrid = fields[:, 4]
        mpos = fields[:, 5]
        mask = (mrid >= 0) & (mpos >= 0)
        if mask.any():
            for mr in np.unique(mrid[mask]):
                sel = mask & (mrid == mr)
                pe = geo.events[int(mr)] if geo is not None else None
                if pe is not None:
                    sgv = geo.src_gv[int(mr)]
                    u = np.clip(mpos[sel], 0, max(0, sgv.n_zeros - 1))
                    mate_dst[sel] = project_unit(pe, u).astype(np.int32)
                else:
                    dst_e = dst_entries[int(rim[mr])]
                    mate_dst[sel] = src_entries[int(mr)].project_position(
                        mpos[sel], dst_e
                    )
        return mate_dst

    def start_batch(lines, rec_base, expect_nrec=None, batch=None, staged=None):
        """Parse + stage (text lines; a batch the BAM ingest staged comes
        as ``staged``), and launch the device rewrite geometry where one
        runs; returns a context dict (kept == 0 when the whole block was
        filtered out — the parse counter deltas still ride in it).  The
        stat deltas are folded in emit()."""
        if staged is None:
            with tracing.span("parse_stage", batch):
                staged = nat.parse_stage_batch(
                    lines, refmap, FLAG_SKIP, primary_mask, *stage_pads
                )
            path = "ingest_batches_text"
        else:
            path = "ingest_batches_bam"
        with _DIAG_LOCK:
            diag[path] += 1
        if expect_nrec is not None and staged["n_records"] != expect_nrec:
            raise RuntimeError(
                "scan/parse record count mismatch: "
                f"{staged['n_records']} != {expect_nrec}"
            )
        parse_stats = (
            staged["flags_not_matched"],
            staged["ref_id_missing"],
            staged["seq_missing"],
        )
        kept = staged["kept"]
        if kept == 0:
            return {"kept": 0, "parse_stats": parse_stats, "batch": batch}

        # the stage that reads the batch's contigs: with the host event
        # geometry the mate projection, else the device geometry's dispatch
        with tracing.span("mate_project" if event_geo is not None else "rewrite_dispatch", batch):
            fields = np.frombuffer(staged["fields"], np.int32).reshape(kept, 7)
            ref_id = fields[:, 1]

            if shard_check:
                bad = src_dev[ref_id] < 0
                if bad.any():
                    i = int(np.argmax(bad))
                    name = input_header.ref_names[int(ref_id[i])]
                    raise ValueError(
                        f"record references {name!r}, which is outside this "
                        "index shard (--msa-index-chr-shard); route the input "
                        "with panvc3_split_alignments_by_reference first"
                    )
            dst_rids = rim[ref_id]
            snap = ref_seqs.require(int(r) for r in np.unique(dst_rids))
            _ingest_refs(snap)

            R = staged["R"]
            fetch = fut = d_run = None
            if event_geo is None:
                # the device geometry, batch dimension bucketed as in
                # BatchProjector.start_batch (padding rows copy the first)
                n_pad = max(0, min(batch_size, next_pow2(kept)) - kept)
                n_units = np.frombuffer(staged["n_ref_units"], np.int32)
                if dev_event is not None:
                    rows = (
                        _pad_rows(np.ascontiguousarray(a, dtype=np.int32), n_pad)
                        for a in (ref_id, fields[:, 2], n_units)
                    )
                    wire, overflow = dev_event.kernel_wire(
                        *(_to_device(a, device) for a in rows), R
                    )
                else:
                    # one packed u8 input row per record (10 B)
                    packed_in = pack_gap_wire_input(
                        np.ascontiguousarray(fields[:, 2]), n_units,
                        src_dev[ref_id], dst_dev[dst_rids],
                    )
                    # d_run (int32, B x R) stays on the device unless the
                    # wire overflows
                    wire, overflow, d_run = rewrite_gap_kernel_wire(
                        bp.index, _to_device(_pad_rows(packed_in, n_pad), device), R
                    )
                fetch = DeviceFetch(wire, overflow)
                if fetch_pool is not None:
                    fut = fetch_pool.submit(fetch.get)
            else:
                mate_dst = project_mates(fields)
        if event_geo is None:
            with tracing.span("mate_project", batch):
                mate_dst = project_mates(fields)

        return {
            "staged": staged,
            "fields": fields,
            "dst_rids": np.ascontiguousarray(dst_rids),
            "kept": kept,
            "rec_base": rec_base,
            "parse_stats": parse_stats,
            "mate_dst": mate_dst,
            "fetch": fetch,
            "fut": fut,
            "d_run": d_run,
            "R": R,
            "Lq": staged["Lq"],
            "snap": snap,
            "batch": batch,
        }

    def host_event_geometry(ctx, geo):
        fields = ctx["fields"]
        dst_pos_a, gapbits, d_vals, d_pos, d_n, use_full, d_full = geo.batch(
            fields[:, 1],
            fields[:, 2],
            np.frombuffer(ctx["staged"]["n_ref_units"], np.int32),
            ctx["R"],
            D_SPARSE_SLOTS,
        )
        return dst_pos_a, gapbits, d_vals, d_pos, d_n, use_full, np.ascontiguousarray(d_full)

    def device_geometry(ctx):
        """The geometry of a batch from its device dispatch, or on overflow
        from the host event path (=device) or the full deletion runs
        (=0)."""
        kept = ctx["kept"]
        fut = ctx["fut"]
        wire, overflow = fut.result() if fut is not None else ctx["fetch"].get()
        use_full = 0
        d_full = np.zeros(0, np.int32)
        if int(overflow):
            with _DIAG_LOCK:
                diag["geometry_overflow"] += 1
            if dev_event is not None:
                # event slots or u8 widths ran out (R > 255 included): the
                # host event path is bit-identical and handles those cases
                return host_event_geometry(ctx, dev_event_host)
            use_full = 1
            d_full = np.ascontiguousarray(ctx["d_run"][:kept].cpu().numpy())
        dst_pos_a, d_n, gapbits, d_pos, d_vals = unpack_gap_wire(wire[:kept], ctx["R"])
        return dst_pos_a, gapbits, d_vals, d_pos, d_n, use_full, d_full

    def finish_rewrite(ctx):
        """Rewrite geometry, finalize + detect runs, then the realign lane:
        host C DP, deferred to the writer's aggregate dispatch, or a
        per-batch device dispatch."""
        if ctx is None or ctx["kept"] == 0:
            return ctx
        staged = ctx["staged"]
        batch = ctx["batch"]
        with tracing.span("event_geometry" if event_geo is not None else "rewrite_fetch", batch):
            if event_geo is not None:
                geometry = host_event_geometry(ctx, event_geo)
            else:
                geometry = device_geometry(ctx)
        dst_pos_a, gapbits, d_vals, d_pos, d_n, use_full, d_full = geometry
        with tracing.span("finalize", batch):
            snap = ctx["snap"]
            ref_list = [snap.get(rid, b"") for rid in range(len(dst_entries))]
            run_ops_b, run_lens_b, runs_per_rec_b, indel_b = (
                nat.finalize_reconstruct(
                    staged["unit_op"],
                    staged["unit_count"],
                    staged["n_units"],
                    dst_pos_a,
                    d_vals,
                    d_pos,
                    d_n,
                    D_SPARSE_SLOTS,
                    d_full,
                    int(use_full),
                    gapbits,
                    ctx["R"],
                    staged["query"],
                    ctx["Lq"],
                    ref_list,
                    ctx["dst_rids"],
                )
            )
            nruns = len(indel_b) // 36
        ctx.update(
            dst_pos=dst_pos_a,
            run_ops=run_ops_b,
            run_lens=run_lens_b,
            runs_per_rec=runs_per_rec_b,
            indel=indel_b,
            rh=None,
            rh_wire=False,
            host_dp=None,
            steps=0,
        )
        if not nruns:
            return ctx

        t0 = _time.perf_counter_ns()
        # with -q the staged query phreds are clamped to 0..41 and the
        # reference phreds pinned to 41
        ref_b, q_b, rl_b, ql_b, Rp, Qp, S, rq_b, qq_b = nat.stage_realign_runs(
            indel_b, ctx["dst_rids"], ref_list, staged["query"],
            ctx["Lq"], 8, 8, 256,
            staged["arena"], staged["spans"], int(use_quality),
        )
        ctx["steps"] = Rp + Qp
        if host_dp_eligible and use_quality and Rp + Qp > QUAL_MAX_STEPS:
            with _DIAG_LOCK:
                diag["qual_runs_off_host"] += nruns
        elif host_dp_eligible:
            rl_a = np.frombuffer(rl_b, np.int32)
            ql_a = np.frombuffer(ql_b, np.int32)
            real_cells = int(rl_a.astype(np.int64) @ ql_a.astype(np.int64))
            if host_dp_cells is not None:
                use_host = real_cells <= host_dp_cells
            else:
                use_host = adapt.decide(real_cells)
            if use_host:
                t_dp = _time.perf_counter_ns()
                quality = ()
                if use_quality:
                    mt, xt = malde_tables()
                    quality = (rq_b, qq_b, mt.tobytes(), xt.tobytes())
                ops_b, cnt_b = nat.realign_runs_host(
                    ref_b, q_b, rl_b, ql_b, Rp, Qp, float(kgo), float(kge),
                    *quality,
                )
                ctx["host_dp"] = (
                    np.frombuffer(ops_b, np.int8),
                    np.frombuffer(cnt_b, np.int32),
                )
                dt_dp = _time.perf_counter_ns() - t_dp
                if real_cells > 1000:  # skip noise-dominated samples
                    adapt.observe_host_dp(dt_dp, real_cells)
                ctx["stage_ns"] = _time.perf_counter_ns() - t0
                if tracing.enabled():
                    tracing.add("host_dp", t0, t0 + ctx["stage_ns"], batch)
                return ctx
        if defer_dp:
            # device lane, deferred: the writer thread aggregates this
            # batch's runs with the rest of its window; the per-run (dst
            # rid, ref start) pairs let the dispatch gather reference rows
            # on the device
            ind_a = np.frombuffer(indel_b, np.int32).reshape(-1, 9)
            ctx.update(
                agg=(ref_b, q_b, rl_b, ql_b, Rp, Qp, S, qq_b),
                agg_rid_loc=(
                    np.frombuffer(ctx["dst_rids"], np.int32)[ind_a[:, 0]],
                    ind_a[:, 1].copy(),
                ),
                deferred=True,
            )
        else:
            # per-batch device dispatch
            ctx["launched"] = S * Rp * Qp
            ref = np.frombuffer(ref_b, np.uint8).reshape(S, Rp)
            qry = np.frombuffer(q_b, np.uint8).reshape(S, Qp)
            rl = np.frombuffer(rl_b, np.int32)
            ql = np.frombuffer(ql_b, np.int32)
            if not use_quality and (Rp + Qp) % 2 == 0 and Rp + Qp < 256:
                wire = _realign_wire(
                    _to_device(pack_realign_wire_input(ref, qry, rl, ql), device),
                    go, ge, Rp, Qp,
                )
                rh = DeviceFetch(wire)
                ctx["rh_wire"] = True
            else:
                qq = None
                if use_quality:
                    if Rp + Qp > QUAL_MAX_STEPS:
                        raise ValueError(
                            "quality-scored realignment run too long for "
                            f"the exact quantised path (R+Q={Rp + Qp})"
                        )
                    # reference phreds pinned (none ship); query phreds as u8
                    qq = _to_device(
                        np.frombuffer(qq_b, np.int32).reshape(S, Qp).astype(np.uint8),
                        device,
                    )
                    ctx["qual_bytes"] = S * Qp
                ops, cnt = realign_device_kernel(
                    _to_device(ref, device), _to_device(qry, device),
                    _to_device(rl, device), _to_device(ql, device),
                    kgo, kge, None, qq, use_quality, Rp, Qp,
                )
                rh = DeviceFetch(ops, cnt)
            ctx["rh"] = rh
            if fetch_pool is not None:
                ctx["rfut"] = fetch_pool.submit(rh.get)
        # folded into bp.realignment_time_ns at emit time
        ctx["stage_ns"] = _time.perf_counter_ns() - t0
        if tracing.enabled():
            tracing.add("realign_stage", t0, t0 + ctx["stage_ns"], batch)
        return ctx

    def finish_realign(ctx):
        """Fetch realignment, splice + format the batch.  Returns the emit
        payload (blob + stat deltas); emit() folds it into shared state and
        writes."""
        if ctx is None:
            return None
        if ctx["kept"] == 0:
            return {
                "blob": b"", "removed": {}, "n_realn": 0, "tot_len": 0,
                "cells": 0, "rows": None, "fetch_ns": 0, "stage_ns": 0,
                "kept": 0, "parse_stats": ctx["parse_stats"],
                "batch": ctx["batch"], "launched": 0, "qual_bytes": 0,
            }
        fetch_ns = 0
        steps = ctx["steps"]
        if ctx.get("realn_override") is not None:
            # aggregated dispatch: this batch's row slice of the results
            realn_ops, realn_counts, steps = ctx["realn_override"]
            fetch_ns = ctx.get("agg_fetch_ns", 0)
        elif ctx["rh"] is not None:
            t0 = _time.perf_counter_ns()
            if ctx.get("rfut") is not None:
                fetched = ctx["rfut"].result()
            else:
                fetched = ctx["rh"].get()
            fetch_ns = _time.perf_counter_ns() - t0
            if tracing.enabled():
                tracing.add("realign_fetch", t0, t0 + fetch_ns, ctx["batch"])
            if ctx["rh_wire"]:
                realn_ops, realn_counts = unpack_realign_wire(fetched[0], steps)
            else:
                realn_ops = np.ascontiguousarray(fetched[0])
                realn_counts = np.ascontiguousarray(fetched[1])
        elif ctx["host_dp"] is not None:
            realn_ops, realn_counts = ctx["host_dp"]
        else:
            realn_ops = np.zeros(0, np.int8)
            realn_counts = np.zeros(0, np.int32)
            steps = 0

        staged = ctx["staged"]
        with tracing.span("splice_format", ctx["batch"]):
            blob, removed, (n_realn, tot_len, cells), rows, _tasks_used = (
                nat.splice_apply_format(
                    staged["arena"], staged["spans"], staged["line_index"],
                    staged["fields"], staged["n_ops"],
                    staged["ops"], staged["counts"], staged["O"],
                    ctx["dst_pos"], ctx["run_ops"], ctx["run_lens"],
                    ctx["runs_per_rec"], ctx["indel"],
                    realn_ops, realn_counts, steps,
                    ctx["mate_dst"], rim,
                    out_names, in_names, preserved, tag_names,
                    ctx["rec_base"], ctx["task_base"], want_ranges,
                )
            )
        return {
            "blob": blob,
            "removed": removed,
            "n_realn": n_realn,
            "tot_len": tot_len,
            "cells": cells,
            "rows": rows,
            "fetch_ns": fetch_ns,
            "stage_ns": ctx.get("stage_ns", 0),
            "kept": ctx["kept"],
            "parse_stats": ctx["parse_stats"],
            "dev_realign": (
                ctx.get("realn_override") is not None or ctx["rh"] is not None
            ),
            "batch": ctx["batch"],
            "launched": ctx.get("launched", 0),
            "qual_bytes": ctx.get("qual_bytes", 0),
        }

    def emit(payload):
        """Fold one batch's stat deltas and write its blob (single-threaded:
        main on the serial path, the writer thread on the pooled path)."""
        if payload is None:
            return
        pf, pr, ps = payload["parse_stats"]
        stats.flags_not_matched += pf
        stats.ref_id_missing += pr
        stats.seq_missing += ps
        stats.matched_reads += payload["kept"]
        stats.realigned_range_count += payload["n_realn"]
        stats.realigned_range_total_length += payload["tot_len"]
        stats.realignment_cells += payload["cells"]
        for k, v in payload["removed"].items():
            stats.removed_tag_counts[k] = stats.removed_tag_counts.get(k, 0) + v
        rows = payload["rows"]
        if rows is not None and realigned_ranges is not None:
            realigned_ranges.extend(rows)
        state["realign_fetch_ns"] += payload["fetch_ns"]
        state["realign_stage_ns"] += payload["stage_ns"]
        if payload.get("dev_realign"):
            total_ns = payload["stage_ns"] + payload["fetch_ns"]
            if total_ns:
                adapt.observe_dev_batch(total_ns)
        adapt.observe_emit(
            bool(payload.get("dev_realign")),
            payload["kept"],
            _time.perf_counter_ns(),
            attribute=bool(payload["n_realn"]),
            cells=payload["cells"],
        )
        if payload["n_realn"]:
            if payload["dev_realign"]:
                diag["dp_runs_dev"] += payload["n_realn"]
                diag["dp_cells_dev"] += payload["cells"]
            else:
                diag["dp_runs_host"] += payload["n_realn"]
                diag["dp_cells_host"] += payload["cells"]
        diag["dp_cells_dev_launched"] += payload["launched"]
        diag["qual_bytes_dev"] += payload["qual_bytes"]
        with tracing.span("write", payload["batch"]):
            writer.write_raw(payload["blob"])

    # ---- pipeline drive --------------------------------------------------
    # Main parses (start_batch) in order; each parsed batch runs
    # finish_rewrite + finish_realign as one pool job; the writer thread
    # drains the futures strictly in submission order, folding stats and
    # writing blobs (all shared mutation stays on that thread).
    worker_error: list[BaseException] = []
    job_q = None
    pool = None
    writer_thread = None
    if cfg.threaded_pipeline:
        import queue as _queue
        from concurrent.futures import ThreadPoolExecutor

        try:  # respect CPU affinity
            avail = len(os.sched_getaffinity(0))
        except AttributeError:  # non-Linux
            avail = os.cpu_count() or 4
        n_pool = int(
            os.environ.get("PANVC3_BATCH_WORKERS", "0")
        ) or max(2, avail - 1)
        nat.set_slab_threads(1)
        pool = ThreadPoolExecutor(max_workers=n_pool, thread_name_prefix="fastlane-worker")
        MAX_IN_FLIGHT = max(cfg.pipeline_depth, n_pool + 1)
        job_q = _queue.Queue(maxsize=MAX_IN_FLIGHT)

        # PANVC3_FASTLANE_CHAOS=<seed>: random sub-ms sleeps at every
        # cross-thread handoff; output bytes must not change
        _chaos_env = os.environ.get("PANVC3_FASTLANE_CHAOS")
        if _chaos_env:
            import random as _random

            _chaos_rng = _random.Random(int(_chaos_env))
            _chaos_lock = threading.Lock()

            def _jitter():
                with _chaos_lock:
                    d = _chaos_rng.random() * 0.002
                _time.sleep(d)
        else:
            def _jitter():
                pass

        def _job(ctx):
            _jitter()
            ctx = finish_rewrite(ctx)
            _jitter()
            if ctx is not None and ctx.get("deferred"):
                return ("defer", ctx)
            return finish_realign(ctx)

        def _dispatch_aggregate(ctxs):
            """One realign dispatch for the pooled runs of several batches.
            Blocks re-pad into a common (S_bucket, Rmax/Qmax) layout;
            results come back as row slices.  Returns (parts [(lo, hi)],
            fetch_future, steps)."""
            _jitter()
            with tracing.span("agg_pack_dispatch"):
                parts, fetch, steps = _pack_dispatch(ctxs)
            return parts, fetch_pool.submit(fetch), steps

        def _pack_dispatch(ctxs):
            """The aggregate dispatch up to its fetch: (parts, the fetch
            function, steps)."""
            t0 = _time.perf_counter_ns()
            # pad to the {p, 1.5p} ladder of the actual max run lengths:
            # block columns past each row's length are zeros, so narrower
            # pads just slice them
            Rmax = _next_rq_bucket(max(
                int(np.max(np.frombuffer(c["agg"][2], np.int32), initial=1))
                for c in ctxs
            ))
            Qmax = _next_rq_bucket(max(
                int(np.max(np.frombuffer(c["agg"][3], np.int32), initial=1))
                for c in ctxs
            ))
            S_tot = sum(c["agg"][6] for c in ctxs)
            S_b = _next_row_bucket(max(S_tot, 256))
            steps = Rmax + Qmax
            # the -q wires return the 2-bit packed traceback: steps % 4 == 0
            wire_ok = (
                steps % 2 == 0 and steps < 256
                and (not use_quality or steps % 4 == 0)
            )

            # ref-gather eligibility: every run's dst contig must be in the
            # current flat-reference snapshot (taken under bp's ref lock)
            rg_starts = rg_flat = None
            snap_rg = (
                bp.ref_flat_snapshot(refgather_max_h2d)
                if wire_ok and refgather_ok and steps % 4 == 0
                else None
            )
            if snap_rg is not None:
                flat, offmap = snap_rg
                if flat.shape[0] <= 0xFFFFFFFF:
                    off_lut = np.full(max(1, len(dst_entries)), -1, np.int64)
                    for rid_, o_ in offmap.items():
                        off_lut[rid_] = o_
                    starts = np.zeros(S_b, np.int64)
                    off = 0
                    for c in ctxs:
                        rid_arr, loc_arr = c["agg_rid_loc"]
                        n_real = len(rid_arr)
                        if n_real:
                            so = off_lut[rid_arr]
                            if (so < 0).any():
                                starts = None
                                break
                            starts[off:off + n_real] = so + loc_arr
                        off += c["agg"][6]
                    if starts is not None:
                        rg_starts, rg_flat = starts, flat

            ref = None if rg_starts is not None else np.zeros(
                (S_b, Rmax), np.uint8
            )
            qb = np.zeros((S_b, Qmax), np.uint8)
            rl = np.zeros(S_b, np.int32)
            ql = np.zeros(S_b, np.int32)
            qq = None
            if use_quality:
                if Rmax + Qmax > QUAL_MAX_STEPS:
                    raise ValueError(
                        "quality-scored realignment run too long for the "
                        f"exact quantised path (R+Q={Rmax + Qmax})"
                    )
                # reference phreds pinned (none ship); query phreds as u8
                qq = np.zeros((S_b, Qmax), np.uint8)
            parts = []
            off = 0
            for c in ctxs:
                ref_b, q_b, rl_b, ql_b, Rp, Qp, S, qq_b = c["agg"]
                rc = min(Rp, Rmax)
                qc = min(Qp, Qmax)
                if ref is not None:
                    ref[off:off + S, :rc] = np.frombuffer(
                        ref_b, np.uint8
                    ).reshape(S, Rp)[:, :rc]
                qb[off:off + S, :qc] = np.frombuffer(
                    q_b, np.uint8
                ).reshape(S, Qp)[:, :qc]
                rl[off:off + S] = np.frombuffer(rl_b, np.int32)
                ql[off:off + S] = np.frombuffer(ql_b, np.int32)
                if qq is not None:
                    qq[off:off + S, :qc] = np.frombuffer(
                        qq_b, np.int32
                    ).reshape(S, Qp)[:, :qc]
                parts.append((off, off + S))
                off += S

            # length-sort the window (output order restored by inverse
            # permutation in _restore at fetch)
            diag["dispatches"] += 1
            diag["dp_cells_dev_launched"] += S_b * Rmax * Qmax
            inv_order = None
            if agg_sort and S_tot > 1:
                key = rl[:S_tot] + ql[:S_tot]
                if np.any(key[:-1] > key[1:]):
                    diag["sorted"] += 1
                    order = np.argsort(key, kind="stable")
                    inv_order = np.empty_like(order)
                    inv_order[order] = np.arange(len(order), dtype=order.dtype)
                    rl[:S_tot] = rl[:S_tot][order]
                    ql[:S_tot] = ql[:S_tot][order]
                    qb[:S_tot] = qb[:S_tot][order]
                    if ref is not None:
                        ref[:S_tot] = ref[:S_tot][order]
                    if qq is not None:
                        qq[:S_tot] = qq[:S_tot][order]
                    if rg_starts is not None:
                        rg_starts[:S_tot] = rg_starts[:S_tot][order]

            def _restore(o, c2):
                _jitter()  # fetch-thread completion timing
                if inv_order is None:
                    return np.ascontiguousarray(o), np.ascontiguousarray(c2)
                return (
                    np.ascontiguousarray(o[inv_order]),
                    np.ascontiguousarray(c2[inv_order]),
                )

            # 2-bit query wire for N-free windows; PANVC3_DP_WIRE2=0 keeps
            # the 4-bit wire
            wire2 = (
                rg_starts is not None
                and Qmax % 4 == 0
                and os.environ.get("PANVC3_DP_WIRE2") != "0"
                and query_wire2_eligible(qb, ql)
                and (qq is None or int(qq.max(initial=0)) < 64)
            )
            if rg_starts is not None:
                diag["refgather"] += 1
            if wire2:
                diag["wire2"] += 1
            if qq is not None:
                # the 2-bit wire packs four 6-bit phreds into three bytes
                diag["qual_bytes_dev"] += S_b * (3 * Qmax // 4 if wire2 else Qmax)
            if rg_starts is not None:
                if use_quality and wire2:
                    packed = pack_realign_refgather2_input_q(qb, rg_starts, rl, ql, qq)
                    wire = _realign_wire_refgather2_q(
                        _to_device(packed, device), rg_flat, kgo, kge, Rmax, Qmax
                    )
                elif use_quality:
                    packed = pack_realign_refgather_input_q(qb, rg_starts, rl, ql, qq)
                    wire = _realign_wire_refgather_q(
                        _to_device(packed, device), rg_flat, kgo, kge, Rmax, Qmax
                    )
                elif wire2:
                    packed = pack_realign_refgather2_input(qb, rg_starts, rl, ql)
                    wire = _realign_wire_refgather2(
                        _to_device(packed, device), rg_flat, go, ge, Rmax, Qmax
                    )
                else:
                    packed = pack_realign_refgather_input(qb, rg_starts, rl, ql)
                    wire = _realign_wire_refgather(
                        _to_device(packed, device), rg_flat, go, ge, Rmax, Qmax
                    )
                res = DeviceFetch(wire)

                def _fetch():
                    w = res.get()[0]
                    return _restore(*unpack_realign_refgather_wire(w[:S_tot], steps))
            elif wire_ok:
                if use_quality:
                    packed = pack_realign_wire_input_q(ref, qb, rl, ql, qq)
                    wire = _realign_wire_q(
                        _to_device(packed, device), kgo, kge, Rmax, Qmax
                    )
                    unpack = unpack_realign_refgather_wire  # 2-bit packed ops
                else:
                    packed = pack_realign_wire_input(ref, qb, rl, ql)
                    wire = _realign_wire(_to_device(packed, device), go, ge, Rmax, Qmax)
                    unpack = unpack_realign_wire
                res = DeviceFetch(wire)

                def _fetch():
                    w = res.get()[0]
                    return _restore(*unpack(w[:S_tot], steps))
            else:
                ops, cnt = realign_device_kernel(
                    _to_device(ref, device), _to_device(qb, device),
                    _to_device(rl, device), _to_device(ql, device),
                    kgo, kge, None,
                    None if qq is None else _to_device(qq, device),
                    use_quality, Rmax, Qmax,
                )
                res = DeviceFetch(ops, cnt)

                def _fetch():
                    o, c2 = res.get()
                    return _restore(o[:S_tot], c2[:S_tot])

            # spread the shared dispatch cost across the window's batches
            share = (_time.perf_counter_ns() - t0) // len(ctxs)
            for c in ctxs:
                c["stage_ns"] = c.get("stage_ns", 0) + share
            return parts, _fetch, steps

        def _finish_deferred(ctx, agg_fut, lo, hi, steps):
            _jitter()
            t0 = _time.perf_counter_ns()
            ops_all, cnt_all = agg_fut.result()
            ctx["agg_fetch_ns"] = _time.perf_counter_ns() - t0
            if tracing.enabled():
                tracing.add("realign_fetch", t0, t0 + ctx["agg_fetch_ns"], ctx["batch"])
            ctx["realn_override"] = (ops_all[lo:hi], cnt_all[lo:hi], steps)
            return finish_realign(ctx)

        def _writer():
            # Ordered drain with a DP-aggregation window: job results are
            # payloads (emit-ready) or deferred ctxs (runs staged, realign
            # pending).  Deferred ctxs accumulate until the window holds
            # agg_target_runs (or agg_max_batches), then one aggregate
            # dispatch covers them and per-batch phase-2 jobs (slice +
            # splice) go back to the pool.  out_q preserves submission
            # order; all shared mutation stays here.
            import collections as _collections

            out_q: _collections.deque = _collections.deque()
            window: list = []  # (entry, ctx) pairs awaiting dispatch
            window_runs = 0

            def wait(fut):
                """A job's result; traced, the writer's wait on a job not
                yet done is a ``writer_wait`` span."""
                if not tracing.enabled() or fut.done():
                    return fut.result()
                t0 = _time.perf_counter_ns()
                res = fut.result()
                ctx = res[1] if isinstance(res, tuple) else res
                tracing.add("writer_wait", t0, _time.perf_counter_ns(),
                            ctx["batch"] if ctx else None)
                return res

            def flush():
                nonlocal window, window_runs
                if not window:
                    return
                parts, agg_fut, steps = _dispatch_aggregate(
                    [c for _, c in window]
                )
                for (entry, ctx), (lo, hi) in zip(window, parts):
                    entry[1] = pool.submit(
                        _finish_deferred, ctx, agg_fut, lo, hi, steps
                    )
                    entry[0] = "fut"
                window = []
                window_runs = 0

            def drain(block: bool):
                while out_q:
                    kind, val = out_q[0]
                    if kind == "done":
                        emit(val)
                        out_q.popleft()
                    elif kind == "fut":
                        if block or val.done():
                            emit(wait(val))
                            out_q.popleft()
                        else:
                            return
                    else:  # pending: needs a window flush first
                        if not block:
                            return
                        flush()

            while True:
                with tracing.span("writer_idle"):
                    fut = job_q.get()
                _jitter()
                if fut is None:
                    try:
                        flush()
                        drain(block=True)
                    except BaseException as exc:  # noqa: BLE001 — re-raised on main
                        worker_error.append(exc)
                    return
                try:
                    res = wait(fut)
                    if isinstance(res, tuple) and res and res[0] == "defer":
                        ctx = res[1]
                        entry = ["pending", ctx]
                        out_q.append(entry)
                        window.append((entry, ctx))
                        window_runs += ctx["agg"][6]
                        if (
                            window_runs >= agg_target_runs
                            or len(window) >= agg_max_batches
                        ):
                            flush()
                    else:
                        out_q.append(["done", res])
                    drain(block=False)
                    # flush-on-idle: a worthwhile window dispatches as soon
                    # as no further staged batch is ready
                    if window_runs >= agg_min_runs and job_q.empty():
                        flush()
                        drain(block=False)
                    # a deferred head must not dam up completed payloads
                    if (
                        out_q
                        and out_q[0][0] == "pending"
                        and len(out_q) >= agg_max_batches
                    ):
                        flush()
                        drain(block=False)
                    if len(out_q) > 4 * agg_max_batches:
                        flush()
                        # hard cap: block on the head until the queue shrinks
                        while len(out_q) > 2 * agg_max_batches:
                            kind, val = out_q.popleft()
                            emit(wait(val) if kind == "fut" else val)
                except BaseException as exc:  # noqa: BLE001 — re-raised on main
                    worker_error.append(exc)
                    while True:
                        if job_q.get() is None:
                            return

        writer_thread = threading.Thread(target=_writer, name="fastlane-writer", daemon=True)
        writer_thread.start()
    else:
        MAX_IN_FLIGHT = max(1, cfg.pipeline_depth)

    import collections

    in_flight: collections.deque = collections.deque()
    realign_flight: collections.deque = collections.deque()

    def submit(lines, kept_exp, nrec, staged=None):
        # record/task numbering is deterministic per batch: nrec comes from
        # the scan mask (or the ingest's cut) and the task groups are
        # ceil(kept/4), so both bases are assigned here in submission order
        rec_base = state["rec_global"]
        if rec_base and (rec_base // 10_000_000) != (
            (rec_base + nrec) // 10_000_000
        ):
            log_time(f"Processed {rec_base + nrec} alignments…")
        reporter.tick(rec_base)
        state["rec_global"] += nrec
        task_base = state["task_counter"]
        state["task_counter"] += (kept_exp + 3) // 4
        batch = state["batches"]
        state["batches"] += 1
        if pool is not None:
            if worker_error:
                raise worker_error[0]
            ctx = start_batch(lines, rec_base, nrec, batch, staged)
            ctx["task_base"] = task_base
            job = pool.submit(_job, ctx)
            # blocked here while the writer holds MAX_IN_FLIGHT jobs
            with tracing.span("submit_wait", batch):
                job_q.put(job)
        else:
            ctx = start_batch(lines, rec_base, nrec, batch, staged)
            ctx["task_base"] = task_base
            in_flight.append(ctx)
            if len(in_flight) >= MAX_IN_FLIGHT:
                realign_flight.append(finish_rewrite(in_flight.popleft()))
                if len(realign_flight) >= MAX_IN_FLIGHT:
                    emit(finish_realign(realign_flight.popleft()))

    # Batches are formed over KEPT records (exactly batch_size per batch)
    # so the 4-record task groups partition like the object path's chunk
    # loop.  keep_buf entries: 2 kept, 1 skipped record, 0 whitespace-only.
    lines_buf: list[bytes] = []
    keep_buf = np.zeros(0, dtype=np.uint8)
    kept_in_buf = 0

    def form_batches(eof: bool = False):
        nonlocal lines_buf, keep_buf, kept_in_buf
        while kept_in_buf >= batch_size or (eof and lines_buf):
            if kept_in_buf >= batch_size:
                cut = int(
                    np.searchsorted(
                        np.cumsum(keep_buf == 2), batch_size
                    )
                ) + 1
                batch = lines_buf[:cut]
                nrec = int((keep_buf[:cut] >= 1).sum())
                kept_exp = batch_size
                lines_buf = lines_buf[cut:]
                keep_buf = keep_buf[cut:]
                kept_in_buf -= batch_size
            else:
                batch = lines_buf
                nrec = int((keep_buf >= 1).sum())
                kept_exp = kept_in_buf
                lines_buf = []
                keep_buf = np.zeros(0, dtype=np.uint8)
                kept_in_buf = 0
            submit(batch, kept_exp, nrec)

    # BAM input: the ingest stages the batches, cut the same way, on a
    # thread of its own (inline on the serial path); the main thread's
    # bam_read is then its wait for the next one
    ingest = ingest_thread = None
    try:
        if not reader.is_bam:
            blocks = reader.raw_record_line_blocks()
            while True:
                with tracing.span("bam_read"):
                    block = next(blocks, None)
                if block is None:
                    break
                with tracing.span("scan_mask"):
                    mask = np.frombuffer(
                        nat.scan_keep_mask(block, FLAG_SKIP, primary_mask), np.uint8
                    )
                    lines_buf += block
                    keep_buf = np.concatenate([keep_buf, mask])
                    kept_in_buf += int((mask == 2).sum())
                form_batches()
            form_batches(eof=True)
        else:
            ingest = BamIngest(reader, refmap, FLAG_SKIP, primary_mask, batch_size, *stage_pads)
            next_staged = ingest.next_batch
            if pool is not None:
                ingest_thread = IngestThread(ingest, INGEST_DEPTH, _jitter)
                next_staged = ingest_thread.get
            while True:
                with tracing.span("bam_read"):
                    item = next_staged()
                if item is None:
                    break
                staged, nrec, kept_exp = item
                submit(None, kept_exp, nrec, staged)
    finally:
        if ingest_thread is not None:
            ingest_thread.close()
        if ingest is not None:
            ingest.close()
        if writer_thread is not None:
            # the last hand-over, then the wait for the writer to drain
            with tracing.span("submit_wait"):
                job_q.put(None)
                writer_thread.join()
        if pool is not None:
            pool.shutdown(wait=True)
            nat.set_slab_threads(0)
        if fetch_pool is not None:
            fetch_pool.shutdown(wait=True)
    if worker_error:
        raise worker_error[0]
    while in_flight:
        realign_flight.append(finish_rewrite(in_flight.popleft()))
    while realign_flight:
        emit(finish_realign(realign_flight.popleft()))
    bp.realignment_time_ns += state["realign_stage_ns"] + state["realign_fetch_ns"]
    if tracing.enabled():
        log_time("[fastlane diag] " + json.dumps({
            **AGG_DIAG,
            **pairs_built,
            **{key: AGG_DIAG[key] - ingest_base[key] for key in INGEST_KEYS},
            "batches": state["batches"],
            "kernel_launches": dict(_kernels.LAUNCHES),
            "device": str(device),
        }))


def _next_bucket(n: int, floor: int) -> int:
    """Smallest {p, 1.5p} ladder value >= max(n, floor) (p a power of
    two).  A pure pow2 ladder wastes up to 2x padding just above a
    boundary; the half-octave step bounds the waste at 33% while keeping
    the compiled shape set small (two per octave)."""
    p = floor
    while p < n:
        if p + (p >> 1) >= n:
            return p + (p >> 1)
        p <<= 1
    return p


def _next_row_bucket(n: int) -> int:
    """Row (run-count) bucket for the aggregate realign dispatch."""
    return _next_bucket(n, 1)


def _next_rq_bucket(n: int) -> int:
    """R/Q pad bucket for the aggregate dispatch: the ladder from 8 up.
    Every value is divisible by 4 (p pow2 >= 8, and 1.5p with p >= 8), so
    the wire constraints (4-bit query packing needs even Q, 2-bit op
    packing needs steps % 4 == 0) hold for any R/Q combination.  A
    pow2-only ladder wasted up to 2x DP compute AND wire per axis (the
    bench's 48x48 runs padded to 64x64 = 1.78x padded cells)."""
    return _next_bucket(n, 8)
