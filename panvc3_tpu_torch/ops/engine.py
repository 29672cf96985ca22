"""The batched projection engine: device rewrite + device realignment.

Counterpart of ``panvc3_tpu.ops.engine``.  A batch of SAM records is
expanded on the host (``expand_cigars``) and runs on the projector's
device by one of two lanes:

- the split lane: the gap kernel over the device gap index (``.index``,
  built on first use), the host =/X comparison and C finalize of the
  rewritten CIGARs and their indel runs, the runs realigned on the device
  (``realign_batch_start``: K1, or the host C DP for small batches), and
  the splice into per-record ``ProjectionResult``s;
- the fused lane (``cfg.fused_kernel``, integer scoring): one dispatch of
  the v4 engine (``ops/fused_event.py``: event-geometry rewrite, run
  detection and the DP; its geometry built on first use), whose event
  overflow re-dispatches the batch through the v3 engine
  (``ops/fused.py``, over the gap index) and whose run-pool or length
  overflow realigns on the split lane's host path; ``FUSED_ROUTES`` counts
  which route answered each batch.

Over a device mesh (``mesh=``, ``parallel/mesh.py``) the batch is cut
into the mesh's row blocks: the gap kernel and v4 run once per shard on
its device, over one replica per device of the gap index, the event
tables and the flat reference; the rest runs on the mesh's first device.

``choose_engine_lane`` picks the lane for a run.  The fast lane
(``pipeline/fastlane.run_fast``) uses only the device sequence ids, the
realignment timer and the flat reference of this object.

Shapes are padded to power-of-two buckets, as in the JAX version, so both
give the same batches.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import torch

from .. import tracing
from ..alphabet import decode_phred42, normalise_dna5
from ..cigar import CODE_TO_OP, collapse_cigar
from ..indel_runs import IndelRun, find_indel_runs
from ..native import get_native
from ..parallel.mesh import replicate, shard_batch_arrays
from ..projector import ProjectionResult
from .fetch import DeviceFetch
from .rank_select import DeviceGapIndex
from .realign_batch import PINNED_REF_QUALS, realign_batch_finish, realign_batch_start
from .rewrite_batch import (
    CODE_NONE,
    expand_cigars,
    fetch_gap_outputs,
    finalize_rewrite,
    reconstruct_main_code,
    rewrite_gap_kernel_packed,
    rewrite_gap_kernel_sharded,
)


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


#: Batches of the fused lane by the route that answered them: ``v4_dp``, v4
#: batches whose own DP result was used; ``v4_to_v3``, v4 batches
#: re-dispatched through v3 on event overflow; ``v3``, v3 batches (those
#: included); ``host_realign``, batches realigned on the host path (run
#: pool or length overflow, or a run mismatch).  ``run_project_alignments``
#: resets it.
FUSED_ROUTES = {"v4_dp": 0, "v4_to_v3": 0, "v3": 0, "host_realign": 0}
_ROUTES_LOCK = threading.Lock()


def _route(name: str) -> None:
    with _ROUTES_LOCK:
        FUSED_ROUTES[name] += 1


def reset_fused_routes() -> None:
    with _ROUTES_LOCK:
        for key in FUSED_ROUTES:
            FUSED_ROUTES[key] = 0


def probe_d2h_mbps(device, size: int = 1 << 22) -> float:
    """Measured device-to-host rate (MB/s) of ``device``, round-trip time
    compensated.

    Three stages, so that no link overpays or is under-measured: 16 KB
    first (a degraded link costs a fraction of a second, not tens); 256 KB
    next, whose difference from the small fetch says whether the link is
    plainly slow; 4 MB last, the measurement that decides (at the 200 MB/s
    threshold its ~3.75 MB difference takes ~19 ms, well above timing
    jitter).  A difference that is not positive cannot be measured and
    reads 0.0, so the arbiter picks 'split'.  Each timed fetch copies a
    fresh tensor, computed on the device from a varying operand, into
    pinned host memory."""
    dev = torch.device(device)

    def fetch_seconds(base, salt):
        y = base + salt
        host = torch.empty(base.shape, dtype=base.dtype, pin_memory=dev.type == "cuda")
        t0 = time.perf_counter()
        host.copy_(y)  # waits for y, then copies: one round trip, compensated below
        return time.perf_counter() - t0

    small_n = 1 << 14
    small = torch.zeros(small_n, dtype=torch.uint8, device=dev)
    fetch_seconds(small, 1)  # warm
    t_small = min(fetch_seconds(small, 2), fetch_seconds(small, 3))
    # a small fetch is round-trip dominated on any link, so it can only
    # detect the pathological case
    if t_small > 1.0:
        return small_n / t_small / 1e6

    def differential_mbps(n_lo, t_lo, n_hi):
        arr = torch.zeros(n_hi, dtype=torch.uint8, device=dev)
        fetch_seconds(arr, 1)
        t_hi = min(fetch_seconds(arr, 2), fetch_seconds(arr, 3))
        # (n_hi - n_lo) more bytes took (t_hi - t_lo) more seconds: round
        # trip and dispatch cancel
        if t_hi <= t_lo:
            return 0.0, t_hi
        return (n_hi - n_lo) / (t_hi - t_lo) / 1e6, t_hi

    mid_n = 1 << 18
    mid_mbps, t_mid = differential_mbps(small_n, t_small, mid_n)
    # skip the big fetch only on absolute evidence of a slow link (256 KB in
    # more than 0.25 s)
    if t_mid > 0.25:
        return mid_mbps
    big_mbps, _ = differential_mbps(mid_n, t_mid, max(size, mid_n * 2))
    return big_mbps


def choose_engine_lane(
    device, host_cores: int | None = None, d2h_mbps: float | None = None
) -> str:
    """'split' (the fast lane and host finalize) or 'fused' (the v4 engine,
    one dispatch per batch) for a run on ``device``.

    The split lane wins wherever the host has cores to feed it; the fused
    engine where host CPU is scarce and the device-to-host leg is healthy,
    since it fetches its wire outputs every batch.  The probe runs only
    when the core count does not decide.  ``PANVC3_ENGINE_LANE=fused|split``
    forces; a device other than CUDA gets 'split'.  The thresholds (3
    cores, 200 MB/s) are the JAX package's, set on its TPU host, and no
    CUDA host measurement backs the unforced 'fused' pick: on an H100 host
    with 8 cores the fused lane reads 15-30x fewer reads/s than the split
    lane (PERF.md), and where it would win is not measured."""
    forced = os.environ.get("PANVC3_ENGINE_LANE")
    if forced in ("split", "fused"):
        return forced
    if torch.device(device).type != "cuda":
        return "split"
    if host_cores is None:
        try:
            host_cores = len(os.sched_getaffinity(0))
        except AttributeError:
            host_cores = os.cpu_count() or 4
    if host_cores >= 3:
        return "split"
    if d2h_mbps is None:
        d2h_mbps = probe_d2h_mbps(device)
    return "fused" if d2h_mbps >= 200.0 else "split"


class BatchProjector:
    def __init__(
        self,
        src_entries,
        dst_entries,
        ref_id_mapping,
        gap_opening_cost: int,
        gap_extension_cost: int,
        device: torch.device,
        mesh=None,
    ):
        """``mesh``: an optional ``parallel.mesh.Mesh``; when given, batches
        are sharded over it (records data-parallel; the gap index, the
        event tables and the flat reference replicated, one copy per
        device) and the unsharded work (the v3 re-dispatch, the split
        lane's realignment) runs on its first device, which is then the
        projector's ``device``."""
        self.mesh = mesh
        self.device = mesh.devices[0] if mesh is not None else torch.device(device)
        self.gap_opening_cost = gap_opening_cost
        self.gap_extension_cost = gap_extension_cost
        self.ref_id_mapping = ref_id_mapping
        # wall time spent staging, dispatching and fetching the batched
        # realignment DP
        self.realignment_time_ns = 0

        # device sequence ids: gap vectors deduplicated by identity; None
        # entries (references outside this index shard) get -1
        vectors = []
        ids: dict[int, int] = {}

        def dev_id(entry):
            key = id(entry.gaps)
            if key not in ids:
                ids[key] = len(vectors)
                vectors.append(entry.gaps)
            return ids[key]

        self.src_dev_ids = [dev_id(e) if e is not None else -1 for e in src_entries]
        self.dst_dev_ids = [dev_id(e) if e is not None else -1 for e in dst_entries]
        # the gap index costs O(columns) build time and memory; only the gap
        # kernel (the split lane of the object path, the fast lane's
        # PANVC3_EVENT_GEOMETRY=0) and the v3 engine read it
        self._vectors = vectors
        self._index = None
        self._index_replicas = None
        # the fused v4 engine's event geometry, built on the first fused
        # batch from these entries (the fast lane builds its own)
        self._entries = (src_entries, dst_entries)
        self._event_geometry = None
        self._fused_event_kernel = None
        self._index_lock = threading.Lock()  # guards both lazy builds

        # The lock pairs _ensure_refs (main thread, streams contigs in)
        # with ref_flat_snapshot (the drain thread reads a consistent
        # buffer/offset pair for the ref-gather wire).
        self._ref_lock = threading.Lock()
        self._ref_flat = None
        self._ref_flat_replicas = None
        self._ref_flat_host = np.zeros(0, dtype=np.uint8)
        self._ref_off: dict[int, int] = {}

    @classmethod
    def from_numpy_state(cls, state: dict, device) -> "BatchProjector":
        """A projector rebuilt from plain numpy/int state (the keys of
        :meth:`numpy_state`), such as ``panvc3_tpu``'s projector holds.  An
        ``index`` entry (``DeviceGapIndex.numpy_state`` layout) gives the
        gap index; without it the projector has none."""
        bp = cls.__new__(cls)
        bp.mesh = None
        bp.device = torch.device(device)
        bp.gap_opening_cost = int(state["gap_opening_cost"])
        bp.gap_extension_cost = int(state["gap_extension_cost"])
        bp.ref_id_mapping = list(state.get("ref_id_mapping", []))
        bp.realignment_time_ns = 0
        bp.src_dev_ids = [int(v) for v in state["src_dev_ids"]]
        bp.dst_dev_ids = [int(v) for v in state["dst_dev_ids"]]
        bp._vectors = []
        bp._index = (
            DeviceGapIndex.from_numpy_state(state["index"], bp.device)
            if state.get("index") is not None
            else None
        )
        bp._index_replicas = None
        bp._entries = None
        bp._event_geometry = None
        bp._fused_event_kernel = None
        bp._index_lock = threading.Lock()
        bp._ref_lock = threading.Lock()
        bp._ref_flat = None
        bp._ref_flat_replicas = None
        bp._ref_flat_host = np.array(state["ref_flat_host"], dtype=np.uint8)
        bp._ref_off = {int(k): int(v) for k, v in state["ref_off"].items()}
        return bp

    def numpy_state(self) -> dict:
        """Plain numpy/int state: enough to rebuild the projector (add the
        index's ``numpy_state`` under ``index`` to carry the gap index)."""
        with self._ref_lock:
            return {
                "gap_opening_cost": self.gap_opening_cost,
                "gap_extension_cost": self.gap_extension_cost,
                "ref_id_mapping": list(self.ref_id_mapping),
                "src_dev_ids": list(self.src_dev_ids),
                "dst_dev_ids": list(self.dst_dev_ids),
                "ref_flat_host": self._ref_flat_host.copy(),
                "ref_off": dict(self._ref_off),
            }

    @property
    def index(self) -> DeviceGapIndex:
        """The device gap index on the projector's device, built on first
        use."""
        with self._index_lock:
            if self._index is None:
                self._index = DeviceGapIndex.build(self._vectors, device=self.device)
            return self._index

    @property
    def index_replicas(self) -> tuple:
        """The gap index on each shard's device of the mesh: built once on
        the first device and copied to each other device, once."""
        index = self.index
        with self._index_lock:
            if self._index_replicas is None:
                self._index_replicas = replicate(self.mesh, index)
            return self._index_replicas

    @property
    def event_geometry(self):
        """The device event geometry of this projector's entries on its
        device, built on first use."""
        with self._index_lock:
            if self._event_geometry is None:
                from .event_geometry import DeviceEventGeometry, EventGeometry

                if self._entries is None:
                    raise RuntimeError(
                        "a projector rebuilt from numpy state has no sequence "
                        "entries for the fused engine's event geometry"
                    )
                host_geo = EventGeometry(*self._entries, self.ref_id_mapping)
                self._event_geometry = DeviceEventGeometry(host_geo, self.device)
            return self._event_geometry

    @property
    def fused_event_kernel(self):
        """The v4 engine bound to ``event_geometry`` (over the mesh, to its
        replicas), built on first use."""
        geo = self.event_geometry
        with self._index_lock:
            if self._fused_event_kernel is None:
                from .fused_event import make_fused_event_kernel

                self._fused_event_kernel = make_fused_event_kernel(geo, self.mesh)
            return self._fused_event_kernel

    def _ensure_refs(self, ref_seqs: dict[int, bytes]) -> None:
        with self._ref_lock:
            if set(ref_seqs) == set(self._ref_off):
                return
            parts = []
            off = 0
            self._ref_off = {}
            for rid, seq in ref_seqs.items():
                self._ref_off[rid] = off
                parts.append(np.frombuffer(seq, dtype=np.uint8))
                off += len(seq)
            self._ref_flat_host = (
                np.concatenate(parts) if parts else np.zeros(1, dtype=np.uint8)
            )
            self._ref_flat = None  # device copy made lazily
            self._ref_flat_replicas = None

    def ref_flat_snapshot(self, max_h2d_bytes: int | None = None):
        """(device flat reference, {rid: offset}) as a consistent pair, or
        None when the copy to the device would exceed ``max_h2d_bytes``
        (unless it is already resident).  Safe to call from the drain
        thread while the main thread streams contigs in."""
        with self._ref_lock:
            if (
                max_h2d_bytes is not None
                and self._ref_flat is None
                and self._ref_flat_host.nbytes > max_h2d_bytes
            ):
                return None
            return self._ref_flat_dev_locked(), dict(self._ref_off)

    @property
    def ref_flat_dev(self) -> torch.Tensor:
        """The flat reference as a uint8 tensor on the projector's device."""
        with self._ref_lock:
            return self._ref_flat_dev_locked()

    def _ref_flat_dev_locked(self) -> torch.Tensor:
        if self._ref_flat is None:
            with tracing.span("setup_reference_upload"):
                self._ref_flat = torch.from_numpy(
                    self._ref_flat_host.copy()
                ).to(self.device)
        return self._ref_flat

    @property
    def ref_flat_replicas(self) -> tuple:
        """The flat reference on each shard's device of the mesh, one copy
        per device."""
        with self._ref_lock:
            if self._ref_flat_replicas is None:
                self._ref_flat_replicas = replicate(self.mesh, self._ref_flat_dev_locked())
            return self._ref_flat_replicas

    # -- the batch pipeline: start_batch -> finish_rewrite -> finish_realign

    #: run pad of the fused engines' DP (longer runs realign on the host
    #: path)
    FUSED_RUN_PAD = 16

    def start_batch(self, records, ref_seqs: dict[int, bytes], cfg):
        """Stage a batch and launch its device work: the fused engine where
        ``cfg.fused_kernel`` asks and the batch passes its gates, else the
        gap kernel.  The outputs head for pinned host memory at once and no
        flag is read here.  Returns an opaque handle for
        :meth:`finish_batch` (None for no records).

        Under a mesh, the rules of the JAX engine's mesh branch: v4's batch
        is padded to the mesh's divisibility with empty records, which
        count in its 16-bit gate and in its slot pool; a batch v4 does not
        take goes to the sharded gap kernel (v3 is not the engine under a
        mesh); the gap kernel's batch is padded to its bucket, then to the
        mesh, with copies of the first row.  The v4 engine sums its run
        totals across shards on the host, once per batch."""
        self._ensure_refs(ref_seqs)
        if not records:
            return None
        queries, dst_ref_ids, batch = self.stage(records)
        b = len(records)
        mesh = self.mesh
        use_fused = (
            bool(getattr(cfg, "fused_kernel", False))
            and not getattr(cfg, "use_read_base_qualities", False)
            and get_native() is not None
        )
        if use_fused:
            # v4 is the default fused engine: its u8 wire needs R <= 255,
            # its boundary-rank matrix is O(ops**2) per record, and its
            # compaction packs record ids and query coordinates into 16-bit
            # fields, which the mesh's pad rows count in; v3 takes the rest
            # and PANVC3_FUSED_EVENT=0
            mesh_pad = (-b) % mesh.size if mesh is not None else 0
            use_event = (
                batch.pad_ref_units <= 255
                and batch.ops.shape[1] <= 32
                and b + mesh_pad < 65536
                and batch.query.shape[1] < 65536
                and os.environ.get("PANVC3_FUSED_EVENT") != "0"
            )
            if use_event:
                fkin = self.v4_inputs(records, batch, mesh_pad)
                costs = (np.float32(self.gap_opening_cost), np.float32(self.gap_extension_cost))
                if mesh is None:
                    ref_flat = self.ref_flat_dev
                else:
                    fkin = shard_batch_arrays(mesh, fkin)
                    ref_flat = self.ref_flat_replicas
                out = self.fused_event_kernel(
                    ref_flat, *fkin.values(), *costs,
                    R=batch.pad_ref_units, run_r=self.FUSED_RUN_PAD,
                    run_q=self.FUSED_RUN_PAD, slot_pool=max(256, (b + mesh_pad) // 2),
                )
                return ("fusedev", records, queries, dst_ref_ids, batch, DeviceFetch(*out[:8]),
                        ref_seqs, cfg, self._ref_flat_host)
            if mesh is None:
                return ("fused", records, queries, dst_ref_ids, batch,
                        self._dispatch_fused_gap(batch, b), ref_seqs, cfg)

        # the gap kernel reads four arrays per record
        kernel_inputs = [batch.src_seq, batch.dst_seq, batch.rec_src_pos, batch.n_ref_units]
        # bucket the batch dimension: pad to the configured batch size, or
        # the next power of two below it, with copies of the first row
        # (their results are sliced off), then to the mesh's divisibility;
        # the fused engines keep the exact size, as their run detection
        # would count the padding's runs
        target = int(getattr(cfg, "device_batch_size", 0)) or b
        n_pad = max(0, min(target, next_pow2(b)) - b)
        if mesh is not None:
            n_pad += (-(b + n_pad)) % mesh.size
        if n_pad:
            kernel_inputs = [
                np.concatenate([a, np.repeat(a[:1], n_pad, axis=0)]) for a in kernel_inputs
            ]
        if mesh is None:
            out = rewrite_gap_kernel_packed(self.index, *kernel_inputs, batch.pad_ref_units)
        else:
            out = rewrite_gap_kernel_sharded(
                mesh, self.index_replicas, *kernel_inputs, batch.pad_ref_units
            )
        fetch = DeviceFetch(*out[:6])
        # the host reference snapshot: a later batch's _ensure_refs may
        # rebuild it while this batch is in flight
        return ("split", records, queries, dst_ref_ids, batch, (fetch, out[6]),
                ref_seqs, cfg, n_pad, self._ref_flat_host)

    def stage(self, records):
        """(dna5-normalised queries, output reference ids, the expanded
        ``RewriteBatch``) of a batch of records whose references are
        loaded (``_ensure_refs``)."""
        queries = [normalise_dna5(rec.seq) for rec in records]
        cigars = [rec.cigar for rec in records]
        dst_ref_ids = [self.ref_id_mapping[rec.ref_id] for rec in records]

        max_ops = 1
        max_ref_units = 1
        for cig in cigars:
            max_ops = max(max_ops, len(cig))
            max_ref_units = max(max_ref_units, sum(n for n, op in cig if op in "M=XDN"))
        max_q = max(1, max(len(q) for q in queries))

        batch = expand_cigars(
            cigars,
            [rec.pos for rec in records],
            queries,
            [self.src_dev_ids[rec.ref_id] for rec in records],
            [self.dst_dev_ids[r] for r in dst_ref_ids],
            [self._ref_off[r] for r in dst_ref_ids],
            pad_ops=next_pow2(max_ops),
            pad_ref_units=max(2, next_pow2(max_ref_units)),
            pad_query=max(2, next_pow2(max_q)),
        )
        return queries, dst_ref_ids, batch

    @staticmethod
    def v4_inputs(records, batch, n_pad: int = 0) -> dict:
        """The v4 engine's batch arrays for staged records, in its argument
        order, with ``n_pad`` empty records appended (a mesh's pad): no
        units and no ops, so they emit no tokens and no runs, and the run
        compaction sees the real records only."""
        arrays = dict(
            ref_ids=np.asarray([rec.ref_id for rec in records], dtype=np.int32),
            rec_src_pos=batch.rec_src_pos, n_ref_units=batch.n_ref_units,
            ref_off=batch.ref_off, ops=batch.ops, counts=batch.counts, query=batch.query,
        )
        if n_pad:
            for key, arr in arrays.items():
                pad = np.zeros((n_pad,) + arr.shape[1:], dtype=arr.dtype)
                if key == "ops":
                    pad[:] = CODE_NONE
                arrays[key] = np.concatenate([np.asarray(arr), pad])
        return arrays

    def finish_batch(self, handle) -> list[ProjectionResult]:
        """Fetch and post-process a batch started with start_batch."""
        return self.finish_realign(self.finish_rewrite(handle))

    def finish_rewrite(self, handle):
        """Stage 2: fetch the gap kernel's outputs, finalize on the host and
        dispatch the realignment DP.  Returns a handle for
        :meth:`finish_realign`."""
        if handle is None:
            return None
        if handle[0] == "fused":
            return ("fused_done", self._finish_fused(handle))
        if handle[0] == "fusedev":
            return ("fused_done", self._finish_fused_event(handle))
        (_, records, queries, dst_ref_ids, batch, (fetch, d_run_full), ref_seqs,
         cfg, n_pad, ref_flat_host) = handle
        b = len(records)
        wire = fetch_gap_outputs([*fetch.get(), d_run_full], batch.pad_ref_units)
        if n_pad:
            wire = tuple(a[:b] for a in wire)
        dst_pos, rewritten, record_runs = self._finalize_wire(
            batch, wire, ref_seqs, dst_ref_ids, ref_flat_host
        )
        t0 = time.perf_counter_ns()
        rh = self._dispatch_realign(records, queries, dst_ref_ids, ref_seqs, cfg, record_runs)
        self.realignment_time_ns += time.perf_counter_ns() - t0
        return ("split2", records, dst_pos, rewritten, record_runs, rh)

    def finish_realign(self, handle2) -> list[ProjectionResult]:
        """Stage 3: fetch the realignment results and splice."""
        if handle2 is None:
            return []
        if handle2[0] == "fused_done":
            return handle2[1]
        _, records, dst_pos, rewritten, record_runs, rh = handle2
        t0 = time.perf_counter_ns()
        realigned = realign_batch_finish(rh)
        self.realignment_time_ns += time.perf_counter_ns() - t0
        return self._splice(records, dst_pos, rewritten, record_runs, realigned)

    def project_batch(self, records, ref_seqs: dict[int, bytes], cfg) -> list[ProjectionResult]:
        """Synchronous convenience wrapper around start/finish."""
        return self.finish_batch(self.start_batch(records, ref_seqs, cfg))

    def _realign_and_splice(
        self, records, queries, dst_ref_ids, ref_seqs, cfg, dst_pos, rewritten, record_runs,
    ) -> list[ProjectionResult]:
        """The fused lane's host path: realign the host-detected runs as the
        split lane does, then splice."""
        rh = self._dispatch_realign(records, queries, dst_ref_ids, ref_seqs, cfg, record_runs)
        realigned = realign_batch_finish(rh)
        return self._splice(records, dst_pos, rewritten, record_runs, realigned)

    def _dispatch_realign(self, records, queries, dst_ref_ids, ref_seqs, cfg, record_runs):
        """Stage the indel runs and dispatch the batched realignment on the
        projector's device; None when there is nothing to realign."""
        use_quality = bool(getattr(cfg, "use_read_base_qualities", False))
        run_refs: list[bytes] = []
        run_queries: list[bytes] = []
        # reference qualities are always pinned to phred42 max (the
        # reference's rule): the sentinel says so without per-run arrays
        run_ref_quals = PINNED_REF_QUALS if use_quality else None
        run_query_quals: list[np.ndarray] | None = [] if use_quality else None
        for i, rec in enumerate(records):
            ref_seq = ref_seqs[dst_ref_ids[i]]
            for run in record_runs[i]:
                run_refs.append(
                    normalise_dna5(ref_seq[run.ref_start:run.ref_start + run.ref_length])
                )
                query_part = queries[i][run.query_start:run.query_start + run.query_length]
                run_queries.append(query_part)
                if use_quality:
                    q = decode_phred42(rec.qual) if rec.qual != "*" else None
                    if q is None:
                        run_query_quals.append(np.zeros(len(query_part), np.int32))
                    else:
                        run_query_quals.append(np.asarray(
                            q[run.query_start:run.query_start + run.query_length],
                            dtype=np.int32,
                        ))
        if not run_refs:
            return None
        return realign_batch_start(
            run_refs,
            run_queries,
            self.gap_opening_cost,
            self.gap_extension_cost,
            run_ref_quals,
            run_query_quals,
            pad_ref=next_pow2(max(1, max(len(r) for r in run_refs))),
            pad_query=next_pow2(max(1, max(len(q) for q in run_queries))),
            device=self.device,
        )

    def _dispatch_fused_gap(self, batch, n_records: int):
        """Launch the v3 engine on a staged batch: (the fetch of its first
        six outputs, its full d_run on the device, fetched only when a
        deletion run reached 255)."""
        from .fused import fused_projection_kernel

        out = fused_projection_kernel(
            self.index, self.ref_flat_dev,
            batch.src_seq, batch.dst_seq, batch.rec_src_pos, batch.ref_off,
            batch.ops, batch.counts, batch.query,
            np.float32(self.gap_opening_cost), np.float32(self.gap_extension_cost),
            batch.pad_ref_units, batch.pad_ref_units + batch.ops.shape[1],
            self.FUSED_RUN_PAD, self.FUSED_RUN_PAD, max(256, n_records // 2),
        )
        return DeviceFetch(*out[:6]), out[6]

    def _finish_fused(self, handle) -> list[ProjectionResult]:
        """Finish a v3 batch: the host finalize from its wire, then its
        realigned runs, or the host path on overflow or a run mismatch."""
        _, records, queries, dst_ref_ids, batch, (fetch, d_run_dev), ref_seqs, cfg = handle
        _route("v3")
        b = len(records)
        dst_pos_a, d8, main_code, realign_ops, realign_counts, flags = fetch.get()
        d_run = d_run_dev.cpu().numpy() if int(flags[1]) else d8.astype(np.int32)
        dst_pos, rewritten, record_runs = self._finalize_any(batch, dst_pos_a, d_run, main_code, b)
        total_runs = int(flags[2])
        if int(flags[0]) or total_runs != sum(len(r) for r in record_runs):
            # run pool, run length or d_run packing overflowed, or device
            # and host run detection disagree: the host runs are right
            _route("host_realign")
            return self._realign_and_splice(
                records, queries, dst_ref_ids, ref_seqs, cfg, dst_pos, rewritten, record_runs,
            )
        realigned = realign_batch_finish((realign_ops[:total_runs], realign_counts[:total_runs]))
        return self._splice(records, dst_pos, rewritten, record_runs, realigned)

    def _finish_fused_event(self, handle) -> list[ProjectionResult]:
        """Finish a v4 batch: the host =/X reconstruction from its event
        wire, then the device-realigned runs matched one to one."""
        (_, records, queries, dst_ref_ids, batch, fetch, ref_seqs, cfg, ref_flat_host) = handle
        b = len(records)
        (dst_pos_a, gapbits, d_vals, d_pos, d_n, realign_ops, realign_counts,
         flags) = fetch.get()
        # a mesh's empty pad records come last; drop their rows
        dst_pos_a, gapbits, d_vals, d_pos, d_n = (
            a[:b] for a in (dst_pos_a, gapbits, d_vals, d_pos, d_n)
        )
        if int(flags[1]):
            # event slots or widths overflowed: the rewrite outputs are
            # invalid, so the batch goes through v3
            _route("v4_to_v3")
            return self._finish_fused(
                ("fused", records, queries, dst_ref_ids, batch,
                 self._dispatch_fused_gap(batch, b), ref_seqs, cfg)
            )
        dst_pos, rewritten, record_runs = self._finalize_wire(
            batch, fetch_gap_outputs([dst_pos_a, gapbits, d_vals, d_pos, d_n, 0], batch.pad_ref_units),
            ref_seqs, dst_ref_ids, ref_flat_host,
        )
        total_runs = int(flags[2])
        host_path = int(flags[0]) or total_runs != sum(len(r) for r in record_runs)
        if not host_path:
            realigned = realign_batch_finish((realign_ops[:total_runs], realign_counts[:total_runs]))
            # the DP took the device-detected slice lengths, so each
            # realigned CIGAR must consume what the host-detected run it
            # replaces spans (a run count alone passes when coordinates
            # shifted); runs are compacted in (record, CIGAR) order, the
            # host's flattened order
            flat_runs = [r for runs in record_runs for r in runs]
            for run, cig in zip(flat_runs, realigned):
                qc = sum(c for c, op in cig if op != "D")
                rc = sum(c for c, op in cig if op != "I")
                if qc != run.query_length or rc != run.ref_length:
                    host_path = True
                    break
        if host_path:
            _route("host_realign")
            return self._realign_and_splice(
                records, queries, dst_ref_ids, ref_seqs, cfg, dst_pos, rewritten, record_runs,
            )
        _route("v4_dp")
        return self._splice(records, dst_pos, rewritten, record_runs, realigned)

    def _finalize_wire(self, batch, wire, ref_seqs, dst_ref_ids, ref_flat_host):
        """The host half of a gap-geometry wire ``(dst_pos, d_run,
        isgap)``: =/X rebuilt from the query and reference bytes, then the
        finalize.  Returns (dst_pos, rewritten CIGARs, indel runs)."""
        dst_pos_a, d_run, isgap = wire
        b = len(dst_ref_ids)
        ref_lens = np.fromiter(
            (len(ref_seqs[r]) for r in dst_ref_ids), dtype=np.int64, count=b
        )
        main_code = reconstruct_main_code(
            batch.unit_op, batch.unit_count, batch.unit_rec, b, batch.pad_ref_units,
            dst_pos_a.astype(np.int32), d_run, isgap, np.asarray(batch.query),
            ref_flat_host, batch.ref_off, ref_lens,
        )
        return self._finalize_any(batch, dst_pos_a, d_run, main_code, b)

    def _finalize_any(self, batch, dst_pos_a, d_run, main_code, b):
        """The C finalize; where no C extension is loaded (the port always
        loads one: only a test takes it away), the numpy
        ``finalize_rewrite`` and ``find_indel_runs``, which the tests hold
        the C finalize against."""
        if get_native() is not None:
            return self._finalize_native(batch, dst_pos_a, d_run, main_code, b)
        dst_pos, rewritten = finalize_rewrite(batch, dst_pos_a, d_run, main_code)
        record_runs = [find_indel_runs(rewritten[i], dst_pos[i]) for i in range(b)]
        return dst_pos, rewritten, record_runs

    def _finalize_native(self, batch, dst_pos_a, d_run, main_code, b):
        """The C merge of the rewritten CIGARs and their indel runs."""
        native = get_native()
        valid = np.arange(batch.pad_ref_units)[None, :] < batch.n_ref_units[:, None]
        n_units = np.bincount(batch.unit_rec, minlength=b).astype(np.int32)
        run_ops_b, run_lens_b, runs_per_rec_b, indel_b = native.finalize_rewrite(
            np.ascontiguousarray(batch.unit_op),
            np.ascontiguousarray(batch.unit_count),
            n_units,
            np.ascontiguousarray(d_run[valid]),
            np.ascontiguousarray(main_code[valid]),
            np.ascontiguousarray(dst_pos_a.astype(np.int32)),
        )
        run_ops = np.frombuffer(run_ops_b, dtype=np.int8)
        run_lens = np.frombuffer(run_lens_b, dtype=np.int32)
        runs_per_rec = np.frombuffer(runs_per_rec_b, dtype=np.int32)
        run_off = np.concatenate([[0], np.cumsum(runs_per_rec)])
        ops_l = run_ops.tolist()
        lens_l = run_lens.tolist()
        rewritten = [
            [(lens_l[j], CODE_TO_OP[ops_l[j]]) for j in range(run_off[i], run_off[i + 1])]
            for i in range(b)
        ]
        dst_pos = [int(p) for p in dst_pos_a]
        record_runs: list[list] = [[] for _ in range(b)]
        indel_rows = np.frombuffer(indel_b, dtype=np.int32).reshape(-1, 9)
        for rec_i, r0, rl, q0, ql, cs, ce, cr, cq in indel_rows.tolist():
            record_runs[rec_i].append(IndelRun(
                ref_start=r0, ref_length=rl, query_start=q0, query_length=ql,
                cigar_start=cs, cigar_end=ce, checker_ref_pos=cr, checker_query_pos=cq,
            ))
        return dst_pos, rewritten, record_runs

    def _splice(self, records, dst_pos, rewritten, record_runs, realigned):
        """Splice the realigned runs into the rewritten CIGARs (already
        RLE-collapsed, so records without runs pass through)."""
        results: list[ProjectionResult] = []
        run_idx = 0
        for i in range(len(records)):
            runs = record_runs[i]
            res = ProjectionResult(dst_pos=dst_pos[i], cigar=rewritten[i])
            if runs:
                out = []
                copy_from = 0
                for run in runs:
                    out.extend(rewritten[i][copy_from:run.cigar_start])
                    copy_from = run.cigar_end
                    res.realigned_reference_ranges.append((run.checker_ref_pos, run.ref_length))
                    res.realigned_query_ranges.append((run.query_start, run.query_length))
                    res.num_realignments += 1
                    res.realigned_total_length += max(run.ref_length, run.query_length)
                    out.extend(realigned[run_idx])
                    run_idx += 1
                out.extend(rewritten[i][copy_from:])
                res.cigar = collapse_cigar(out)
            results.append(res)
        return results
