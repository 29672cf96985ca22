"""The batch projector's device state, as the fast lane uses it.

Counterpart of ``panvc3_tpu.ops.engine.BatchProjector``, holding only what
``pipeline/fastlane.run_fast`` touches: the deduplicated device sequence
ids, the realignment wall-time counter, and the flat reference (host bytes
plus a lazily made uint8 copy on the projector's device) that the
ref-gather wires read.  The gap-index tables (``.index``) belong to the
gap kernel, which is not ported yet.
"""

from __future__ import annotations

import threading

import numpy as np
import torch


class BatchProjector:
    def __init__(
        self,
        src_entries,
        dst_entries,
        ref_id_mapping,
        gap_opening_cost: int,
        gap_extension_cost: int,
        device: torch.device,
    ):
        self.device = torch.device(device)
        self.gap_opening_cost = gap_opening_cost
        self.gap_extension_cost = gap_extension_cost
        self.ref_id_mapping = ref_id_mapping
        # wall time spent staging, dispatching and fetching the batched
        # realignment DP
        self.realignment_time_ns = 0

        # device sequence ids: gap vectors deduplicated by identity; None
        # entries (references outside this index shard) get -1
        ids: dict[int, int] = {}

        def dev_id(entry):
            return ids.setdefault(id(entry.gaps), len(ids))

        self.src_dev_ids = [dev_id(e) if e is not None else -1 for e in src_entries]
        self.dst_dev_ids = [dev_id(e) if e is not None else -1 for e in dst_entries]

        # The lock pairs _ensure_refs (main thread, streams contigs in)
        # with ref_flat_snapshot (the drain thread reads a consistent
        # buffer/offset pair for the ref-gather wire).
        self._ref_lock = threading.Lock()
        self._ref_flat = None
        self._ref_flat_host = np.zeros(0, dtype=np.uint8)
        self._ref_off: dict[int, int] = {}

    @classmethod
    def from_numpy_state(cls, state: dict, device) -> "BatchProjector":
        """A projector rebuilt from plain numpy/int state (the keys of
        :meth:`numpy_state`), such as ``panvc3_tpu``'s projector holds."""
        bp = cls.__new__(cls)
        bp.device = torch.device(device)
        bp.gap_opening_cost = int(state["gap_opening_cost"])
        bp.gap_extension_cost = int(state["gap_extension_cost"])
        bp.ref_id_mapping = list(state.get("ref_id_mapping", []))
        bp.realignment_time_ns = 0
        bp.src_dev_ids = [int(v) for v in state["src_dev_ids"]]
        bp.dst_dev_ids = [int(v) for v in state["dst_dev_ids"]]
        bp._ref_lock = threading.Lock()
        bp._ref_flat = None
        bp._ref_flat_host = np.array(state["ref_flat_host"], dtype=np.uint8)
        bp._ref_off = {int(k): int(v) for k, v in state["ref_off"].items()}
        return bp

    def numpy_state(self) -> dict:
        """Plain numpy/int state: enough to rebuild the projector."""
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
    def index(self):
        raise NotImplementedError(
            "BatchProjector.index: the device gap index and the gap kernel "
            "are ROADMAP Queue 1 item 4"
        )

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
            self._ref_flat = torch.from_numpy(
                self._ref_flat_host.copy()
            ).to(self.device)
        return self._ref_flat
