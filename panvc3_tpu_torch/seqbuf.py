"""Bounded LRU store for decompressed reference contig buffers (copy of
``panvc3_tpu.seqbuf``).

The store keeps at most ``max_size`` unpinned buffers in LRU order.
``require()`` returns an immutable per-batch snapshot dict: buffers a
dispatched batch still references stay alive through the snapshot's
references, so eviction never invalidates in-flight work.
"""

from __future__ import annotations

import threading
from typing import Callable, Iterator


class SequenceBufferStore:
    """LRU-bounded mapping ``key -> bytes`` with a lazy loader.

    ``require``/``get`` are serialized by a lock: the fast lane calls them
    from pool workers (one call per batch — the lock is never hot)."""

    def __init__(self, load: Callable[[int], bytes], max_size: int = 4):
        self._load = load
        self._max = max(1, max_size)
        self._map: dict[int, bytes] = {}  # insertion order == LRU order
        self._lock = threading.Lock()

    def _get_locked(self, key: int) -> bytes:
        if key in self._map:
            v = self._map.pop(key)  # move to most-recent position
            self._map[key] = v
            return v
        v = self._load(key)
        self._map[key] = v
        self._evict()
        return v

    def get(self, key: int) -> bytes:
        with self._lock:
            return self._get_locked(key)

    def require(self, keys) -> dict[int, bytes]:
        """Load ``keys`` and return a snapshot dict for one batch.

        All requested keys are protected from eviction while trimming, so
        a batch needing more than ``max_size`` contigs still gets a
        complete snapshot (the bound then applies between batches)."""
        keys = list(keys)
        with self._lock:
            snap = {k: self._get_locked(k) for k in keys}
            self._evict(set(keys))
        return snap

    def _evict(self, protect: set | None = None) -> None:
        if len(self._map) <= self._max:
            return
        for k in list(self._map):
            if len(self._map) <= self._max:
                break
            if protect and k in protect:
                continue
            del self._map[k]

    # the host oracle reads the store like a dict
    def __getitem__(self, key: int) -> bytes:
        return self.get(key)

    def __contains__(self, key: int) -> bool:
        return key in self._map

    def __len__(self) -> int:
        return len(self._map)

    def __iter__(self) -> Iterator[int]:
        return iter(self._map)
