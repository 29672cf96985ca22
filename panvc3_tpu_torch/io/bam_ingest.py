"""BAM input staged straight into the fast lane's batches (the BAM ingest).

``BamIngest`` turns the records of a BAM reader into the fast lane's
staged batches: each the dict that ``parse_stage_batch`` returns for the
same records given as SAM text lines, cut as the fast lane cuts text
(after exactly ``batch_size`` kept records, the rest at the end), with the
batch's record count and kept count beside it.  The work is one pass of C,
``ops/csrc_host/bam_ingest.c`` (BGZF inflate, record decode, the
reader-loop filters, the cut and every staged buffer), bound by ctypes, so
it holds no GIL; the GIL is taken once a batch, to wrap its buffers as
NumPy arrays that free them when the last view goes.  ``IngestThread``
runs an ingest on a thread of its own, a bounded number of batches ahead.

The library is built with the host compiler into ``build_root()/host/``
at first use, as the event tables' scan is (``ops/event_geometry.py``).
"""

from __future__ import annotations

import ctypes
import pathlib
import queue
import shlex
import sysconfig
import threading

import numpy as np

from .. import tracing
from .._build import build_once, digest, run_compiler
from ..native import cpu_id
from .bgzf import bgzf_threads

SOURCE = pathlib.Path(__file__).resolve().parent.parent / "ops" / "csrc_host" / "bam_ingest.c"
# -march=native: a build is only valid on the CPU it was made for
FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-pthread")
# the staged buffers in the order the C hands them over, then its counts
BUFFERS = ("arena", "spans", "line_index", "fields", "n_ops", "n_ref_units", "n_units",
           "ops", "counts", "query", "unit_op", "unit_count", "unit_rec")
COUNTS = ("n_records", "kept", "flags_not_matched", "ref_id_missing", "seq_missing",
          "O", "R", "Lq")
READ_SIZE = 1 << 22  # compressed bytes a read, as SamReader reads BAM

_lock = threading.Lock()
_lib = None


def library() -> pathlib.Path:
    """Path of the built ingest (``build_root()/host/<digest>/``), building
    it first if needed."""
    cmd = shlex.split(sysconfig.get_config_var("CC") or "cc") + list(FLAGS)
    key = digest([SOURCE], cmd + ["-lz", cpu_id()])

    def build(out: pathlib.Path, work: pathlib.Path) -> None:
        run_compiler([*cmd, "-o", str(out), str(SOURCE), "-lz"], "the BAM ingest")

    return build_once("host", key, "libbam_ingest.so", build)


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(library()))
            P, I32, I64, L = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_long
            lib.bi_new.argtypes = [I32, P, ctypes.c_char_p, P, L, L, I64, I32, I32, I32,
                                   ctypes.c_int]
            lib.bi_new.restype = P
            lib.bi_feed.argtypes = lib.bi_feed_plain.argtypes = [P, ctypes.c_char_p, I64]
            lib.bi_next.argtypes = [P, ctypes.c_int, P, P, P]
            lib.bi_error.argtypes = [P]
            lib.bi_error.restype = ctypes.c_char_p
            lib.bi_release.argtypes = lib.bi_free.argtypes = [P]
            lib.bi_release.restype = lib.bi_free.restype = None
            _lib = lib
        return _lib


class _Buffer:
    """A buffer the C allocated, as a NumPy array's base: freed with the
    last array that views it."""

    def __init__(self, lib, ptr: int, n: int):
        self._free = lib.bi_release
        self._ptr = ptr
        self.__array_interface__ = {
            "data": (ptr, False), "shape": (n,), "typestr": "|u1", "version": 3,
        }

    def __del__(self):
        self._free(self._ptr)


class BamIngest:
    """The staged batches of a BAM reader's records, read past its header.

    ``refmap`` maps reference names (bytes) to the ids the batches carry,
    as ``parse_stage_batch``'s does; the filters and the ``min_*`` pads are
    its arguments too.  Errors are the text path's, in type and message.
    """

    def __init__(self, reader, refmap: dict, flag_skip: int, primary_mask: int,
                 batch_size: int, min_O: int, min_R: int, min_Lq: int):
        self._h = None
        self._lib = lib = _load()
        names = [name.encode() for name in reader.header.ref_names]
        lut = np.array([refmap.get(name, -2) for name in names], np.int32)
        off = np.zeros(len(names) + 1, np.int64)
        np.cumsum([len(name) for name in names], out=off[1:])
        self._h = lib.bi_new(len(names), lut.ctypes.data, b"".join(names), off.ctypes.data,
                             flag_skip, primary_mask, batch_size, min_O, min_R, min_Lq,
                             bgzf_threads())
        if not self._h:
            raise MemoryError("BAM ingest state")
        plain, comp, self._fh, self._eof = reader.take_bam_stream()
        if lib.bi_feed_plain(self._h, plain, len(plain)) or lib.bi_feed(self._h, comp, len(comp)):
            raise MemoryError("BAM ingest input")
        self._info = np.zeros(len(COUNTS), np.int64)
        self._ptr = (ctypes.c_void_p * len(BUFFERS))()
        self._len = np.zeros(len(BUFFERS), np.int64)
        self._batch = 0

    def next_batch(self):
        """``(staged, nrec, kept_exp)`` of the next batch, or None at the
        input's end."""
        lib, h = self._lib, self._h
        with tracing.span("bam_ingest", self._batch):
            while True:
                rc = lib.bi_next(h, int(self._eof), self._info.ctypes.data, self._ptr,
                                 self._len.ctypes.data)
                if rc == 1:
                    break
                if rc == 2:
                    return None
                if rc < 0:
                    msg = lib.bi_error(h).decode("utf-8", "replace")
                    raise (MemoryError if rc == -2 else ValueError)(msg)
                chunk = self._fh.read(READ_SIZE)
                if not chunk:
                    self._eof = True
                elif lib.bi_feed(h, chunk, len(chunk)):
                    raise MemoryError("BAM ingest input")
            staged = {
                key: np.asarray(_Buffer(lib, self._ptr[i], int(self._len[i])))
                for i, key in enumerate(BUFFERS)
            }
        counts = self._info.tolist()
        staged.update(zip(COUNTS, counts))
        self._batch += 1
        return staged, counts[0], counts[1]

    def close(self) -> None:
        if self._h:
            self._lib.bi_free(self._h)
            self._h = None

    def __del__(self):
        self.close()


class IngestThread:
    """``ingest.next_batch`` on a thread of its own, at most ``depth``
    staged batches ahead of ``get``; ``jitter`` runs before each hand-over
    (the fast lane's ``PANVC3_FASTLANE_CHAOS`` sleeps).  An error there is
    raised by ``get``; ``close`` stops and joins the thread, at whatever
    point it is."""

    def __init__(self, ingest: BamIngest, depth: int, jitter):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._jitter = jitter
        self._thread = threading.Thread(
            target=self._run, args=(ingest,), name="fastlane-ingest", daemon=True
        )
        self._thread.start()

    def _run(self, ingest: BamIngest) -> None:
        try:
            while not self._stop.is_set():
                item = ingest.next_batch()
                self._jitter()
                self._put(item)
                if item is None:
                    return
        except BaseException as exc:  # noqa: BLE001 — raised again by get
            self._put(exc)

    def _put(self, item) -> None:
        # a put blocked on a full queue sees close() within its timeout
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return
            except queue.Full:
                pass

    def get(self):
        item = self._q.get()
        if isinstance(item, BaseException):
            raise item
        return item

    def close(self) -> None:
        self._stop.set()
        self._thread.join()
