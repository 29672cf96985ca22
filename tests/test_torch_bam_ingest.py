"""The BAM ingest (``panvc3_tpu_torch/io/bam_ingest.py``) against the text
path it replaces for BAM input.

Each staged batch of ``BamIngest`` must equal, key by key and byte for
byte, ``parse_stage_batch`` over the lines that ``bam_to_sam_lines`` and
``scan_keep_mask`` give and that the fast lane's text cut (``form_batches``
in ``run_fast``, copied below) groups, with the same record and kept
counts; its errors must be the text path's, in type and message.  Whole
``project_alignments`` calls on the same records as BAM and as SAM text
must write the same bytes, threaded (under ``PANVC3_FASTLANE_CHAOS``) and
serial, and the JAX package's bytes on the same BAM; and a failure on a worker, on the ingest thread or at the output
must end the call, not hang it.
"""

from __future__ import annotations

import gzip
import io
import pathlib
import struct
import sys
import threading

import numpy as np
import pytest

from panvc3_tpu_torch.io import bam_ingest
from panvc3_tpu_torch.io import sam as port_sam
from panvc3_tpu_torch.io.bgzf import BGZF_EOF, BgzfWriter
from panvc3_tpu_torch.native import get_native
from panvc3_tpu_torch.pipeline import fastlane

from .test_fastpath import _rich_sam
from .test_torch_bam import _edge_sam
from .test_torch_fastlane import GENOME, _jax_host, _port_inprocess, _strip_pg
from .test_workflow_data import founder_seqs, msa_files  # noqa: F401 (fixtures)

BENCH_ROOT = pathlib.Path(__file__).resolve().parent.parent / "portbench"
sys.path.insert(0, str(BENCH_ROOT))

from harness import bam as bench_bam  # noqa: E402
from harness import msa as bench_msa  # noqa: E402
from harness import traffic as bench_traffic  # noqa: E402
from harness.spec import Spec  # noqa: E402

FLAG_SKIP = fastlane.FLAG_SKIP
INT_KEYS = ("n_records", "kept", "flags_not_matched", "ref_id_missing", "seq_missing",
            "O", "R", "Lq")


# ---- inputs ------------------------------------------------------------


def _bam_of_text(sam: bytes) -> bytes:
    """SAM text as BAM, converted in C (tags in text order)."""
    reader = port_sam.SamReader(io.BytesIO(sam))
    out = io.BytesIO()
    writer = port_sam.SamWriter(out, reader.header, bam=True)
    body = b"".join(ln if ln.endswith(b"\n") else ln + b"\n"
                    for block in reader.raw_record_line_blocks() for ln in block)
    writer.write_raw(body)
    writer.close()
    return out.getvalue()


def _bench_bam(config_name: str, seed: int = 2**31 + 24, pool: int = 1500,
               passes: int = 1) -> bytes:
    """A BAM of the benchmark's traffic for one configuration, at a small
    size, as its harness writes it: the pool's records in blocks of their
    own, ``passes`` times over."""
    spec = Spec(BENCH_ROOT.parent, BENCH_ROOT)
    config = dict(spec.config(config_name), msa_columns=200_000)
    mix = dict(spec.traffic("test_workflow_pairs"), pool_records=pool)
    made = bench_msa.Msa(seed, config, BENCH_ROOT / "configs")
    rows = bench_traffic.Rows(made)
    recs = bench_traffic.make_pool(seed, mix, rows, int(config["aligner_k"]),
                                   BENCH_ROOT / "traffic")
    names = [f"chr21/{s}" for s in made.ids]
    lengths = rows.lengths.tolist()
    text = "@HD\tVN:1.6\n" + "".join(f"@SQ\tSN:{n}\tLN:{ln}\n" for n, ln in zip(names, lengths))
    head = bench_bam.header_bytes(text, list(zip(names, lengths)))
    out = io.BytesIO()
    out.write(bench_bam.bgzf_blocks(head))
    out.write(bench_bam.bgzf_blocks(bench_bam.encode_records(recs, mix["mapq"])) * passes)
    out.write(BGZF_EOF)
    return out.getvalue()


def _filter_sam(seed: int = 5, n: int = 400) -> bytes:
    """Records that every reader-loop filter skips, mixed among kept ones
    in runs, so cuts land next to them: flags 0x4, 0x200, 0x400 and 0x100,
    RNAME ``*``, POS 0, SEQ ``*``; tags of every kind."""
    rng = np.random.default_rng(seed)
    lines = ["@HD\tVN:1.6", "@SQ\tSN:c1\tLN:5000", "@SQ\tSN:c2\tLN:5000"]
    for i in range(n):
        kind = int(rng.integers(0, 10))
        flag = int(rng.choice([0, 16, 99, 147, 163]))
        rname, pos, seq_star = str(rng.choice(["c1", "c2"])), int(rng.integers(1, 4000)), False
        if kind == 1:
            flag |= int(rng.choice([0x4, 0x200, 0x400]))
        elif kind == 2:
            flag |= 0x100
        elif kind == 3:
            rname = "*"
        elif kind == 4:
            pos = 0
        elif kind == 5:
            seq_star = True
        length = int(rng.integers(1, 40))
        k = int(rng.integers(0, 3))
        cigar = (f"{length}M" if k == 0 else f"2S{length - 2}M2D" if length > 2 and k == 1
                 else f"1=1X{length - 2}I3N" if length > 2 else f"{length}M")
        seq = "".join(rng.choice(list("ACGTNRYacgt="), length)) if not seq_star else "*"
        qual = "*" if seq_star or rng.random() < 0.2 else "".join(
            chr(33 + int(q)) for q in rng.integers(0, 42, length))
        rnext = str(rng.choice(["*", "=", "c1", "c2"]))
        tags = [f"AS:i:{int(rng.integers(-300, 300))}", f"XF:f:{float(rng.normal()):.6g}",
                f"XB:B:{rng.choice(list('cCsSiI'))},{int(rng.integers(0, 100))},7",
                f"XG:B:f,{float(rng.normal()):.5g},-0.25", "XZ:Z:some text", "XH:H:0AFF",
                "XA:A:q", "XE:B:i"]
        rng.shuffle(tags)
        lines.append("\t".join([f"r{i}", str(flag), rname, str(pos), str(int(rng.integers(0, 61))),
                                cigar if not seq_star else "*", rnext,
                                str(int(rng.integers(0, 4000))), str(int(rng.integers(-500, 500))),
                                seq, qual, *tags[:int(rng.integers(0, len(tags) + 1))]]))
    return ("\n".join(lines) + "\n").encode()


FLOAT_EDGES = (
    0x00000000, 0x80000000,  # +-0
    0x00000001, 0x80000001, 0x00000002, 0x0000000A, 0x007FFFFF,  # subnormals
    0x00800000, 0x00800001, 0x80800000,  # the least normals
    0x7F7FFFFF, 0xFF7FFFFF, 0x7F7FFFFE,  # float max
    0x7F800000, 0xFF800000,  # +-inf
    0x7FC00000, 0xFFC00000, 0x7F800001, 0x7FFFFFFF,  # nans, quiet and signalling
    0x3F800000, 0x3F7FFFFF, 0x3F800001, 0x4B800001, 0x3EAAAAAB,  # 1, its neighbours, 2^24+2, 1/3
)


def _floats_bam(seed: int = 11, n: int = 240) -> bytes:
    """Records whose ``f`` tags and ``B:f`` arrays hold float edge values,
    written as binary BAM so the bits are exact: +-0, subnormals, the
    least normals, float max, +-inf, nans, the powers of ten from 1e-45 to
    1e38 and their neighbours, and random bit patterns."""
    rng = np.random.default_rng(seed)
    tens = []
    for e in range(-45, 39):
        bits = int(np.float32(10.0 ** e).view(np.uint32))
        tens += [b for b in (bits - 1, bits, bits + 1) if 0 < b < 0x7F800000]
    values = np.array([*FLOAT_EDGES, *tens, *(b | 0x80000000 for b in tens),
                       *rng.integers(0, 1 << 32, 4 * n, dtype=np.uint64)], dtype=np.uint32)
    text = b"@HD\tVN:1.6\n@SQ\tSN:c1\tLN:5000\n"
    head = (b"BAM\x01" + struct.pack("<i", len(text)) + text + struct.pack("<i", 1)
            + struct.pack("<i", 3) + b"c1\x00" + struct.pack("<i", 5000))
    body = io.BytesIO()
    per = -(-len(values) // n)
    for i in range(n):
        chunk = values[i * per:(i + 1) * per]
        if not len(chunk):
            break
        name = f"f{i}".encode() + b"\x00"
        tags = b"XF" + b"f" + chunk[:1].tobytes()
        tags += b"XG" + b"B" + b"f" + struct.pack("<I", len(chunk)) + chunk.tobytes()
        core = struct.pack("<iiBBHHHiiii", 0, 10 + i, len(name), 60, 4680, 1, 0, 4, -1, -1, 0)
        rec = core + name + struct.pack("<I", 4 << 4) + bytes([0x12, 0x48]) + b"\x1e" * 4 + tags
        body.write(struct.pack("<i", len(rec)) + rec)
    out = io.BytesIO()
    w = BgzfWriter(out)
    w.write(head + body.getvalue())
    w.close()
    return out.getvalue()


@pytest.fixture(scope="module")
def bams():
    """BAM inputs by name; ``edge`` has float, ``B`` and ``Z`` tags, ``*``
    SEQ and QUAL, an unmapped record and one of 70 kB that spans BGZF
    blocks."""
    return {
        "bench_f4": _bench_bam("grch38_chr21_f4"),
        "bench_f4_q": _bench_bam("grch38_chr21_f4_q", seed=2**31 + 2207),
        # more BGZF blocks than the ingest inflates in one step
        "bench_f4_passes": _bench_bam("grch38_chr21_f4", pool=2000, passes=12),
        "edge": _bam_of_text(_edge_sam()),
        "filters": _bam_of_text(_filter_sam()),
        "floats": _floats_bam(),
    }


# ---- the two paths -----------------------------------------------------


def _refmap(reader) -> dict:
    return {name.encode(): i for i, name in enumerate(reader.header.ref_names)}


def text_batches(data: bytes, batch_size: int, primary_mask: int, min_R: int, refmap=None):
    """The text path on BAM input: SamReader's lines, the keep mask, the
    fast lane's cut (run_fast's form_batches) and parse_stage_batch."""
    nat = get_native()
    reader = port_sam.SamReader(io.BytesIO(data))
    refmap = _refmap(reader) if refmap is None else refmap
    out = []
    lines_buf, keep_buf, kept_in_buf = [], np.zeros(0, np.uint8), 0

    def form_batches(eof=False):
        nonlocal lines_buf, keep_buf, kept_in_buf
        while kept_in_buf >= batch_size or (eof and lines_buf):
            if kept_in_buf >= batch_size:
                cut = int(np.searchsorted(np.cumsum(keep_buf == 2), batch_size)) + 1
                batch, nrec, kept_exp = (lines_buf[:cut], int((keep_buf[:cut] >= 1).sum()),
                                         batch_size)
                lines_buf, keep_buf = lines_buf[cut:], keep_buf[cut:]
                kept_in_buf -= batch_size
            else:
                batch, nrec, kept_exp = lines_buf, int((keep_buf >= 1).sum()), kept_in_buf
                lines_buf, keep_buf, kept_in_buf = [], np.zeros(0, np.uint8), 0
            staged = nat.parse_stage_batch(batch, refmap, FLAG_SKIP, primary_mask, 4, min_R, 2)
            out.append((staged, nrec, kept_exp))

    for block in reader.raw_record_line_blocks():
        mask = np.frombuffer(nat.scan_keep_mask(block, FLAG_SKIP, primary_mask), np.uint8)
        lines_buf += block
        keep_buf = np.concatenate([keep_buf, mask])
        kept_in_buf += int((mask == 2).sum())
        form_batches()
    form_batches(eof=True)
    return out


def ingest_batches(data: bytes, batch_size: int, primary_mask: int, min_R: int, refmap=None):
    reader = port_sam.SamReader(io.BytesIO(data))
    refmap = _refmap(reader) if refmap is None else refmap
    ingest = bam_ingest.BamIngest(reader, refmap, FLAG_SKIP, primary_mask, batch_size, 4, min_R, 2)
    out = []
    while (item := ingest.next_batch()) is not None:
        out.append(item)
    ingest.close()
    return out


# ---- staged batches, byte for byte -------------------------------------

CASES = [
    ("bench_f4", 8192, 0, 2, None),
    ("bench_f4", 4, 0x100, 8, None),
    ("bench_f4_q", 8192, 0, 8, 1000),
    ("bench_f4_q", 4, 0, 2, 997),
    ("bench_f4_passes", 8192, 0, 8, None),
    ("bench_f4_passes", 5, 0, 2, 1 << 20),
    ("edge", 4, 0, 2, 333),
    ("edge", 8192, 0x100, 8, None),
    ("filters", 4, 0, 2, 101),
    ("filters", 4, 0x100, 8, None),
    ("filters", 8192, 0, 2, 4096),
    ("filters", 7, 0x100, 2, None),
    # the ingest's copy of the float format against bam_to_sam_lines'
    ("floats", 4, 0, 2, None),
    ("floats", 8192, 0, 8, 1000),
]


@pytest.mark.parametrize("name,batch_size,primary_mask,min_R,read_size", CASES)
def test_staged_batches_equal_the_text_path(bams, monkeypatch, name, batch_size, primary_mask,
                                            min_R, read_size):
    if read_size is not None:  # compressed reads that end inside BGZF blocks
        monkeypatch.setattr(bam_ingest, "READ_SIZE", read_size)
    data = bams[name]
    want = text_batches(data, batch_size, primary_mask, min_R)
    got = ingest_batches(data, batch_size, primary_mask, min_R)
    assert len(got) == len(want) > (1 if batch_size < 8 else 0)
    for i, ((g, g_nrec, g_kept), (w, w_nrec, w_kept)) in enumerate(zip(got, want)):
        assert (g_nrec, g_kept) == (w_nrec, w_kept), i
        assert set(g) == set(w), i
        for key in INT_KEYS:
            assert g[key] == w[key], (i, key)
        for key in bam_ingest.BUFFERS:
            assert bytes(g[key]) == w[key], (i, key)
    skipped = sum(w["flags_not_matched"] + w["ref_id_missing"] + w["seq_missing"]
                  for w, _, _ in want)
    assert skipped > 0 or name.startswith("bench") or name == "floats"
    if name == "floats":
        arena = b"".join(bytes(g["arena"]) for g, _, _ in got)
        for text in (b"XF:f:0\t", b",-0,", b",inf", b",-inf", b",nan", b",-nan", b"e-45",
                     b"e+38"):
            assert text in arena, text


def _truncate_payload(data: bytes, cut: int) -> bytes:
    """The BAM's inflated stream cut ``cut`` bytes before its end, written
    again as BGZF: a record that ends past the end of the file."""
    payload = gzip.decompress(data)
    out = io.BytesIO()
    w = BgzfWriter(out)
    w.write(payload[:-cut])
    w.close()
    return out.getvalue()


@pytest.mark.parametrize("fault", ["record", "block", "garbage", "corrupt", "reference",
                                   "mate_reference"])
def test_errors_equal_the_text_path(bams, fault):
    data, refmap = bams["filters"], None
    if fault == "record":
        data = _truncate_payload(data, 7)
    elif fault == "block":
        data = data[:-len(BGZF_EOF) - 11]
    elif fault == "garbage":  # whole blocks, then bytes that are no block
        data = data[:-len(BGZF_EOF)] + b"\x00" * 40
    elif fault == "corrupt":  # a deflate byte of the last block changed
        i = len(data) - len(BGZF_EOF) - 40
        data = data[:i] + bytes([data[i] ^ 0x55]) + data[i + 1:]
    else:
        if fault == "mate_reference":  # c2 only ever as RNEXT
            data = _bam_of_text(b"@SQ\tSN:c1\tLN:99\n@SQ\tSN:c2\tLN:99\n"
                                b"a\t0\tc1\t5\t0\t3M\t=\t9\t0\tACG\tIII\n"
                                b"b\t0\tc1\t5\t0\t3M\tc2\t9\t0\tACG\tIII\tXZ:Z:t\n")
        reader = port_sam.SamReader(io.BytesIO(data))
        refmap = _refmap(reader)
        del refmap[b"c2"]
    with pytest.raises(ValueError) as want:
        text_batches(data, 4, 0, 2, refmap)
    with pytest.raises(ValueError) as got:
        ingest_batches(data, 4, 0, 2, refmap)
    assert str(got.value) == str(want.value)
    expect = {"record": "truncated BAM record at EOF", "block": "truncated BGZF block at EOF",
              "garbage": "not a BGZF block", "corrupt": "BGZF inflate failed",
              "reference": "unknown reference 'c2", "mate_reference": "unknown mate reference"}
    assert str(got.value).startswith(expect[fault])


# ---- whole calls -------------------------------------------------------


def _canonical(sam: bytes):
    """The records as BAM, and as the SAM text that BAM reads back as."""
    data = _bam_of_text(sam)
    reader = port_sam.SamReader(io.BytesIO(data))
    text = reader.header.to_text().encode() + b"".join(
        ln for block in reader.raw_record_line_blocks() for ln in block)
    return data, text


@pytest.fixture(scope="module")
def whole(msa_files, founder_seqs, tmp_path_factory):  # noqa: F811
    """The records as BAM and as SAM text, and the JAX package's output
    (bytes, realigned ranges) on the same BAM."""
    index_path, _, _ = msa_files
    data, text = _canonical(_rich_sam(founder_seqs, n_reads=480, seed=12))
    reference = _jax_host(data, index_path, GENOME, tmp_path_factory.mktemp("jax"))
    return index_path, data, text, reference


def _diag_delta(run):
    before = dict(fastlane.AGG_DIAG)
    out = run()
    return out, {k: fastlane.AGG_DIAG[k] - before[k] for k in ("ingest_batches_bam",
                                                                 "ingest_batches_text")}


@pytest.mark.parametrize("mode", ["chaos-1", "chaos-2", "serial"])
def test_whole_call_bam_equals_sam_text(whole, tmp_path, monkeypatch, mode):
    index_path, data, text, (ref_out, ref_ranges) = whole
    kw = {}
    if mode == "serial":
        kw["threaded_pipeline"] = False
    else:
        monkeypatch.setenv("PANVC3_FASTLANE_CHAOS", mode[-1])
    # threads switch far more often than by default: a hand-over that is
    # lost or reordered shows in the bytes
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5 if mode == "chaos-2" else interval)
    try:
        (got, got_ranges, got_stats), bam_diag = _diag_delta(
            lambda: _port_inprocess(data, index_path, tmp_path, **kw))
    finally:
        sys.setswitchinterval(interval)
    (want, want_ranges, want_stats), text_diag = _diag_delta(
        lambda: _port_inprocess(text, index_path, tmp_path, **kw))
    assert want_stats.realigned_range_count > 0
    assert _strip_pg(got) == _strip_pg(want)
    assert got_ranges == want_ranges
    # and both are the JAX package's on the same BAM: a fault common to the
    # port's two paths (the record numbering, the cut) shows here
    assert _strip_pg(got) == _strip_pg(ref_out)
    assert got_ranges == ref_ranges
    counts = ("flags_not_matched", "ref_id_missing", "seq_missing", "matched_reads",
              "realigned_range_count", "removed_tag_counts", "realignment_cells")
    assert [getattr(got_stats, k) for k in counts] == [getattr(want_stats, k) for k in counts]
    # _port_inprocess cuts batches of 32 kept records
    assert bam_diag["ingest_batches_text"] == 0 and bam_diag["ingest_batches_bam"] > 1
    assert text_diag == {"ingest_batches_bam": 0,
                         "ingest_batches_text": bam_diag["ingest_batches_bam"]}


class _ClosingOutput(io.RawIOBase):
    """An output that takes ``keep`` writes, then fails as a closed pipe."""

    def __init__(self, keep: int):
        self.keep = keep

    def writable(self):
        return True

    def write(self, b):
        if self.keep <= 0:
            raise BrokenPipeError(32, "Broken pipe")
        self.keep -= 1
        return len(b)


def _call_within(seconds: float, fn):
    """Runs fn on a thread; its exception, or a failure if it hangs."""
    box = {}

    def run():
        try:
            fn()
        except BaseException as exc:  # noqa: BLE001 — handed to the test
            box["exc"] = exc

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"the call did not end within {seconds} s"
    return box.get("exc")


@pytest.mark.parametrize("fault", ["worker", "ingest", "output"])
def test_failures_end_the_call(whole, tmp_path, monkeypatch, fault):
    from panvc3_tpu_torch.pipeline import project_alignments as port

    index_path, data, _, _ = whole
    monkeypatch.setenv("PANVC3_FASTLANE_CHAOS", "5")
    out = io.BytesIO()
    if fault == "worker":
        real = get_native().finalize_reconstruct
        calls = []

        def boom(*args):
            calls.append(1)
            if len(calls) == 3:
                raise RuntimeError("worker fault")
            return real(*args)

        monkeypatch.setattr(get_native(), "finalize_reconstruct", boom)
    elif fault == "ingest":
        real_next = bam_ingest.BamIngest.next_batch

        def next_batch(self):
            if self._batch == 4:
                raise ValueError("ingest fault")
            return real_next(self)

        monkeypatch.setattr(bam_ingest.BamIngest, "next_batch", next_batch)
    else:
        out = io.BufferedWriter(_ClosingOutput(keep=2), buffer_size=16)
    cfg = port.ProjectConfig(
        msa_index_path=str(index_path), reference_path=GENOME, reference_msa_id="REF",
        ref_id_separator="/", engine="device", device_batch_size=32, status_output_interval=0,
    )
    exc = _call_within(120, lambda: port.run_project_alignments(io.BytesIO(data), out, cfg,
                                                                device="cpu"))
    expect = {"worker": RuntimeError, "ingest": ValueError, "output": BrokenPipeError}[fault]
    assert isinstance(exc, expect), repr(exc)
    assert not [t for t in threading.enumerate() if t.name == "fastlane-ingest"]
