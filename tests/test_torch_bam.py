"""BAM input and output of the port against panvc3_tpu.

The port encodes BAM two ways: ``SamWriter.write`` in Python
(``_encode_bam_record``, the object path and ``--engine host``) and
``SamWriter.write_raw`` in C (``sam_text_to_bam``, the fast lanes).  Both
are held against panvc3_tpu's codecs on the same records: encoded bytes
where the encoders are the same algorithm, else the inflated payload
decoded back to records.  BGZF output is compared after inflation (block
boundaries and deflate bytes depend on the thread count and on zlib).
``project_alignments`` runs SAM->BAM, BAM->SAM and BAM->BAM on the fast
lane, the object path and ``--engine host``, integer and ``-q``, against
panvc3_tpu's records.
"""

from __future__ import annotations

import gzip
import io
import random
import struct

import numpy as np
import pytest

from panvc3_tpu.io import bgzf as ref_bgzf
from panvc3_tpu.io import sam as ref_sam
from panvc3_tpu.pipeline import project_alignments as ref_pa
from panvc3_tpu_torch.io import bgzf as port_bgzf
from panvc3_tpu_torch.io import sam as port_sam
from panvc3_tpu_torch.native import get_native
from panvc3_tpu_torch.pipeline import project_alignments as port_pa

from .test_fastpath import _rich_sam
from .test_native_sam import _random_line
from .test_workflow_data import WORKFLOW, founder_seqs, msa_files  # noqa: F401 (fixtures)

GENOME = str(WORKFLOW / "genome/genome.fa.gz")
BUNDLED_BAM = str(WORKFLOW / "reads/alignment.bam")


def _edge_sam() -> bytes:
    """Records at the codecs' corners: every B subtype, f tags that
    ``format_float`` prints three ways, ``*`` SEQ and QUAL, odd-length SEQ,
    RNEXT ``=`` / named / ``*``, every integer width, H and A tags, an
    unmapped record, and a 70 kB record that spans BGZF blocks."""
    lines = [
        "@HD\tVN:1.6\tSO:unsorted",
        "@SQ\tSN:chr1\tLN:100000\tM5:abc",
        "@SQ\tSN:chr2\tLN:2000",
        "@PG\tID:aligner\tPN:aligner",
    ]
    lines += [
        "arr\t99\tchr1\t11\t60\t5M\t=\t101\t95\tACGTN\tIIIII"
        "\tZa:B:c,-128,127\tZb:B:C,0,255\tZc:B:s,-32768,32767"
        "\tZd:B:S,0,65535\tZe:B:i,-2147483648,2147483647"
        "\tZf:B:I,0,4294967295\tZg:B:f,1.5,-0.1,1e+20,3\tZh:B:C",
        "flt\t0\tchr2\t1\t0\t3M\tchr1\t7\t-5\tACG\t!~5"
        "\tFa:f:0.1\tFb:f:1e-10\tFc:f:123456789\tFd:f:-2.5\tFe:f:0",
        "star\t0\tchr1\t5\t255\t4M\t*\t0\t0\t*\t*\tNM:i:0",
        "noqual\t16\tchr1\t5\t7\t7M\t*\t0\t0\tACGTACG\t*",
        "odd\t0\tchr1\t9\t1\t3M1I3M\t=\t9\t0\tacgtRYK\tABCDEFG",
        "ints\t0\tchr2\t2\t3\t1M\t*\t0\t0\tA\tI"
        "\tIa:i:0\tIb:i:255\tIc:i:-1\tId:i:-128\tIe:i:256\tIf:i:65535"
        "\tIg:i:-129\tIh:i:-32768\tIi:i:65536\tIj:i:4294967295"
        "\tIk:i:-32769\tIl:i:-2147483648",
        "chars\t0\tchr1\t1\t9\t2M\t*\t0\t0\tAC\tII\tCa:A:x\tCh:H:1AE301\tCz:Z:a b\tCy:Z:",
        "unm\t4\t*\t0\t0\t*\t*\t0\t0\tACGT\tIIII",
        "ops\t0\tchr1\t3\t60\t2H3S4M1I2D1N1P2=1X\t*\t0\t0\tACGTACGTACG\tIIIIIIIIIII",
        "long\t0\tchr1\t100\t60\t70001M\t*\t0\t0\t" + "ACGTA" * 14000 + "C\t" + "F" * 70001,
    ]
    return ("\n".join(lines) + "\n").encode()


def _random_sam() -> bytes:
    rng = np.random.default_rng(7)
    rnd = random.Random(7)
    lines = ["@HD\tVN:1.6", "@SQ\tSN:chr1\tLN:1000", "@SQ\tSN:chr2\tLN:2000"]
    lines += [_random_line(rng, rnd, i) for i in range(300)]
    return ("\n".join(lines) + "\n").encode()


@pytest.fixture(scope="module")
def fixtures(founder_seqs):  # noqa: F811
    return {
        "rich": _rich_sam(founder_seqs),
        "edge": _edge_sam(),
        "random": _random_sam(),
    }


FIXTURES = ["rich", "edge", "random"]


def _fields(rec):
    return tuple(getattr(rec, name) for name in rec.__slots__)


def _records(mod, data: bytes):
    reader = mod.SamReader(io.BytesIO(data))
    return reader.header, list(reader)


def _lines(mod, data: bytes) -> list[str]:
    header, recs = _records(mod, data)
    return [mod.format_sam_record(r, header) for r in recs]


def _write_bam(mod, header, recs) -> bytes:
    out = io.BytesIO()
    w = mod.SamWriter(out, header, bam=True)
    for r in recs:
        w.write(r)
    w.close()
    return out.getvalue()


def _split_records(payload: bytes) -> list[bytes]:
    """The record blobs (without their length words) of an inflated BAM."""
    assert payload[:4] == b"BAM\x01"
    (l_text,) = struct.unpack_from("<i", payload, 4)
    off = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", payload, off)
    off += 4
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", payload, off)
        off += 8 + l_name
    out = []
    while off < len(payload):
        (size,) = struct.unpack_from("<I", payload, off)
        out.append(payload[off + 4:off + 4 + size])
        off += 4 + size
    assert off == len(payload)
    return out


@pytest.mark.parametrize("name", FIXTURES)
def test_python_bam_codec_matches(fixtures, name):
    """``_encode_bam_record`` byte for byte, and both packages' decoders on
    those bytes field for field; tags too on their own."""
    header, want = _records(ref_sam, fixtures[name])
    _, got = _records(port_sam, fixtures[name])
    assert len(got) == len(want) > 8
    for g, w in zip(got, want):
        assert _fields(g) == _fields(w)
        blob = ref_sam._encode_bam_record(w)
        assert port_sam._encode_bam_record(g) == blob
        assert port_sam._encode_bam_tags(g.tags) == ref_sam._encode_bam_tags(w.tags)
        want_rec = ref_sam._decode_bam_record(blob[4:], header)
        got_rec = port_sam._decode_bam_record(blob[4:], header)
        assert _fields(got_rec) == _fields(want_rec)
        tags = ref_sam._encode_bam_tags(w.tags)
        assert port_sam._decode_bam_tags(tags) == ref_sam._decode_bam_tags(tags)


@pytest.mark.parametrize("name", FIXTURES)
def test_c_bam_encoder_matches(fixtures, name):
    """``sam_text_to_bam`` (what ``write_raw`` calls) on the canonical text
    of every record: decoded by panvc3_tpu's decoder, each record prints
    the text panvc3_tpu's own encoder round-trips to."""
    header, recs = _records(ref_sam, fixtures[name])
    text = "".join(ref_sam.format_sam_record(r, header) + "\n" for r in recs).encode()
    blob = get_native().sam_text_to_bam(text, header.ref_names)
    off = 0
    for rec in recs:
        (size,) = struct.unpack_from("<I", blob, off)
        got = ref_sam._decode_bam_record(blob[off + 4:off + 4 + size], header)
        off += 4 + size
        want = ref_sam._decode_bam_record(ref_sam._encode_bam_record(rec)[4:], header)
        assert ref_sam.format_sam_record(got, header) == ref_sam.format_sam_record(want, header)
        assert (got.ref_id, got.mate_ref_id, got.pos, got.mate_pos) == (
            want.ref_id, want.mate_ref_id, want.pos, want.mate_pos,
        )
    assert off == len(blob)


@pytest.mark.parametrize("name", FIXTURES)
@pytest.mark.parametrize("writer", ["reference", "port-write", "port-write_raw"])
def test_bam_files_cross_read(fixtures, name, writer):
    """A BAM written by either package (the port by both encoders) reads
    back in both packages to the records of the SAM text."""
    want = _lines(ref_sam, fixtures[name])
    if writer == "reference":
        bam = _write_bam(ref_sam, *_records(ref_sam, fixtures[name]))
    elif writer == "port-write":
        bam = _write_bam(port_sam, *_records(port_sam, fixtures[name]))
    else:
        header, _ = _records(port_sam, fixtures[name])
        out = io.BytesIO()
        w = port_sam.SamWriter(out, header, bam=True)
        w.write_raw("".join(ln + "\n" for ln in want).encode())
        w.close()
        bam = out.getvalue()
    assert bam.endswith(port_bgzf.BGZF_EOF)
    # BAM stores a base outside its 16-letter code as N, and letters upper-case
    ref_again = _lines(ref_sam, bam)
    assert len(ref_again) == len(want)
    assert _lines(port_sam, bam) == ref_again
    ref_header, _ = _records(ref_sam, bam)
    port_header, _ = _records(port_sam, bam)
    assert port_header.lines == ref_header.lines
    assert port_header.ref_names == ref_header.ref_names
    assert port_header.ref_lengths == ref_header.ref_lengths
    if name != "rich":  # rich holds NUL bytes in SEQ, which BAM turns to N
        for g, w in zip(ref_again, want):
            gf, wf = g.split("\t"), w.split("\t")
            assert gf[:9] == wf[:9] and gf[10:] == wf[10:]
            assert gf[9] == wf[9].upper()


@pytest.mark.parametrize("name", FIXTURES)
def test_bam_inflated_payload_matches(fixtures, name):
    """Record by record, ``SamWriter.write`` gives panvc3_tpu's payload;
    ``write_raw`` gives a payload that decodes to the same records."""
    ref_header, ref_recs = _records(ref_sam, fixtures[name])
    port_header, port_recs = _records(port_sam, fixtures[name])
    want = gzip.decompress(_write_bam(ref_sam, ref_header, ref_recs))
    assert gzip.decompress(_write_bam(port_sam, port_header, port_recs)) == want
    out = io.BytesIO()
    w = port_sam.SamWriter(out, port_header, bam=True)
    for r in port_recs:
        w.write_raw((port_sam.format_sam_record(r, port_header) + "\n").encode())
    w.close()
    raw = _split_records(gzip.decompress(out.getvalue()))
    py = _split_records(want)
    assert len(raw) == len(py)
    for a, b in zip(raw, py):
        ra = ref_sam._decode_bam_record(a, ref_header)
        rb = ref_sam._decode_bam_record(b, ref_header)
        assert _fields(ra) == _fields(rb)


def test_write_raw_names_override():
    """``names=`` maps the text's RNAMEs to reference ids when the output
    header renames the references (split_alignments --rewrite)."""
    header = port_sam.SamHeader.parse("@HD\tVN:1.6\n@SQ\tSN:new1\tLN:50\n@SQ\tSN:new2\tLN:60")
    text = (
        b"a\t0\told2\t3\t9\t2M\told1\t5\t0\tAC\tII\n"
        b"b\t0\told1\t1\t9\t2M\t=\t7\t0\tAC\tII\n"
    )
    out = io.BytesIO()
    w = port_sam.SamWriter(out, header, bam=True)
    w.write_raw(text, names=["old1", "old2"])
    w.close()
    for mod in (ref_sam, port_sam):
        recs = list(mod.SamReader(io.BytesIO(out.getvalue())))
        assert [(r.ref_id, r.mate_ref_id) for r in recs] == [(1, 0), (0, 0)]
    with pytest.raises(ValueError):
        w2 = port_sam.SamWriter(io.BytesIO(), header, bam=True)
        w2.write_raw(text)  # the header's own names do not hold old1/old2


def test_bundled_bam_reads_alike():
    ref_reader = ref_sam.SamReader(BUNDLED_BAM)
    port_reader = port_sam.SamReader(BUNDLED_BAM)
    assert port_reader.is_bam and ref_reader.is_bam
    assert port_reader.header.lines == ref_reader.header.lines
    want = list(ref_reader)
    got = list(port_reader)
    assert len(got) == len(want) == 2000
    for g, w in zip(got, want):
        assert _fields(g) == _fields(w)
    assert got[0].query_length() == len(got[0].seq)
    assert got[0].is_unmapped == want[0].is_unmapped
    # the raw lane's lines (tags in the file's order) parse to the same records
    raw = [
        ln for block in port_sam.SamReader(BUNDLED_BAM).raw_record_line_blocks(hint=4096)
        for ln in block
    ]
    assert [
        _fields(port_sam.parse_sam_record(ln.decode(), port_reader.header)) for ln in raw
    ] == [_fields(r) for r in want]


@pytest.mark.parametrize("is_bam", [None, True])
def test_is_bam_flag_and_gzip_sam(fixtures, is_bam):
    bam = _write_bam(port_sam, *_records(port_sam, fixtures["edge"]))
    assert port_sam.SamReader(io.BytesIO(bam), is_bam=is_bam).is_bam
    gz = gzip.compress(fixtures["edge"])
    reader = port_sam.SamReader(io.BytesIO(gz))
    assert not reader.is_bam
    assert [_fields(r) for r in reader] == [
        _fields(r) for r in ref_sam.SamReader(io.BytesIO(gz))
    ]
    with pytest.raises(ValueError):
        port_sam.SamReader(io.BytesIO(fixtures["edge"]), is_bam=True)


def test_truncated_bam_raises(fixtures):
    bam = _write_bam(port_sam, *_records(port_sam, fixtures["random"]))
    with pytest.raises(ValueError, match="truncated BGZF"):
        list(port_sam.SamReader(io.BytesIO(bam[:len(bam) - 40])))
    # whole blocks, but the last record is cut
    payload = gzip.decompress(bam)[:-7]
    out = io.BytesIO()
    w = port_bgzf.BgzfWriter(out)
    w.write(payload)
    w.close()
    with pytest.raises(ValueError, match="truncated BAM record"):
        list(port_sam.SamReader(io.BytesIO(out.getvalue())))


@pytest.mark.parametrize("threads", ["1", "4"])
@pytest.mark.parametrize("size", [0, 1, 65280, 65281, 5_000_003])
def test_bgzf_writer_round_trip(monkeypatch, size, threads):
    monkeypatch.setenv("PANVC3_BGZF_THREADS", threads)
    assert port_bgzf.bgzf_threads() == int(threads)
    rng = np.random.default_rng(size)
    data = rng.integers(0, 4, size, dtype=np.uint8).tobytes()
    out = io.BytesIO()
    w = port_bgzf.BgzfWriter(out)
    for i in range(0, size, 1_000_000):
        w.write(data[i:i + 1_000_000])
    w.close()
    comp = out.getvalue()
    assert comp.endswith(port_bgzf.BGZF_EOF) and port_bgzf.BGZF_EOF == ref_bgzf.BGZF_EOF
    assert gzip.decompress(comp) == data
    assert get_native().bgzf_decompress(comp, int(threads)) == data
    # panvc3_tpu's block reader walks the same framing
    fh = io.BytesIO(comp)
    blocks = []
    while (blk := ref_bgzf._read_block(fh)) is not None:
        blocks.append(blk[0])
    assert b"".join(blocks) == data
    assert all(len(b) <= port_bgzf.MAX_BLOCK_UNCOMPRESSED for b in blocks)
    for cut in (0, 11, 27, 28, len(comp) // 2, len(comp) - 1, len(comp)):
        assert port_bgzf.whole_block_prefix(comp[:cut]) == ref_bgzf.whole_block_prefix(comp[:cut])


# -- project_alignments -------------------------------------------------------

ROUTES = {
    "fast-lane": dict(engine="device", fastlane=True),
    "object-path": dict(engine="device", fastlane=False),
    "engine-host": dict(engine="host"),
}


def _cfg(mod, index_path, ranges, quality, **kw):
    return mod.ProjectConfig(
        msa_index_path=str(index_path),
        reference_path=GENOME,
        reference_msa_id="REF",
        ref_id_separator="/",
        tags=mod.TagSpec(rec_idx="XI"),
        preserve_tags=("XA",),
        output_realigned_ranges_path=str(ranges),
        status_output_interval=0,
        use_read_base_qualities=quality,
        device_batch_size=32,
        **kw,
    )


@pytest.fixture(scope="module")
def project_case(msa_files, founder_seqs, tmp_path_factory):  # noqa: F811
    """Input as SAM and as BAM, and panvc3_tpu's host-engine records and
    ranges for each input and scoring."""
    index_path, _, _ = msa_files
    sam = _rich_sam(founder_seqs, n_reads=96, seed=21)
    bam = _write_bam(ref_sam, *_records(ref_sam, sam))
    tmp = tmp_path_factory.mktemp("bamref")
    want = {}
    for kind, data in (("sam", sam), ("bam", bam)):
        for quality in (False, True):
            ranges = tmp / f"{kind}_{quality}.tsv"
            out = io.BytesIO()
            stats = ref_pa.run_project_alignments(
                io.BytesIO(data), out, _cfg(ref_pa, index_path, ranges, quality, engine="host")
            )
            assert stats.realigned_range_count > 0
            header, recs = _records(ref_sam, out.getvalue())
            want[kind, quality] = (
                [ln for ln in header.lines if not ln.startswith("@PG")],
                [ref_sam.format_sam_record(r, header) for r in recs],
                ranges.read_text(),
                stats,
            )
    return index_path, {"sam": sam, "bam": bam}, want


@pytest.mark.parametrize("quality", [False, True], ids=["int", "q"])
@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("io_kind", ["sam-bam", "bam-sam", "bam-bam"])
def test_project_alignments_bam(project_case, tmp_path, monkeypatch, io_kind, route, quality):
    index_path, inputs, want = project_case
    in_kind, out_kind = io_kind.split("-")
    monkeypatch.setenv("PANVC3_HOST_DP", "0")  # the device lane of the fast lane
    ranges = tmp_path / "ranges.tsv"
    cfg = _cfg(
        port_pa, index_path, ranges, quality,
        output_bam=(out_kind == "bam"), **ROUTES[route],
    )
    out = io.BytesIO()
    stats = port_pa.run_project_alignments(io.BytesIO(inputs[in_kind]), out, cfg, device="cpu")
    data = out.getvalue()
    assert (data[:2] == b"\x1f\x8b") == (out_kind == "bam")
    # read back with panvc3_tpu's reader: the port's output is its input
    header, recs = _records(ref_sam, data)
    want_header, want_lines, want_ranges, want_stats = want[in_kind, quality]
    assert [ln for ln in header.lines if not ln.startswith("@PG")] == want_header
    assert [ref_sam.format_sam_record(r, header) for r in recs] == want_lines
    assert ranges.read_text() == want_ranges
    assert (stats.matched_reads, stats.flags_not_matched, stats.seq_missing) == (
        want_stats.matched_reads, want_stats.flags_not_matched, want_stats.seq_missing,
    )
    assert stats.realigned_range_count == want_stats.realigned_range_count
    if out_kind == "bam":
        assert _lines(port_sam, data) == want_lines


def test_project_alignments_bam_payload_matches_reference(project_case, tmp_path):
    """BAM out of the object path (the Python encoder in both packages):
    the inflated record region equals panvc3_tpu's, byte for byte."""
    index_path, inputs, _ = project_case
    payloads = {}
    for name, mod, kw in (("ref", ref_pa, {}), ("port", port_pa, {"device": "cpu"})):
        out = io.BytesIO()
        cfg = _cfg(mod, index_path, tmp_path / f"{name}.tsv", False,
                   engine="host", output_bam=True)
        mod.run_project_alignments(io.BytesIO(inputs["bam"]), out, cfg, **kw)
        payloads[name] = _split_records(gzip.decompress(out.getvalue()))
    assert payloads["port"] == payloads["ref"] and len(payloads["ref"]) > 50
