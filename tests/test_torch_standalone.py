"""The port's copies of panvc3_tpu's host modules against their originals.

The port imports nothing of ``panvc3_tpu``: it carries copies of the host
modules it needs.  Each copy here meets its original on the same seeded
numpy inputs: rank/select, the ``.npz`` index both ways, the SAM parse and
format round trip, the event geometry, the lane controller's choices, the
host oracle, ``--engine host`` end to end, and the host helpers of
``parallel/distributed.py``.
"""

from __future__ import annotations

import ast
import inspect
import io
import os

import numpy as np
import pytest

from panvc3_tpu import align as ref_align
from panvc3_tpu import bitvec as ref_bitvec
from panvc3_tpu import msa_index as ref_msa
from panvc3_tpu.io import sam as ref_sam
from panvc3_tpu.ops import event_geometry as ref_geo
from panvc3_tpu.parallel import distributed as ref_dist
from panvc3_tpu.pipeline import fastlane as ref_fastlane
from panvc3_tpu.pipeline import project_alignments as ref_pa
from panvc3_tpu_torch import align as port_align
from panvc3_tpu_torch import bitvec as port_bitvec
from panvc3_tpu_torch import msa_index as port_msa
from panvc3_tpu_torch.io import sam as port_sam
from panvc3_tpu_torch.ops import event_geometry as port_geo
from panvc3_tpu_torch.parallel import distributed as port_dist
from panvc3_tpu_torch.pipeline import fastlane as port_fastlane
from panvc3_tpu_torch.pipeline import project_alignments as port_pa

from .test_fastpath import _rich_sam
from .test_workflow_data import WORKFLOW, founder_seqs, msa_files  # noqa: F401 (fixtures)

GENOME = str(WORKFLOW / "genome/genome.fa.gz")


def _gap_row(rng, n, rate):
    row = rng.choice(np.frombuffer(b"ACGT", np.uint8), n)
    row[rng.random(n) < rate] = ord("-")
    return row.tobytes()


@pytest.mark.parametrize("n,rate", [(1, 0.5), (31, 0.1), (8192, 0.02), (20000, 0.3), (70000, 0.9)])
def test_bitvec_rank_select_match(n, rate):
    rng = np.random.default_rng(n)
    row = _gap_row(rng, n, rate)
    want = ref_bitvec.GapBitVector.from_gap_string(row)
    got = port_bitvec.GapBitVector.from_gap_string(row)
    for key, val in want.state().items():
        assert np.array_equal(got.state()[key], val), key
    pos = rng.integers(0, n + 1, 500)
    assert np.array_equal(got.rank0(pos), want.rank0(pos))
    if want.n_zeros:
        k = rng.integers(1, want.n_zeros + 1, 500)
        assert np.array_equal(got.select0(k), want.select0(k))
        # the scalar walks, consecutive ranks included
        for kk in list(k[:20]) + list(range(1, min(want.n_zeros, 40) + 1)):
            assert got.select0(int(kk)) == want.select0(int(kk))
    for p in pos[:40]:
        assert got.rank0(int(p)) == want.rank0(int(p))
        if p < n:
            assert got[int(p)] == want[int(p)]


def _index(mod_msa, mod_bitvec, rows):
    index = mod_msa.MsaIndex()
    for chr_id, seqs in rows.items():
        chrom = mod_msa.ChrEntry(chr_id)
        chrom.sequence_entries = [
            mod_msa.SequenceEntry(sid, mod_bitvec.GapBitVector.from_gap_string(row))
            for sid, row in seqs.items()
        ]
        index.chr_entries.append(chrom)
    index.sort()
    return index


@pytest.mark.parametrize("direction", ["reference-to-port", "port-to-reference"])
@pytest.mark.parametrize("shard", [None, (0, 2), (1, 2)])
def test_msa_index_npz_round_trip(tmp_path, direction, shard):
    rng = np.random.default_rng(3)
    rows = {
        c: {s: _gap_row(rng, 3000 + 100 * i, 0.05) for s in ("REF", "1", "2")}
        for i, c in enumerate(("chr2", "chr1", "chrX"))
    }
    # every chromosome's rows share one width
    rows = {c: {s: r[:3000] for s, r in seqs.items()} for c, seqs in rows.items()}
    path = str(tmp_path / "msa.npz")
    writer, reader = (ref_msa, port_msa) if direction == "reference-to-port" else (port_msa, ref_msa)
    wb = ref_bitvec if writer is ref_msa else port_bitvec
    _index(writer, wb, rows).save(path)
    got = reader.MsaIndex.load(path, shard=shard)
    want = writer.MsaIndex.load(path, shard=shard)
    assert reader.MsaIndex.chromosome_ids(path) == ["chr1", "chr2", "chrX"]
    assert [c.chr_id for c in got.chr_entries] == [c.chr_id for c in want.chr_entries]
    for gc, wc in zip(got.chr_entries, want.chr_entries):
        assert [e.seq_id for e in gc.sequence_entries] == [e.seq_id for e in wc.sequence_entries]
        for ge, we in zip(gc.sequence_entries, wc.sequence_entries):
            for key, val in we.gaps.state().items():
                assert np.array_equal(ge.gaps.state()[key], val), key
            pos = np.arange(0, we.unaligned_length, 37)
            assert np.array_equal(ge.aligned_position(pos), we.aligned_position(pos))


def test_sam_round_trip_of_the_rich_fixture(founder_seqs):  # noqa: F811
    """Header and every record parse to the same fields and format back to
    the same text (the port in C; the reference in C or Python, as its own
    loader finds its build)."""
    sam = _rich_sam(founder_seqs)
    ref_reader = ref_sam.SamReader(io.BytesIO(sam))
    port_reader = port_sam.SamReader(io.BytesIO(sam))
    assert port_reader.header.lines == ref_reader.header.lines
    assert port_reader.header.ref_names == ref_reader.header.ref_names
    want = list(ref_reader)
    got = list(port_reader)
    assert len(got) == len(want) >= 160
    for g, w in zip(got, want):
        for name in w.__slots__:
            assert getattr(g, name) == getattr(w, name), (w.qname, name)
    ref_out, port_out = io.BytesIO(), io.BytesIO()
    ref_w = ref_sam.SamWriter(ref_out, ref_reader.header)
    port_w = port_sam.SamWriter(port_out, port_reader.header)
    for g, w in zip(got, want):
        ref_w.write(w)
        port_w.write(g)
    ref_w.close()
    port_w.close()
    assert port_out.getvalue() == ref_out.getvalue()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("native", ["1", "0"], ids=["native", "numpy"])
def test_event_geometry_matches(seed, native, monkeypatch):
    """``project_unit`` and ``EventGeometry.batch`` (the port on its C
    extension or on numpy; the reference on numpy) on random MSA rows."""
    monkeypatch.setenv("PANVC3_EVENT_GEOMETRY_NATIVE", native)
    rng = np.random.default_rng(seed)
    n = 5000
    rows = {s: _gap_row(rng, n, 0.1 + 0.1 * k) for k, s in enumerate(("REF", "1", "2"))}
    ents = {}
    for mod_msa, mod_bv in ((ref_msa, ref_bitvec), (port_msa, port_bitvec)):
        chrom = _index(mod_msa, mod_bv, {"c": rows}).chr_entries[0]
        ents[mod_msa] = [chrom.find(s) for s in ("1", "2", "REF")] + [chrom.find("REF")]
    for (ref_src, ref_dst), (port_src, port_dst) in zip(
        [(ents[ref_msa][i], ents[ref_msa][3]) for i in range(3)],
        [(ents[port_msa][i], ents[port_msa][3]) for i in range(3)],
    ):
        want_pe = ref_geo.build_pair_events(ref_src.gaps, ref_dst.gaps)
        got_pe = port_geo.build_pair_events(port_src.gaps, port_dst.gaps)
        u = rng.integers(0, ref_src.unaligned_length, 400)
        assert np.array_equal(port_geo.project_unit(got_pe, u), ref_geo.project_unit(want_pe, u))
    B, R = 300, 128
    ref_ids = rng.integers(0, 3, B).astype(np.int32)
    pos = rng.integers(0, 3000, B).astype(np.int32)
    units = rng.integers(1, R + 1, B).astype(np.int32)
    mapping = [0, 0, 0]
    want = ref_geo.EventGeometry(ents[ref_msa][:3], ents[ref_msa][3:], mapping)
    got = port_geo.EventGeometry(ents[port_msa][:3], ents[port_msa][3:], mapping)
    assert (got._native is not None) == (native == "1")
    for g, w in zip(got.batch(ref_ids, pos, units, R, 8), want.batch(ref_ids, pos, units, R, 8)):
        assert np.array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("mix", [None, "1"], ids=["unset", "lane-mix"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_lane_controller_choices_match(seed, mix, monkeypatch):
    """Both controllers fed one seeded stream of batches, lane timings and
    emits choose the same lane every time and end in the same state, with
    the opt-in graduated duty (PANVC3_LANE_MIX=1) and without it."""
    if mix:
        monkeypatch.setenv("PANVC3_LANE_MIX", mix)
    else:
        monkeypatch.delenv("PANVC3_LANE_MIX", raising=False)
    rng = np.random.default_rng(seed)
    ctrls = [ref_fastlane.LaneController(), port_fastlane.LaneController()]
    now = 0
    host_rate, dev_rate = rng.uniform(500, 4000, 2)
    for step in range(600):
        if step == 300:  # a workload-regime shift
            host_rate *= 6
        cells = int(rng.integers(1, 4_000_000)) if step < 300 else int(rng.integers(1, 40_000_000))
        reads = int(rng.integers(1000, 9000))
        picks = [c.decide(cells) for c in ctrls]
        assert picks[0] == picks[1], step
        host = picks[0]
        ns = int(reads * (host_rate if host else dev_rate) * rng.uniform(0.8, 1.25))
        now += ns
        for c in ctrls:
            if host:
                c.observe_host_dp(ns * 0.5, cells)
            else:
                c.observe_dev_batch(ns * 0.7)
            c.observe_emit(not host, reads, now, attribute=bool(step % 7), cells=cells)
        if step in (150, 450):
            for c in ctrls:
                c.begin_run()
    a, b = ctrls
    assert (a.mode, a.tick, a.backoff, a.span_count) == (b.mode, b.tick, b.backoff, b.span_count)
    assert a.ns_read == b.ns_read
    assert a.host_ns_cell == b.host_ns_cell and a.dev_ns_batch == b.dev_ns_batch


@pytest.mark.parametrize("n", [1, 7, 8, 9, 12, 13, 300])
def test_row_and_rq_buckets_match(n):
    assert port_fastlane._next_row_bucket(n) == ref_fastlane._next_row_bucket(n)
    assert port_fastlane._next_rq_bucket(n) == ref_fastlane._next_rq_bucket(n)


@pytest.mark.parametrize("quality", [False, True], ids=["int", "q"])
@pytest.mark.parametrize("seed", [0, 1])
def test_align_global_matches(quality, seed):
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"ACGTN", np.uint8)
    assert np.array_equal(port_align.malde_tables()[0], ref_align.malde_tables()[0])
    assert np.array_equal(port_align.malde_tables()[1], ref_align.malde_tables()[1])
    for _ in range(30):
        s1 = rng.choice(letters, int(rng.integers(0, 14))).tobytes()
        s2 = rng.choice(letters, int(rng.integers(0, 14))).tobytes()
        kw = {}
        if quality:
            kw = {
                "quals1": port_align.max_quality_array(len(s1)),
                "quals2": rng.integers(2, 42, len(s2)).astype(np.int32),
            }
        go, ge = int(rng.integers(-6, 1)), int(rng.integers(-3, 0))
        assert port_align.align_global(s1, s2, go, ge, **kw) == ref_align.align_global(s1, s2, go, ge, **kw)


def _host_cfg(mod, index_path, ranges, quality):
    return mod.ProjectConfig(
        msa_index_path=str(index_path),
        reference_path=GENOME,
        reference_msa_id="REF",
        ref_id_separator="/",
        tags=mod.TagSpec(rec_idx="XI"),
        engine="host",
        preserve_tags=("XA",),
        output_realigned_ranges_path=str(ranges),
        status_output_interval=0,
        use_read_base_qualities=quality,
    )


@pytest.mark.parametrize("quality", [False, True], ids=["int", "q"])
def test_engine_host_matches_reference(msa_files, founder_seqs, tmp_path, quality):  # noqa: F811
    """``--engine host``, the port's own host oracle end to end, against
    panvc3_tpu's host engine: SAM bytes, realigned ranges, statistics."""
    index_path, _, _ = msa_files
    sam = _rich_sam(founder_seqs, n_reads=96, seed=5)
    outs = {}
    for name, mod, kw in (("ref", ref_pa, {}), ("port", port_pa, {"device": "cpu"})):
        ranges = tmp_path / f"{name}_ranges.tsv"
        out = io.BytesIO()
        stats = mod.run_project_alignments(
            io.BytesIO(sam), out, _host_cfg(mod, index_path, ranges, quality), **kw
        )
        outs[name] = (out.getvalue(), ranges.read_text(), stats)
    (g_sam, g_ranges, g_stats), (w_sam, w_ranges, w_stats) = outs["port"], outs["ref"]
    assert g_sam == w_sam
    assert g_ranges == w_ranges
    assert g_stats.realigned_range_count == w_stats.realigned_range_count > 0
    assert g_stats.removed_tag_counts == w_stats.removed_tag_counts
    assert (g_stats.matched_reads, g_stats.flags_not_matched) == (
        w_stats.matched_reads, w_stats.flags_not_matched,
    )


def test_engine_host_cli_matches_reference(msa_files, founder_seqs, tmp_path):  # noqa: F811
    """The port's CLI with ``--engine host`` writes panvc3_tpu's SAM."""
    import subprocess
    import sys

    index_path, _, _ = msa_files
    sam = _rich_sam(founder_seqs, n_reads=48, seed=9)
    sam_path = tmp_path / "in.sam"
    sam_path.write_bytes(sam)
    ranges = tmp_path / "ref_ranges.tsv"
    want = io.BytesIO()
    ref_pa.run_project_alignments(io.BytesIO(sam), want, _host_cfg(ref_pa, index_path, ranges, False))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out_path = tmp_path / "port.sam"
    proc = subprocess.run(
        [
            sys.executable, "-m", "panvc3_tpu_torch", "project_alignments",
            "--engine", "host", "--device", "cpu", "-a", str(sam_path),
            "-m", str(index_path), "-r", GENOME, "-d", "REF", "-s", "/",
            "--record-index-tag", "XI", "-t", "XA", "--status-output-interval", "0",
            "-o", str(out_path),
        ],
        env=dict(os.environ, PYTHONPATH=repo), capture_output=True, timeout=300, cwd=repo,
    )
    assert proc.returncode == 0, proc.stderr.decode()

    def strip_pg(b):
        return b"\n".join(ln for ln in b.split(b"\n") if not ln.startswith(b"@PG"))

    assert strip_pg(out_path.read_bytes()) == strip_pg(want.getvalue())


def _code(fn) -> str:
    """A function's syntax tree without its docstring."""
    tree = ast.parse(inspect.getsource(fn)).body[0]
    if ast.get_docstring(tree) is not None:
        tree.body = tree.body[1:]
    return ast.dump(tree)


@pytest.mark.parametrize(
    "name",
    ["qname_shard", "split_records_by_qname", "byte_ranges", "split_chromosomes", "chr_shard",
     "split_records_by_chr"],
)
def test_distributed_copies_match(name):
    """The host helpers of ``parallel/distributed.py`` are the originals'
    code (docstrings aside), and ``msa_index`` takes ``split_chromosomes``
    from there, as the original does."""
    assert _code(getattr(port_dist, name)) == _code(getattr(ref_dist, name))
    assert port_msa.split_chromosomes is port_dist.split_chromosomes
