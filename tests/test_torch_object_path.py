"""The port's object path and batch projector against panvc3_tpu.

``ProjectConfig(fastlane=False)`` (and a projector whose device ids pass
the fast lane's u16 fields) takes the object path: parsed records in
batches through ``BatchProjector`` (the gap kernel over the device gap
index, the host finalize, the realignment on the device), here on the CPU
with ``PANVC3_HOST_DP=0`` so every run goes through K1's plain version.
Its SAM (``@PG`` stripped) and realigned-ranges TSV must equal
panvc3_tpu's on the same input, at every pipeline depth, threaded or not,
at batch sizes that leave a partial last batch and padding rows.
"""

from __future__ import annotations

import io

import numpy as np
import pytest

from panvc3_tpu.msa_index import MsaIndex as JaxMsaIndex
from panvc3_tpu.pipeline import project_alignments as jax_pa
from panvc3_tpu.projector import project_alignment as jax_project_alignment

from .test_engine import _synthesise_indel_sam
from .test_workflow_data import WORKFLOW, founder_seqs, msa_files  # noqa: F401 (fixtures)

GENOME = str(WORKFLOW / "genome/genome.fa.gz")


def _strip_pg(sam: bytes) -> bytes:
    return b"\n".join(ln for ln in sam.split(b"\n") if not ln.startswith(b"@PG"))


def _cfg(mod, index_path, ranges, quality, **kw):
    return mod.ProjectConfig(
        msa_index_path=str(index_path),
        reference_path=GENOME,
        reference_msa_id="REF",
        ref_id_separator="/",
        tags=mod.TagSpec(rec_idx="XI"),
        use_read_base_qualities=quality,
        output_realigned_ranges_path=str(ranges),
        keep_duplicate_ranges=True,
        debugging_output=True,
        status_output_interval=0,
        **kw,
    )


@pytest.fixture(scope="module")
def case(msa_files, founder_seqs, tmp_path_factory):  # noqa: F811
    """The reads, and panvc3_tpu's SAM and ranges for integer and -q."""
    index_path, _, _ = msa_files
    sam = _synthesise_indel_sam(founder_seqs, n_reads=120)
    tmp = tmp_path_factory.mktemp("jax")
    want = {}
    for quality in (False, True):
        ranges = tmp / f"ranges_{quality}.tsv"
        cfg = _cfg(jax_pa, index_path, ranges, quality, engine="host")
        out = io.BytesIO()
        jax_pa.run_project_alignments(io.BytesIO(sam), out, cfg)
        want[quality] = (out.getvalue(), ranges.read_text())
    return index_path, sam, want


def _port_run(index_path, sam, tmp_path, quality, **kw):
    from panvc3_tpu_torch.pipeline import project_alignments as port

    ranges = tmp_path / "port_ranges.tsv"
    cfg = _cfg(port, index_path, ranges, quality, engine="device", **kw)
    out = io.BytesIO()
    stats = port.run_project_alignments(io.BytesIO(sam), out, cfg, device="cpu")
    return out.getvalue(), ranges.read_text(), stats


@pytest.mark.parametrize("quality", [False, True], ids=["int", "q"])
@pytest.mark.parametrize(
    "depth,threaded,batch",
    [(1, True, 32), (2, False, 30), (3, True, 22), (2, True, 64), (3, False, 17)],
)
def test_object_path_matches_jax(case, tmp_path, monkeypatch, quality, depth, threaded, batch):
    from panvc3_tpu_torch.ops import _kernels
    from panvc3_tpu_torch.pipeline import project_alignments as port

    index_path, sam, want = case
    monkeypatch.setenv("PANVC3_HOST_DP", "0")
    calls = []
    real = port._run_object
    monkeypatch.setattr(port, "_run_object", lambda *a: calls.append(1) or real(*a))
    got, got_ranges, stats = _port_run(
        index_path, sam, tmp_path, quality, fastlane=False,
        pipeline_depth=depth, threaded_pipeline=threaded, device_batch_size=batch,
    )
    assert calls == [1]
    assert stats.matched_reads == 120 and stats.realigned_range_count > 0
    assert stats.realignment_time_ns > 0
    assert _strip_pg(got) == _strip_pg(want[quality][0])
    assert got_ranges == want[quality][1]
    # on the CPU the wrappers run their plain versions: nothing launched
    assert not any(_kernels.LAUNCHES.values())


@pytest.mark.parametrize("quality", [False, True], ids=["int", "q"])
def test_object_path_numpy_finalize_matches_jax(case, tmp_path, monkeypatch, quality):
    """Without the C extension in the engine, the finalize takes the numpy
    finalize_rewrite and find_indel_runs: the output is the same."""
    from panvc3_tpu_torch.ops import engine

    index_path, sam, want = case
    monkeypatch.setattr(engine, "get_native", lambda: None)
    got, got_ranges, _ = _port_run(
        index_path, sam, tmp_path, quality, fastlane=False, device_batch_size=40
    )
    assert _strip_pg(got) == _strip_pg(want[quality][0])
    assert got_ranges == want[quality][1]


def test_object_path_worker_error_reaches_the_caller(case, tmp_path, monkeypatch):
    """A failure on the worker thread is raised on the caller's thread, and
    the reader loop does not hang on the full queue."""
    from panvc3_tpu_torch.ops import engine

    index_path, sam, _ = case

    def boom(self, handle):
        raise RuntimeError("finish_rewrite failed")

    monkeypatch.setattr(engine.BatchProjector, "finish_rewrite", boom)
    with pytest.raises(RuntimeError, match="finish_rewrite failed"):
        _port_run(index_path, sam, tmp_path, False, fastlane=False, device_batch_size=8)


def _wide_projector(monkeypatch, shift=65536):
    """Make the engine hand out projectors whose device ids start at
    ``shift``: from_numpy_state of the real projector's state, with the
    gap index's per-sequence arrays prefixed by ``shift`` dummy entries."""
    from panvc3_tpu_torch.ops import engine

    real = engine.BatchProjector

    def factory(*args, device, mesh=None):
        assert mesh is None
        bp = real(*args, device=device)
        state = bp.numpy_state()
        index = bp.index.numpy_state()
        for key in ("seq_word_off", "seq_brank_off", "seq_nwords", "seq_nzeros",
                    "seq_zsel_off", "seq_rtab_off"):
            index[key] = np.concatenate([np.zeros(shift, np.int32), index[key]])
        state["index"] = index
        state["src_dev_ids"] = [v + shift if v >= 0 else v for v in state["src_dev_ids"]]
        state["dst_dev_ids"] = [v + shift if v >= 0 else v for v in state["dst_dev_ids"]]
        return real.from_numpy_state(state, device)

    monkeypatch.setattr(engine, "BatchProjector", factory)


def test_wide_device_ids_take_the_object_path(case, tmp_path, monkeypatch):
    """A projector with device ids >= 65536 does not fit the fast lane's
    u16 wire: fastlane_eligible sends it to the object path (the reference
    falls through the same way), whose output equals panvc3_tpu's."""
    from panvc3_tpu_torch.pipeline import fastlane
    from panvc3_tpu_torch.pipeline import project_alignments as port

    index_path, sam, want = case
    monkeypatch.setenv("PANVC3_HOST_DP", "0")
    _wide_projector(monkeypatch)
    calls = []
    monkeypatch.setattr(fastlane, "run_fast", lambda *a: calls.append("fast"))
    real = port._run_object
    monkeypatch.setattr(port, "_run_object", lambda *a: calls.append("object") or real(*a))
    got, got_ranges, _ = _port_run(index_path, sam, tmp_path, False, device_batch_size=32)
    assert calls == ["object"]
    assert _strip_pg(got) == _strip_pg(want[False][0])
    assert got_ranges == want[False][1]


def test_fastlane_eligible():
    from panvc3_tpu_torch.ops.engine import BatchProjector
    from panvc3_tpu_torch.parallel.mesh import make_mesh
    from panvc3_tpu_torch.pipeline import project_alignments as port
    from panvc3_tpu_torch.pipeline.fastlane import fastlane_eligible

    state = {
        "gap_opening_cost": 0, "gap_extension_cost": -1,
        "src_dev_ids": [0, 1, -1], "dst_dev_ids": [2],
        "ref_flat_host": np.zeros(1, np.uint8), "ref_off": {},
    }
    cfg = port.ProjectConfig()
    assert fastlane_eligible(cfg)
    assert fastlane_eligible(cfg, None, BatchProjector.from_numpy_state(state, "cpu"))
    for key, val in (("src_dev_ids", [0, 65535]), ("dst_dev_ids", [65535])):
        assert fastlane_eligible(cfg, None, BatchProjector.from_numpy_state({**state, key: val}, "cpu"))
    for key, val in (("src_dev_ids", [0, 65536]), ("dst_dev_ids", [70000])):
        assert not fastlane_eligible(cfg, None, BatchProjector.from_numpy_state({**state, key: val}, "cpu"))
    assert not fastlane_eligible(port.ProjectConfig(fused_kernel=True))
    # the fast lane is single-device: a mesh takes the object path
    assert not fastlane_eligible(cfg, make_mesh(2, ["cpu"] * 2))


@pytest.mark.parametrize("quality", [False, True], ids=["int", "q"])
def test_project_batch_matches_jax_oracle(msa_files, founder_seqs, monkeypatch, quality):  # noqa: F811
    """BatchProjector.project_batch, record by record, equals panvc3_tpu's
    scalar projector (which the JAX batch engine equals, test_engine)."""
    from panvc3_tpu_torch.io.fasta import FastaReader
    from panvc3_tpu_torch.io.sam import SamReader
    from panvc3_tpu_torch.msa_index import MsaIndex
    from panvc3_tpu_torch.ops.engine import BatchProjector
    from panvc3_tpu_torch.pipeline import project_alignments as port

    monkeypatch.setenv("PANVC3_HOST_DP", "0")
    index_path, _, _ = msa_files
    sam = _synthesise_indel_sam(founder_seqs, n_reads=45, seed=3)
    reader = SamReader(io.BytesIO(sam))
    records = list(reader)
    header = reader.header
    out_header, mapping = port.process_headers(header, "/", "REF", None)
    entries = port.fill_sequence_entries(
        MsaIndex.load(str(index_path)), header.ref_names, len(out_header.ref_names),
        "/", "REF", mapping,
    )
    jax_chrom = JaxMsaIndex.load(str(index_path)).find_chr("test")
    ref_seqs = {0: FastaReader(GENOME).read_sequence("test")}
    bp = BatchProjector(*entries, mapping, -6, -1, device="cpu")
    cfg = port.ProjectConfig(use_read_base_qualities=quality, device_batch_size=64)
    results = bp.project_batch(records, ref_seqs, cfg)
    assert len(results) == 45 and sum(r.num_realignments for r in results) > 0
    dst = jax_chrom.find("REF")
    for rec, got in zip(records, results):
        quals = None
        if quality:
            quals = np.frombuffer(rec.qual.encode(), np.uint8).astype(np.int32) - 33
        want = jax_project_alignment(
            rec.pos, jax_chrom.find(header.ref_names[rec.ref_id].split("/")[1]), dst,
            ref_seqs[0], rec.seq, rec.cigar, quals, -6, -1,
        )
        assert (got.dst_pos, got.cigar) == (want.dst_pos, want.cigar), rec.qname
        assert got.realigned_reference_ranges == want.realigned_reference_ranges
        assert got.realigned_query_ranges == want.realigned_query_ranges
        assert got.realigned_total_length == want.realigned_total_length
    # empty batches
    assert bp.project_batch([], ref_seqs, cfg) == []
    # the fused lane (gated off under -q) gives the same results
    fused_cfg = port.ProjectConfig(use_read_base_qualities=quality, fused_kernel=True)
    assert bp.project_batch(records, ref_seqs, fused_cfg) == results
