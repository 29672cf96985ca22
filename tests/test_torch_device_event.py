"""The port's device event geometry against panvc3_tpu, and the fast
lane's two device geometry routes end to end.

``DeviceEventGeometry``'s tables must equal the JAX object's, attribute by
attribute, and ``kernel_wire`` its output byte for byte (buckets on and
off, at edge and random positions); where no record overflows, the wire
must also equal the gap kernel's.  ``PANVC3_EVENT_GEOMETRY=device`` and
``=0`` then run through the CLI with ``--device cpu`` and in process,
including batches that overflow the device geometry, and their SAM and
ranges must equal panvc3_tpu's.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from panvc3_tpu.bitvec import GapBitVector as JaxGapBitVector
from panvc3_tpu.msa_index import SequenceEntry as JaxSequenceEntry
from panvc3_tpu.ops import event_geometry as jax_eg
from panvc3_tpu_torch.bitvec import GapBitVector
from panvc3_tpu_torch.msa_index import SequenceEntry
from panvc3_tpu_torch.ops import event_geometry as eg
from panvc3_tpu_torch.ops import rewrite_batch as rb
from panvc3_tpu_torch.ops.rank_select import DeviceGapIndex

from .test_engine import _synthesise_indel_sam
from .test_torch_fastlane import GENOME, _jax_host, _port_cli, _port_inprocess, _strip_pg
from .test_workflow_data import founder_seqs, msa_files  # noqa: F401 (fixtures)


def _geometries(srcs, dsts, rim, monkeypatch=None):
    """(JAX host, JAX device, port host, port device) geometries of the
    same gap strings (host tables in numpy, as the oracle tests use)."""
    if monkeypatch is not None:
        monkeypatch.setenv("PANVC3_EVENT_GEOMETRY_NATIVE", "0")

    def entries(mod_se, mod_gv, rows, prefix):
        return [mod_se(f"{prefix}{i}", mod_gv.from_gap_string(r)) for i, r in enumerate(rows)]

    jh = jax_eg.EventGeometry(
        entries(JaxSequenceEntry, JaxGapBitVector, srcs, "F"),
        entries(JaxSequenceEntry, JaxGapBitVector, dsts, "R"), rim,
    )
    th = eg.EventGeometry(
        entries(SequenceEntry, GapBitVector, srcs, "F"),
        entries(SequenceEntry, GapBitVector, dsts, "R"), rim,
    )
    return jh, jax_eg.DeviceEventGeometry(jh), th, eg.DeviceEventGeometry(th, "cpu")


def _assert_tables_equal(port, jax_geo):
    state = port.numpy_state()
    for key, val in state.items():
        want = np.asarray(getattr(jax_geo, key))
        assert np.asarray(val).dtype == want.dtype or np.isscalar(val), key
        assert np.array_equal(np.asarray(val), want), key
    return state


def _wires(jd, td, ref_ids, pos, n_units, R):
    want = [np.asarray(x) for x in jax.jit(jd.kernel_wire, static_argnames=("R",))(ref_ids, pos, n_units, R)]
    got = [x.numpy() for x in td.kernel_wire(ref_ids, pos, n_units, R)]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert np.array_equal(g, w)
    return got


def _random_rows(rng, n_cols, rate):
    s = np.where(rng.random(n_cols) < rate, ord("-"), ord("A")).astype(np.uint8)
    s[0] = ord("A")
    return s.tobytes()


@pytest.mark.parametrize("buckets", ["1", "0"])
@pytest.mark.parametrize("trial", range(6))
def test_tables_and_kernel_wire_match_jax_at_random_positions(monkeypatch, trial, buckets):
    monkeypatch.setenv("PANVC3_EVENT_BUCKETS", buckets)
    rng = np.random.default_rng(31 + trial)
    rows = [_random_rows(rng, 300, 0.02 + 0.05 * trial) for _ in range(3)]
    jh, jd, th, td = _geometries(rows, [rows[0]], [0, 0, 0], monkeypatch)
    _assert_tables_equal(td, jd)
    assert td.search_tab.device.type == "cpu" and td.search_tab.dtype == torch.int32
    B, R = 192, 32
    ref_ids = rng.integers(0, 3, B).astype(np.int32)
    nz = np.asarray([th.src_gv[r].n_zeros for r in ref_ids])
    pos = rng.integers(-5, nz + 6).astype(np.int32)
    n_units = rng.integers(0, R + 1, B).astype(np.int32)
    wire, overflow = _wires(jd, td, ref_ids, pos, n_units, R)
    if int(overflow):
        return
    # without overflow the wire is the host oracle's geometry
    dst_pos, gapbits, d_vals, d_pos, d_n, use_full, _ = th.batch(ref_ids, pos, n_units, R, 8)
    assert not use_full
    unpacked = rb.unpack_gap_wire(wire, R)
    for g, w in zip(unpacked, (dst_pos, d_n, gapbits, d_pos, d_vals)):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("trial", range(4))
def test_kernel_wire_equals_gap_wire(trial):
    """The device event wire equals the gap kernel's wire on the device gap
    index wherever no record overflows (the fast lane substitutes one for
    the other)."""
    rng = np.random.default_rng(17 + trial)
    rows = [_random_rows(rng, 600, 0.02 + 0.06 * trial) for _ in range(3)]
    _, _, th, td = _geometries(rows, [rows[0]], [0, 0, 0])
    index = DeviceGapIndex.build(th.src_gv, device="cpu")
    B, R = 128, 48
    ref_ids = rng.integers(0, 3, B).astype(np.int32)
    n_units = rng.integers(0, R + 1, B).astype(np.int32)
    pos = rng.integers(0, min(v.n_zeros for v in th.src_gv) - R - 2, B).astype(np.int32)
    ev_wire, ev_ov = td.kernel_wire(ref_ids, pos, n_units, R)
    gap_wire, gap_ov, _ = rb.rewrite_gap_kernel_wire(
        index, rb.pack_gap_wire_input(pos, n_units, ref_ids, np.zeros(B, np.int32)), R
    )
    if int(ev_ov) or int(gap_ov):
        assert trial >= 2, "unexpected overflow on a sparse trial"
        return
    assert torch.equal(ev_wire, gap_wire)


def test_kernel_wire_at_edge_positions(monkeypatch):
    """p < 0, p = nz-1, p >= nz, an all-gap source row, a gap run ending at
    rank nz-1, del_b == 0 and del_b == nz: against JAX and the host."""
    srcs = [b"AA--AAA-", b"-AAAA", b"AAAA", b"----"]
    dsts = [b"A-A-AA-A", b"AAAAA", b"AAAA", b"AAAA"]
    jh, jd, th, td = _geometries(srcs, dsts, [0, 1, 2, 3], monkeypatch)
    _assert_tables_equal(td, jd)
    rids, poss, nus = [], [], []
    for rid, gv in enumerate(th.src_gv):
        nz = gv.n_zeros
        for p in (-2, -1, 0, 1, max(nz - 2, 0), max(nz - 1, 0), nz, nz + 1, nz + 5):
            for nu in (0, 1, 2, 3):
                rids.append(rid)
                poss.append(p)
                nus.append(nu)
    ref_ids, pos, n_units = (np.asarray(a, np.int32) for a in (rids, poss, nus))
    for buckets in ("1", "0"):
        monkeypatch.setenv("PANVC3_EVENT_BUCKETS", buckets)
        wire, overflow = _wires(jd, td, ref_ids, pos, n_units, 16)
        assert int(overflow) == 0
        want = th.batch(ref_ids, pos, n_units, 16, 8)
        for g, w in zip(rb.unpack_gap_wire(wire, 16), (want[0], want[4], want[1], want[3], want[2])):
            assert np.array_equal(g, w)


def test_bucket_search_on_a_deep_table(monkeypatch):
    """A pair dense enough that the two-level bucket search engages gives
    the host oracle's geometry, as does the plain search."""
    rng = np.random.default_rng(23)
    n_cols = 400_000
    src_bits = (rng.random(n_cols) < 0.02).astype(np.uint8)
    dst_bits = (rng.random(n_cols) < 0.02).astype(np.uint8)
    src_bits[0] = dst_bits[0] = 0
    src = SequenceEntry("F", GapBitVector.from_state(**JaxGapBitVector.from_bits(src_bits).state()))
    dst = SequenceEntry("REF", GapBitVector.from_state(**JaxGapBitVector.from_bits(dst_bits).state()))
    host = eg.EventGeometry([src], [dst], [0])
    geo = eg.DeviceEventGeometry(host, "cpu")
    assert geo.bucket_steps + 2 < max(
        int(np.ceil(np.log2(geo.max_gap + 1))) + 1,
        int(np.ceil(np.log2(geo.max_del + 1))) + 1,
    )
    B, R = 256, 128
    ref_ids = np.zeros(B, np.int32)
    pos = rng.integers(0, src.gaps.n_zeros - 200, B).astype(np.int32)
    pos[:2] = [0, src.gaps.n_zeros - 130]
    n_units = rng.integers(0, 101, B).astype(np.int32)
    want = host.batch(ref_ids, pos, n_units, R, 8)
    for buckets in ("1", "0"):
        monkeypatch.setenv("PANVC3_EVENT_BUCKETS", buckets)
        got = [x.numpy() for x in geo.kernel(ref_ids, pos, n_units, R)]
        assert int(got[5]) == 0
        for g, w in zip(got[:5], want[:5]):
            assert np.array_equal(g, w)


def test_bucket_shift_override_and_state_round_trip(monkeypatch):
    monkeypatch.setenv("PANVC3_EVENT_BUCKET_SHIFT", "3")
    rng = np.random.default_rng(5)
    rows = [_random_rows(rng, 2000, 0.05) for _ in range(2)]
    _, jd, _, td = _geometries(rows, rows[:1], [0, 0], monkeypatch)
    assert td.BUCKET_SHIFT == 3
    _assert_tables_equal(td, jd)
    # the JAX object's tables carry across
    state = {k: np.asarray(getattr(jd, k)) if not np.isscalar(v) else getattr(jd, k)
             for k, v in td.numpy_state().items()}
    td2 = eg.DeviceEventGeometry.from_numpy_state(state, "cpu")
    B, R = 64, 64
    ref_ids = rng.integers(0, 2, B).astype(np.int32)
    pos = rng.integers(-3, 1900, B).astype(np.int32)
    n_units = rng.integers(0, R + 1, B).astype(np.int32)
    _wires(jd, td2, ref_ids, pos, n_units, R)


def _mixed_sam(founder_seqs):  # noqa: F811
    """100 bp reads with I+D runs, then 300 bp ones: a batch holding one of
    the latter has R > 255, which overflows the device geometry."""
    short = _synthesise_indel_sam(founder_seqs, n_reads=64, seed=5)
    long_ = _synthesise_indel_sam(founder_seqs, n_reads=8, read_len=300, seed=6)
    body = [ln.replace(b"read", b"long", 1) for ln in long_.split(b"\n") if ln and not ln.startswith(b"@")]
    return short + b"\n".join(body) + b"\n"


@pytest.fixture(scope="module")
def mixed_case(msa_files, founder_seqs, tmp_path_factory):  # noqa: F811
    index_path, _, _ = msa_files
    sam = _mixed_sam(founder_seqs)
    return index_path, sam, _jax_host(sam, index_path, GENOME, tmp_path_factory.mktemp("jax"))


def _fast_lane_case(case, tmp_path, monkeypatch, mode, **kw):
    """The fast lane in process under PANVC3_EVENT_GEOMETRY=mode; asserts
    equality with panvc3_tpu and returns the AGG_DIAG delta."""
    from panvc3_tpu_torch.pipeline import fastlane

    index_path, sam, (want, want_ranges) = case
    monkeypatch.setenv("PANVC3_EVENT_GEOMETRY", mode)
    monkeypatch.setenv("PANVC3_HOST_DP", "0")
    before = dict(fastlane.AGG_DIAG)
    got, got_ranges, stats = _port_inprocess(sam, index_path, tmp_path, **kw)
    assert stats.matched_reads == 72 and stats.realigned_range_count > 0
    assert _strip_pg(got) == _strip_pg(want)
    assert got_ranges == want_ranges
    return {k: fastlane.AGG_DIAG[k] - before[k] for k in before}


@pytest.mark.parametrize("mode", ["device", "0"])
@pytest.mark.parametrize("threaded", [True, False])
def test_device_geometry_fast_lane_matches_jax(mixed_case, tmp_path, monkeypatch, mode, threaded):
    """=device falls back to the host event path for the batches that
    overflow; =0 fetches their full deletion runs."""
    delta = _fast_lane_case(mixed_case, tmp_path, monkeypatch, mode, threaded_pipeline=threaded)
    assert delta["geometry_overflow"] > 0


def test_device_geometry_chaos_matches_jax(mixed_case, tmp_path, monkeypatch):
    monkeypatch.setenv("PANVC3_FASTLANE_CHAOS", "7")
    _fast_lane_case(mixed_case, tmp_path, monkeypatch, "device")


@pytest.mark.parametrize("mode", ["device", "0"])
def test_cli_device_geometry_matches_jax(msa_files, founder_seqs, tmp_path, monkeypatch, mode):  # noqa: F811
    """``python -m panvc3_tpu_torch project_alignments --device cpu`` with
    PANVC3_EVENT_GEOMETRY=device and =0."""
    from .test_fastpath import _rich_sam

    index_path, _, _ = msa_files
    sam = _rich_sam(founder_seqs)
    want, want_ranges = _jax_host(sam, index_path, GENOME, tmp_path)
    monkeypatch.setenv("PANVC3_EVENT_GEOMETRY", mode)
    got, got_ranges, diag, err = _port_cli(sam, index_path, GENOME, tmp_path)
    assert _strip_pg(got) == _strip_pg(want)
    assert got_ranges == want_ranges
    assert diag["device"] == "cpu" and diag["dispatches"] > 0
    assert "rewrite_fetch" in err and "event_geometry" not in err
