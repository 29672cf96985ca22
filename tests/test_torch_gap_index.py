"""The port's device gap index, rewrite math and gap kernel against
panvc3_tpu, array by array.

The same seeded numpy inputs go through ``panvc3_tpu.ops.rank_select`` /
``rewrite_batch`` (XLA on the CPU) and their counterparts in the port
(plain PyTorch on the CPU).  Positions, ranks and sequence ids run past
every end, where XLA clamps its gathers and drops its scatters: the port
must read and drop the same elements.  Every output must be equal in
value and dtype, including the gap kernel's overflow causes (R > 255, a
deletion run >= 255, more than 8 deletions in a record) and the fast
lane's ``PANVC3_EVENT_GEOMETRY=0`` route through the CLI.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import panvc3_tpu.ops.rank_select as jax_rs
from panvc3_tpu.alphabet import normalise_dna5
from panvc3_tpu.bitvec import GapBitVector as JaxGapBitVector
from panvc3_tpu.msa_index import make_sequence_entry_pair
from panvc3_tpu.ops import rewrite_batch as jax_rb
from panvc3_tpu_torch.bitvec import GapBitVector
from panvc3_tpu_torch.ops import rank_select
from panvc3_tpu_torch.ops import rewrite_batch as rb
from panvc3_tpu_torch.ops.rank_select import DeviceGapIndex

from .test_device_ops import random_alignment, random_msa_pair
from .test_torch_device_event import _fast_lane_case, mixed_case  # noqa: F401 (fixture)
from .test_workflow_data import founder_seqs, msa_files  # noqa: F401 (fixtures)

TABLES = {
    "both": (None, None), "no-select": (False, None),
    "no-rank": (None, False), "neither": (False, False),
}


def _port_vectors(vectors):
    return [GapBitVector.from_state(**v.state()) for v in vectors]


def _pair(vectors, tables):
    return (
        jax_rs.DeviceGapIndex.build(vectors, *tables),
        DeviceGapIndex.build(_port_vectors(vectors), *tables, device="cpu"),
    )


def _jax_state(idx) -> dict:
    state = {k: None if getattr(idx, k) is None else np.asarray(getattr(idx, k))
             for k in DeviceGapIndex.FIELDS}
    state["search_steps"] = idx.search_steps
    return state


def _assert_state_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for key, val in want.items():
        if isinstance(val, np.ndarray):
            assert got[key].dtype == val.dtype, key
            assert np.array_equal(got[key], val), key
        else:
            assert got[key] == val, key


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _check_queries(j, t, rng, n_seq, max_pos, max_k, B=2048):
    """Every query at in-range and out-of-range sequence ids, positions and
    ranks."""
    seq = rng.integers(-2, n_seq + 2, B).astype(np.int32)
    seq[:n_seq] = np.arange(n_seq)
    pos = rng.integers(-40, max_pos + 40, B).astype(np.int32)
    k = rng.integers(-5, max_k + 40, B).astype(np.int32)
    for name, arg in (("rank0", pos), ("bit", pos), ("select0", k)):
        want = np.asarray(getattr(j, name)(jnp.asarray(seq), jnp.asarray(arg)))
        got = getattr(t, name)(_t(seq), _t(arg)).numpy()
        assert got.dtype == np.int32, name
        assert np.array_equal(got, want), name
    want = j.rank0_and_bit(jnp.asarray(seq), jnp.asarray(pos))
    got = t.rank0_and_bit(_t(seq), _t(pos))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    for R in (16, DeviceGapIndex.SELECT_SLICE_PAD + 8):
        want = np.asarray(j.select0_consecutive(jnp.asarray(seq[:64]), jnp.asarray(k[:64]), R))
        got = t.select0_consecutive(_t(seq[:64]), _t(k[:64]), R).numpy()
        assert np.array_equal(got, want), R


@pytest.mark.parametrize("tables", list(TABLES), ids=list(TABLES))
def test_index_arrays_and_queries_match_jax(tables):
    rng = np.random.default_rng(0)
    vectors = [
        JaxGapBitVector.from_bits((rng.random(n) < 0.3).astype(np.uint8))
        for n in (33, 64, 500, 4097)
    ]
    j, t = _pair(vectors, TABLES[tables])
    _assert_state_equal(t.numpy_state(), _jax_state(j))
    assert (t.zsel is None) == (tables in ("no-select", "neither"))
    assert (t.rtab is None) == (tables in ("no-rank", "neither"))
    _check_queries(j, t, rng, len(vectors), 4097, 3000)
    # the JAX index's arrays carry across
    t2 = DeviceGapIndex.from_numpy_state(_jax_state(j), "cpu")
    _assert_state_equal(t2.numpy_state(), _jax_state(j))
    _check_queries(j, t2, rng, len(vectors), 4097, 3000, B=256)


def test_table_budget_policy_matches_jax(monkeypatch):
    """The tables are decided as the JAX index decides them on the CPU, and
    a budget too small for either drops both, on a 4 Mbp-column vector."""
    assert rank_select._table_budget_bytes(torch.device("cpu")) == jax_rs._table_budget_bytes()
    rng = np.random.default_rng(11)
    bits = (rng.random(4_000_000) < 0.3).astype(np.uint8)
    gv = JaxGapBitVector.from_bits(bits)
    for budget in (1024, 16 * 2**20 + 1, 1 << 40):
        monkeypatch.setattr(jax_rs, "_table_budget_bytes", lambda: budget)
        monkeypatch.setattr(rank_select, "_table_budget_bytes", lambda device: budget)
        j, t = _pair([gv], (None, None))
        _assert_state_equal(t.numpy_state(), _jax_state(j))
        if budget == 1024:
            assert t.zsel is None and t.rtab is None
        if budget == 1 << 40:
            assert t.zsel is not None and t.rtab is not None
        ks = rng.integers(1, gv.n_zeros + 1, 4096).astype(np.int32)
        pos = rng.integers(0, len(bits), 4096).astype(np.int32)
        seq = np.zeros(4096, np.int32)
        assert np.array_equal(t.select0(_t(seq), _t(ks)).numpy(), gv.select0(ks))
        assert np.array_equal(t.rank0(_t(seq), _t(pos)).numpy(), gv.rank0(pos))


def test_popcount32_matches_numpy():
    rng = np.random.default_rng(4)
    x = rng.integers(0, 1 << 32, 10_000, dtype=np.uint64)
    x[:4] = [0, 0xFFFFFFFF, 0x80000000, 1]
    want = np.array([bin(int(v)).count("1") for v in x])
    assert np.array_equal(rank_select.popcount32(_t(x.astype(np.int64))).numpy(), want)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_rewrite_batch_matches_jax(seed):
    """expand_cigars, rewrite_math (plain and wire-packed) and the host
    finalize, on random MSAs and alignments (S/H/P/N/I/D ops included)."""
    rng = np.random.default_rng(seed)
    pairs = [random_msa_pair(rng, int(rng.integers(20, 120))) for _ in range(6)]
    entries, vectors, dst_seqs = [], [], []
    for src, dst in pairs:
        se, de = make_sequence_entry_pair(src, dst)
        entries.append(se)
        vectors += [se.gaps, de.gaps]
        dst_seqs.append(dst.replace("-", "").encode())
    tables = [(None, None), (False, False), (True, False)][seed - 1]
    j, t = _pair(vectors, tables)
    ref_flat = np.frombuffer(b"".join(dst_seqs), dtype=np.uint8)
    ref_offs = np.cumsum([0] + [len(s) for s in dst_seqs[:-1]]).tolist()
    args = [[], [], [], [], [], []]
    for _ in range(40):
        pi = int(rng.integers(0, len(pairs)))
        if entries[pi].gaps.n_zeros < 12:
            continue
        src_pos, cigar, query = random_alignment(rng, entries[pi].gaps.n_zeros)
        for lst, val in zip(args, (cigar, src_pos, normalise_dna5(query), 2 * pi, 2 * pi + 1, ref_offs[pi])):
            lst.append(val)
    jb = jax_rb.expand_cigars(*args)
    tb = rb.expand_cigars(*args)
    for f in jb.__dataclass_fields__:
        assert np.array_equal(getattr(tb, f), getattr(jb, f)), f
    assert rb.rewrite_batch(t, ref_flat, tb) == jax_rb.rewrite_batch(j, ref_flat, jb)
    kin = (jb.src_seq, jb.dst_seq, jb.rec_src_pos, jb.ref_off, jb.ops, jb.counts)
    want = jax_rb.rewrite_device_kernel(j, ref_flat, *kin, jb.query, jb.pad_ref_units)
    got = rb.rewrite_device_kernel(t, ref_flat, *kin, tb.query, tb.pad_ref_units)
    for g, w in zip(got, want):
        assert g.numpy().dtype == np.asarray(w).dtype
        assert np.array_equal(g.numpy(), np.asarray(w))
    # wire-packed: even R and Lq; R past 255 and rows past 8 deletions
    # overflow into the full runs
    b, lq = jb.query.shape
    lq += lq % 2
    query = np.zeros((b, lq), np.uint8)
    query[:, :jb.query.shape[1]] = jb.query
    for R in (jb.pad_ref_units + jb.pad_ref_units % 2, 256):
        want = jax_rb.rewrite_device_kernel_packed(
            j, ref_flat, *kin, jax_rb.pack_query(query), R, lq
        )
        got = rb.rewrite_device_kernel_packed(t, ref_flat, *kin, rb.pack_query(query), R, lq)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))
        for g, w in zip(rb.fetch_rewrite_outputs(got, R), jax_rb.fetch_rewrite_outputs(want, R)):
            assert np.array_equal(g, w)


def _gap_vectors(rng, cause):
    """Source rows built so that records overflow the packed gap outputs
    by ``cause``; the destination row is gap-free."""
    n = 900
    src = np.full(n, ord("A"), np.uint8)
    if cause == "long-deletion":
        src[300:600] = ord("-")          # one 300-base deletion run
    elif cause == "many-deletions":
        src[200:500:3] = ord("-")        # a deletion every third column
    else:
        src[rng.random(n) < 0.02] = ord("-")
        src[0] = ord("A")
    dst = np.full(n, ord("C"), np.uint8)
    dst[rng.random(n) < 0.02] = ord("-")
    return [JaxGapBitVector.from_gap_string(r.tobytes()) for r in (src, dst, src)]


@pytest.mark.parametrize("tables", ["both", "neither"])
@pytest.mark.parametrize(
    "cause", ["none", "R>255", "long-deletion", "many-deletions"]
)
def test_gap_kernel_and_wire_match_jax(tables, cause):
    rng = np.random.default_rng(len(cause))
    vectors = _gap_vectors(rng, cause)
    j, t = _pair(vectors, TABLES[tables])
    R = 256 if cause == "R>255" else 64
    B = 96
    src = rng.integers(0, 3, B).astype(np.int32)
    src[src == 1] = 0
    dst = np.ones(B, np.int32)
    n_units = rng.integers(0, min(R, 255) + 1, B).astype(np.int32)
    pos = rng.integers(-3, 520, B).astype(np.int32)
    pos[:8] = [150, 160, 180, 250, 280, 290, 0, -1]
    n_units[:6] = min(R, 255)
    want = [np.asarray(x) for x in jax_rb.rewrite_gap_kernel_packed(j, src, dst, pos, n_units, R)]
    got = [x.numpy() for x in rb.rewrite_gap_kernel_packed(t, src, dst, pos, n_units, R)]
    for name, g, w in zip(("initial", "gapbits", "d_vals", "d_pos", "d_n8", "overflow", "d_run"), got, want):
        assert g.dtype == w.dtype, name
        assert np.array_equal(g, w), name
    assert (int(got[5]) > 0) == (cause != "none")
    if cause == "long-deletion":
        assert int(got[6].max()) >= 255
    if cause == "many-deletions":
        assert int(got[4].max()) > rb.D_SPARSE_SLOTS
    for g, w in zip(rb.fetch_gap_outputs(got, R), jax_rb.fetch_gap_outputs(want, R)):
        assert np.array_equal(g, w)
    packed = rb.pack_gap_wire_input(pos, n_units, src, dst)
    assert np.array_equal(packed, jax_rb.pack_gap_wire_input(pos, n_units, src, dst))
    want_w = [np.asarray(x) for x in jax_rb.rewrite_gap_kernel_wire(j, packed, R)]
    got_w = [x.numpy() for x in rb.rewrite_gap_kernel_wire(t, packed, R)]
    for g, w in zip(got_w, want_w):
        assert np.array_equal(g, w)
    for g, w in zip(rb.unpack_gap_wire(got_w[0], R), jax_rb.unpack_gap_wire(want_w[0], R)):
        assert np.array_equal(g, w)


def test_reconstruct_main_code_matches_jax():
    rng = np.random.default_rng(9)
    pairs = [random_msa_pair(rng, 150) for _ in range(2)]
    entries, vectors, dst_seqs = [], [], []
    for src, dst in pairs:
        se, de = make_sequence_entry_pair(src, dst)
        entries.append(se)
        vectors += [se.gaps, de.gaps]
        dst_seqs.append(dst.replace("-", "").encode())
    _, t = _pair(vectors, (None, None))
    ref_flat = np.frombuffer(b"".join(dst_seqs), dtype=np.uint8)
    args = [[], [], [], [], [], []]
    for _ in range(30):
        pi = int(rng.integers(0, 2))
        src_pos, cigar, query = random_alignment(rng, entries[pi].gaps.n_zeros)
        for lst, val in zip(args, (cigar, src_pos, normalise_dna5(query), 2 * pi, 2 * pi + 1, [0, len(dst_seqs[0])][pi])):
            lst.append(val)
    b = rb.expand_cigars(*args)
    R = max(8, b.pad_ref_units + (-b.pad_ref_units) % 8)
    out = rb.rewrite_gap_kernel_packed(t, b.src_seq, b.dst_seq, b.rec_src_pos, b.n_ref_units, R)
    dst_pos, d_run, isgap = rb.fetch_gap_outputs(out, R)
    ref_len = np.asarray([len(dst_seqs[s // 2]) for s in b.src_seq], np.int64)
    common = (b.unit_op, b.unit_count, b.unit_rec, len(b.src_seq), R, dst_pos, d_run,
              isgap, b.query, ref_flat, b.ref_off, ref_len)
    got = rb.reconstruct_main_code(*common)
    assert np.array_equal(got, jax_rb.reconstruct_main_code(*common))
    # the host reconstruction equals the device comparison on the valid region
    full = rb.rewrite_device_kernel(
        t, ref_flat, b.src_seq, b.dst_seq, b.rec_src_pos, b.ref_off, b.ops, b.counts, b.query, R
    )[2].numpy()
    valid = np.arange(R)[None, :] < b.n_ref_units[:, None]
    assert np.array_equal(got[valid], full[valid])


def test_drop_index_wraps_once_then_drops():
    idx = torch.tensor([-9, -5, -4, -1, 0, 3, 4, 7])
    assert rb._drop_index(idx, 4).tolist() == [4, 4, 0, 3, 0, 3, 4, 4]
    table = torch.arange(10) * 10
    assert rank_select.take(table, torch.tensor([-1, -5, -11, -30, 3, 9, 10, 25])).tolist() == [
        90, 50, 0, 0, 30, 90, 90, 90,
    ]
    assert rank_select.clamped(table, torch.tensor([-1, 12])).tolist() == [0, 90]


def test_gap_kernel_fast_lane_matches_jax(mixed_case, tmp_path, monkeypatch):
    """PANVC3_EVENT_GEOMETRY=0 in process, one batch at a time on the
    serial drain: the gap kernel's wire carries the geometry of every
    batch; the batches with reads longer than 255 reference bases overflow
    it, and the fast lane fetches their full deletion runs."""
    delta = _fast_lane_case(
        mixed_case, tmp_path, monkeypatch, "0", pipeline_depth=1, threaded_pipeline=False
    )
    assert delta["geometry_overflow"] > 0
