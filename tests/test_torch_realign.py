"""The port's realignment DP and wires against panvc3_tpu's, byte for byte.

Inputs are made from a seed with numpy and handed to both packages.  The
tolerance is zero: every DP score is a small integer, exact in f32, so
ops, counts and wire rows must be identical.  The JAX side runs on the
CPU: the fused Pallas kernel in interpret mode and the XLA scans.  The
CUDA kernel itself only runs on a card (``tests/test_torch_cuda.py``).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panvc3_tpu.alphabet import DNA5_NORMALISE
from panvc3_tpu.alphabet import dna5_normalise_device as jax_dna5
from panvc3_tpu.cigar import CODE_TO_OP, format_cigar
from panvc3_tpu.ops import realign_batch as jrb
from panvc3_tpu.ops.realign_pallas_fused import realign_fused_pallas
from panvc3_tpu_torch.alphabet import dna5_normalise_device
from panvc3_tpu_torch.ops import realign_batch as trb
from panvc3_tpu_torch.ops.realign_pallas_fused import realign_fused

from .conftest import DATA_DIR


def _runs(rng, B, Q, R, alphabet=b"ACGT"):
    """Random runs with lengths 0 and full in the first rows."""
    letters = np.frombuffer(alphabet, np.uint8)
    ref = rng.choice(letters, (B, R)).astype(np.uint8)
    qry = rng.choice(letters, (B, Q)).astype(np.uint8)
    n = rng.integers(0, R + 1, B).astype(np.int32)
    m = rng.integers(0, Q + 1, B).astype(np.int32)
    n[:3] = [0, R, R]
    m[:3] = [Q, 0, Q]
    return ref, qry, m, n


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("B,Q,R", [(300, 16, 16), (64, 8, 16), (40, 24, 48)])
def test_plain_dp_matches_pallas_and_xla_scans(B, Q, R):
    rng = np.random.default_rng(B * 1000 + Q * 10 + R)
    ref, qry, m, n = _runs(rng, B, Q, R)
    go, ge = -6.0, -1.0
    ops, cnt = realign_fused(_t(ref), _t(qry), _t(m), _t(n), go, ge, R, Q)
    ops, cnt = ops.numpy(), cnt.numpy()

    p_ops, p_cnt = realign_fused_pallas(
        None, jnp.asarray(ref), jnp.asarray(qry), jnp.asarray(m),
        jnp.asarray(n), jnp.float32(go), jnp.float32(ge), R, Q,
        interpret=True,
    )
    assert np.array_equal(ops, np.asarray(p_ops))
    assert np.array_equal(cnt, np.asarray(p_cnt))

    sub = jrb._substitution_scores(
        jnp.asarray(ref), jnp.asarray(qry), None, None, False
    )
    trace = jrb._fill_batch(
        sub, jnp.asarray(m), jnp.asarray(n), jnp.float32(go), jnp.float32(ge), R, Q
    )
    x_ops, x_cnt = jrb._traceback_batch(
        trace, jnp.asarray(ref), jnp.asarray(qry), jnp.asarray(m), jnp.asarray(n), R, Q
    )
    assert np.array_equal(ops, np.asarray(x_ops))
    assert np.array_equal(cnt, np.asarray(x_cnt))


def test_unwired_dispatch_matches_xla_scans():
    """realign_device_kernel at a pad the wires never take (R+Q >= 256)."""
    rng = np.random.default_rng(7)
    B, Q, R = 24, 128, 136
    ref, qry, m, n = _runs(rng, B, Q, R)
    ops, cnt = trb.realign_device_kernel(
        _t(ref), _t(qry), _t(n), _t(m), -6.0, -1.0, None, None, False, R, Q
    )
    sub = jrb._substitution_scores(jnp.asarray(ref), jnp.asarray(qry), None, None, False)
    trace = jrb._fill_batch(
        sub, jnp.asarray(m), jnp.asarray(n), jnp.float32(-6), jnp.float32(-1), R, Q
    )
    x_ops, x_cnt = jrb._traceback_batch(
        trace, jnp.asarray(ref), jnp.asarray(qry), jnp.asarray(m), jnp.asarray(n), R, Q
    )
    assert np.array_equal(ops.numpy(), np.asarray(x_ops))
    assert np.array_equal(cnt.numpy(), np.asarray(x_cnt))


def _flat_reference(rng, size):
    # raw FASTA bytes: upper and lower case, N, U and other bytes, so the
    # device-side dna5 normalisation is exercised
    alphabet = np.frombuffer(b"ACGTACGTACGTacgtNnUuRY", np.uint8)
    return rng.choice(alphabet, size).astype(np.uint8)


@pytest.mark.parametrize("wire", ["classic", "refgather", "refgather2"])
def test_wire_rows_match_jax(wire, monkeypatch):
    monkeypatch.setenv("PANVC3_PALLAS_FUSED", "0")
    rng = np.random.default_rng({"classic": 1, "refgather": 2, "refgather2": 3}[wire])
    S, R, Q = 200, 24, 24
    go, ge = np.float32(-6), np.float32(-1)
    rl = rng.integers(0, R + 1, S).astype(np.int32)
    ql = rng.integers(0, Q + 1, S).astype(np.int32)
    rl[:2] = [0, R]
    ql[:2] = [Q, 0]
    lane_q = np.arange(Q)[None, :] < ql[:, None]
    query_alpha = b"ACGT" if wire == "refgather2" else b"ACGTNacgRY"
    qry = rng.choice(np.frombuffer(query_alpha, np.uint8), (S, Q)).astype(np.uint8)
    qry = np.where(lane_q, qry, 0).astype(np.uint8)
    if wire == "classic":
        ref = np.where(
            np.arange(R)[None, :] < rl[:, None],
            rng.choice(np.frombuffer(b"ACGTN", np.uint8), (S, R)), 0,
        ).astype(np.uint8)
        packed = jrb.pack_realign_wire_input(ref, qry, rl, ql)
        want = jrb.realign_device_kernel_wire(packed, go, ge, R, Q)
        got = trb._realign_wire(_t(packed), go, ge, R, Q)
    else:
        flat = _flat_reference(rng, 5000)
        start = rng.integers(0, 5000 - R, S).astype(np.int64)
        start[2] = 5000 - 3  # a row running off the end is clamped
        if wire == "refgather":
            packed = jrb.pack_realign_refgather_input(qry, start, rl, ql)
            want = jrb.realign_device_kernel_wire_refgather(
                packed, jnp.asarray(flat), go, ge, R, Q
            )
            got = trb._realign_wire_refgather(_t(packed), _t(flat), go, ge, R, Q)
        else:
            assert jrb.query_wire2_eligible(qry, ql)
            packed = jrb.pack_realign_refgather2_input(qry, start, rl, ql)
            want = jrb.realign_device_kernel_wire_refgather2(
                packed, jnp.asarray(flat), go, ge, R, Q
            )
            got = trb._realign_wire_refgather2(_t(packed), _t(flat), go, ge, R, Q)
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_host_helpers_and_tables_match():
    rng = np.random.default_rng(5)
    for name in ("QUERY_CODE", "QUERY_DECODE", "QUERY_CODE2", "_TB_OPS", "_ACGT"):
        assert np.array_equal(np.asarray(getattr(trb, name)), np.asarray(getattr(jrb, name))), name
    S, R, Q = 64, 16, 24
    ref = rng.integers(0, 256, (S, R)).astype(np.uint8)
    qry = rng.choice(np.frombuffer(b"ACGTN\x00x", np.uint8), (S, Q)).astype(np.uint8)
    rl = rng.integers(0, R + 1, S).astype(np.int32)
    ql = rng.integers(0, Q + 1, S).astype(np.int32)
    start = rng.integers(0, 1 << 31, S).astype(np.int64)
    for fn in ("pack_realign_refgather_input", "pack_realign_refgather2_input"):
        assert np.array_equal(
            getattr(trb, fn)(qry, start, rl, ql), getattr(jrb, fn)(qry, start, rl, ql)
        ), fn
    assert np.array_equal(
        trb.pack_realign_wire_input(ref, qry, rl, ql),
        jrb.pack_realign_wire_input(ref, qry, rl, ql),
    )
    wire = rng.integers(0, 256, (S, (R + Q) // 2 + 1)).astype(np.uint8)
    for a, b in zip(trb.unpack_realign_wire(wire, R + Q), jrb.unpack_realign_wire(wire, R + Q)):
        assert np.array_equal(a, b)
    wire = rng.integers(0, 256, (S, (R + Q) // 4 + 1)).astype(np.uint8)
    for a, b in zip(
        trb.unpack_realign_refgather_wire(wire, R + Q),
        jrb.unpack_realign_refgather_wire(wire, R + Q),
    ):
        assert np.array_equal(a, b)
    acgt = rng.choice(np.frombuffer(b"ACGT", np.uint8), (S, Q)).astype(np.uint8)
    acgt = np.where(np.arange(Q)[None, :] < ql[:, None], acgt, 0).astype(np.uint8)
    for q in (qry, acgt, acgt[:, :Q - 1]):
        assert trb.query_wire2_eligible(q, ql) == jrb.query_wire2_eligible(q, ql)
    assert trb.query_wire2_eligible(acgt, ql)


def test_dna5_normalise_all_byte_values():
    x = np.arange(256, dtype=np.uint8)
    got = dna5_normalise_device(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, DNA5_NORMALISE[x])
    assert np.array_equal(got, np.asarray(jax_dna5(jnp.asarray(x))))


def _load_integer_fixtures():
    rows = []
    for line in (DATA_DIR / "tiebreak_fixtures.tsv").read_text().splitlines():
        if not line or line.startswith("#"):
            continue
        kind, go, ge, s1, s2, quals, _score, cigar = line.split("\t")
        if quals == "-":
            rows.append((kind, int(go), int(ge), s1, s2, cigar))
    return rows


def _cigar(ops_row, k):
    out = []
    for code in ops_row[:k][::-1].tolist():
        ch = CODE_TO_OP[int(code)]
        if out and out[-1][1] == ch:
            out[-1] = (out[-1][0] + 1, ch)
        else:
            out.append((1, ch))
    return out


def test_tiebreak_fixtures_integer_cases():
    """Every integer case of the locked tie-break table reproduces its
    CIGAR through the port's DP."""
    rows = _load_integer_fixtures()
    assert len(rows) > 3000
    groups: dict[tuple[int, int], list] = {}
    for row in rows:
        groups.setdefault((row[1], row[2]), []).append(row)
    for (go, ge), grp in groups.items():
        R = max(len(r[3]) for r in grp)
        Q = max(len(r[4]) for r in grp)
        B = len(grp)
        ref = np.zeros((B, R), np.uint8)
        qry = np.zeros((B, Q), np.uint8)
        n = np.zeros(B, np.int32)
        m = np.zeros(B, np.int32)
        for b, r in enumerate(grp):
            ref[b, :len(r[3])] = np.frombuffer(r[3].encode(), np.uint8)
            qry[b, :len(r[4])] = np.frombuffer(r[4].encode(), np.uint8)
            n[b] = len(r[3])
            m[b] = len(r[4])
        ops, cnt = realign_fused(_t(ref), _t(qry), _t(m), _t(n), go, ge, R, Q)
        ops, cnt = ops.numpy(), cnt.numpy()
        for b, r in enumerate(grp):
            assert format_cigar(_cigar(ops[b], int(cnt[b]))) == r[5], (
                f"{r[0]} {r[3]} {r[4]} go={go} ge={ge}"
            )


def test_realign_fused_rejects_what_it_does_not_take():
    ref = torch.zeros((4, 8), dtype=torch.uint8)
    q = torch.zeros((4, 8), dtype=torch.uint8)
    m = torch.zeros(4, dtype=torch.int32)
    sub = torch.zeros((4, 8, 8))
    rows = torch.zeros(64)
    qual = (m[:, None].expand(4, 8).contiguous(), rows, rows)
    with pytest.raises(ValueError, match="mutually exclusive"):
        realign_fused(ref, q, m, m, 0, -1, 8, 8, sub=sub, qual=qual)
    with pytest.raises(ValueError, match="sub must be"):
        realign_fused(ref, q, m, m, 0, -1, 8, 8, sub=sub.double())
    with pytest.raises(ValueError, match="qq must be"):
        realign_fused(ref, q, m, m, 0, -1, 8, 8, qual=(q, rows, rows))
    with pytest.raises(ValueError, match="int32"):
        realign_fused(ref, q, m.long(), m, 0, -1, 8, 8)
    with pytest.raises(ValueError, match="shape"):
        realign_fused(ref, q, m, m, 0, -1, 8, 9)
    with pytest.raises(ValueError, match="contiguous"):
        realign_fused(ref, q.t().contiguous().t(), m, m, 0, -1, 8, 8)


def _toy_entries():
    from panvc3_tpu.msa_index import make_sequence_entry_pair

    src, dst = make_sequence_entry_pair("AC-GTTA-CA", "ACGGT-AACA")
    src2, _ = make_sequence_entry_pair("A--GTTACCA", "ACGGT-AACA")
    # two inputs share one gap vector object: dev ids deduplicate by identity
    return [src, src2, src], [dst], [0, 0, 0]


def test_batch_projector_state_matches_jax():
    from panvc3_tpu.ops.engine import BatchProjector as JaxProjector
    from panvc3_tpu_torch.ops.engine import BatchProjector

    src, dst, mapping = _toy_entries()
    jp = JaxProjector(src, dst, mapping, -6, -1)
    tp = BatchProjector(src, dst, mapping, -6, -1, device="cpu")
    refs = {0: b"ACGGTAACA", 3: b"TTTT"}
    jp._ensure_refs(refs)
    tp._ensure_refs(refs)
    jax_state = {
        "gap_opening_cost": jp.gap_opening_cost,
        "gap_extension_cost": jp.gap_extension_cost,
        "ref_id_mapping": list(jp.ref_id_mapping),
        "src_dev_ids": jp.src_dev_ids,
        "dst_dev_ids": jp.dst_dev_ids,
        "ref_flat_host": jp._ref_flat_host,
        "ref_off": jp._ref_off,
    }
    for state in (tp.numpy_state(), BatchProjector.from_numpy_state(jax_state, "cpu").numpy_state()):
        assert state.keys() == jax_state.keys()
        for key, val in jax_state.items():
            if isinstance(val, np.ndarray):
                assert np.array_equal(state[key], val), key
            else:
                assert state[key] == val, key
    assert tp.src_dev_ids == [0, 1, 0]
    flat, offmap = tp.ref_flat_snapshot()
    assert flat.dtype == torch.uint8 and flat.device.type == "cpu"
    assert bytes(flat.numpy()) == bytes(np.asarray(jp.ref_flat_dev))
    assert offmap == jp._ref_off
    fresh = BatchProjector.from_numpy_state(jax_state, "cpu")
    assert fresh.ref_flat_snapshot(max_h2d_bytes=4) is None
    # the device gap index, array by array, and carried across in the state
    jax_index = {k: np.asarray(v) for k, v in zip(
        ("words", "brank", "seq_word_off", "seq_brank_off", "seq_nwords", "seq_nzeros",
         "zsel", "seq_zsel_off", "rtab", "seq_rtab_off"),
        jp.index.tree_flatten()[0],
    )}
    jax_index["search_steps"] = jp.index.search_steps
    fresh = BatchProjector.from_numpy_state({**jax_state, "index": jax_index}, "cpu")
    for index in (tp.index, fresh.index):
        assert index.device.type == "cpu"
        got = index.numpy_state()
        assert got.keys() == jax_index.keys()
        for key, val in jax_index.items():
            assert np.array_equal(got[key], val) and np.asarray(got[key]).dtype == np.asarray(val).dtype, key
    assert tp.index is tp.index
