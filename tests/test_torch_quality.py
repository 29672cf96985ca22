"""Quality-scored realignment (``-q``) and the split route on the port,
against panvc3_tpu, byte for byte.

Inputs are made from a seed with numpy and handed to both packages.  The
tolerance is zero: every score is an integer exact in f32 (Malde scores in
1/``MALDE_SCALE`` units, gap costs scaled to match), so ops, counts, trace
bytes, wire rows and tool output must be identical.  The JAX side runs on
the CPU: its Pallas kernels in interpret mode and its XLA scans.  The CUDA
kernels themselves only run on a card (``tests/test_torch_cuda.py``); here
the wrappers take their plain versions, and a spy on the port's dispatch
shows which kernel entry each path would launch.
"""

from __future__ import annotations

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import K2_EDGE_SHAPES, k2_edge_lengths
from panvc3_tpu.align import MALDE_SCALE, malde_tables
from panvc3_tpu.alphabet import PHRED42_MAX
from panvc3_tpu.cigar import format_cigar
from panvc3_tpu.ops import realign_batch as jrb
from panvc3_tpu.ops.realign_pallas import fill_batch_pallas
from panvc3_tpu.ops.realign_pallas_fused import realign_fused_pallas
from panvc3_tpu_torch.ops import realign_batch as trb
from panvc3_tpu_torch.ops.realign_pallas import fill_batch
from panvc3_tpu_torch.ops.realign_pallas_fused import realign_fused

from .conftest import DATA_DIR
from .test_fastpath import _rich_sam
from .test_projector_adversarial import ROWS, _build_inputs
from .test_torch_fastlane import (
    GENOME,
    _jax_host,
    _long_run_sam,
    _port_cli,
    _port_inprocess,
    _strip_pg,
)
from .test_workflow_data import founder_seqs, msa_files  # noqa: F401 (fixtures)

MT, XT = malde_tables()
MROW = MT[PHRED42_MAX].astype(np.float32)
XROW = XT[PHRED42_MAX].astype(np.float32)
KGO, KGE = np.float32(-6 * MALDE_SCALE), np.float32(-1 * MALDE_SCALE)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _runs(rng, B, Q, R):
    """Random runs with lengths 0 and full in the first rows."""
    letters = np.frombuffer(b"ACGT", np.uint8)
    ref = rng.choice(letters, (B, R)).astype(np.uint8)
    qry = rng.choice(letters, (B, Q)).astype(np.uint8)
    n = rng.integers(0, R + 1, B).astype(np.int32)
    m = rng.integers(0, Q + 1, B).astype(np.int32)
    k = min(B, 3)
    n[:k] = [0, R, R][:k]
    m[:k] = [Q, 0, Q][:k]
    return ref, qry, m, n


def _jax_xla_dp(ref, qry, m, n, go, ge, rq, qq, R, Q):
    """JAX's XLA scans with an explicit reference-quality array."""
    sub = jrb._substitution_scores(
        jnp.asarray(ref), jnp.asarray(qry), jnp.asarray(rq), jnp.asarray(qq), True
    )
    trace = jrb._fill_batch(sub, jnp.asarray(m), jnp.asarray(n), go, ge, R, Q)
    ops, cnt = jrb._traceback_batch(
        trace, jnp.asarray(ref), jnp.asarray(qry), jnp.asarray(m), jnp.asarray(n), R, Q
    )
    return np.asarray(ops), np.asarray(cnt)


@pytest.fixture
def entries(monkeypatch):
    """Count which scoring entry of K1 (and K2's fill) the port's dispatch
    reaches; on CPU tensors the wrappers run the plain versions."""
    seen = collections.Counter()

    def fused(*args, sub=None, qual=None, **kw):
        seen["sub" if sub is not None else "qual" if qual is not None else "int"] += 1
        return realign_fused(*args, sub=sub, qual=qual, **kw)

    def fill(*args, **kw):
        seen["fill"] += 1
        return fill_batch(*args, **kw)

    monkeypatch.setattr(trb, "realign_fused", fused)
    monkeypatch.setattr(trb, "fill_batch", fill)
    return seen


@pytest.mark.parametrize("B,Q,R", [(300, 16, 16), (64, 24, 48), (8, 128, 128)])
def test_qual_dp_matches_pallas_and_xla_scans(B, Q, R, monkeypatch, entries):
    rng = np.random.default_rng(B * 1000 + Q * 10 + R)
    ref, qry, m, n = _runs(rng, B, Q, R)
    qq = rng.integers(0, 42, (B, Q)).astype(np.int32)
    want_ops, want_cnt = _jax_xla_dp(
        ref, qry, m, n, KGO, KGE, np.full((B, R), PHRED42_MAX, np.int32), qq, R, Q
    )
    p_ops, p_cnt = realign_fused_pallas(
        None, jnp.asarray(ref), jnp.asarray(qry), jnp.asarray(m), jnp.asarray(n),
        KGO, KGE, R, Q, interpret=True,
        qual=(jnp.asarray(qq), jnp.asarray(MROW), jnp.asarray(XROW)),
    )
    assert np.array_equal(want_ops, np.asarray(p_ops))
    assert np.array_equal(want_cnt, np.asarray(p_cnt))

    ops, cnt = realign_fused(
        _t(ref), _t(qry), _t(m), _t(n), KGO, KGE, R, Q,
        qual=(_t(qq), _t(MROW), _t(XROW)),
    )
    assert np.array_equal(ops.numpy(), want_ops)
    assert np.array_equal(cnt.numpy(), want_cnt)
    # the unwired dispatch (query phreds as u8) on both routes
    for fused in ("1", "0"):
        monkeypatch.setenv("PANVC3_PALLAS_FUSED", fused)
        ops, cnt = trb.realign_device_kernel(
            _t(ref), _t(qry), _t(n), _t(m), KGO, KGE, None,
            _t(qq.astype(np.uint8)), True, R, Q,
        )
        assert np.array_equal(ops.numpy(), want_ops), fused
        assert np.array_equal(cnt.numpy(), want_cnt), fused
    assert entries == {"qual": 1, "fill": 1}


@pytest.mark.parametrize("B,Q,R", [(64, 16, 24), (40, 48, 48)])
def test_sub_mode_matches_pallas_and_device_kernel(B, Q, R, monkeypatch, entries):
    rng = np.random.default_rng(B + Q + R)
    ref, qry, m, n = _runs(rng, B, Q, R)
    rq = rng.integers(0, 42, (B, R)).astype(np.int32)
    qq = rng.integers(0, 42, (B, Q)).astype(np.int32)
    go, ge = np.float32(-4 * MALDE_SCALE), np.float32(-2 * MALDE_SCALE)
    sub_j = jrb._substitution_scores(
        jnp.asarray(ref), jnp.asarray(qry), jnp.asarray(rq), jnp.asarray(qq), True
    )
    p_ops, p_cnt = realign_fused_pallas(
        sub_j, jnp.asarray(ref), jnp.asarray(qry), jnp.asarray(m), jnp.asarray(n),
        go, ge, R, Q, interpret=True,
    )
    monkeypatch.setenv("PANVC3_PALLAS_FUSED", "0")
    d_ops, d_cnt = jrb.realign_device_kernel(
        ref, qry, n, m, go, ge, rq, qq, True, R, Q
    )
    assert np.array_equal(np.asarray(p_ops), np.asarray(d_ops))
    assert np.array_equal(np.asarray(p_cnt), np.asarray(d_cnt))

    sub = trb._substitution_scores(_t(ref), _t(qry), _t(rq), _t(qq), True)
    assert np.array_equal(sub.numpy(), np.asarray(sub_j))
    ops, cnt = realign_fused(_t(ref), _t(qry), _t(m), _t(n), go, ge, R, Q, sub=sub)
    assert np.array_equal(ops.numpy(), np.asarray(p_ops))
    assert np.array_equal(cnt.numpy(), np.asarray(p_cnt))
    for fused in ("1", "0"):
        monkeypatch.setenv("PANVC3_PALLAS_FUSED", fused)
        ops, cnt = trb.realign_device_kernel(
            _t(ref), _t(qry), _t(n), _t(m), go, ge, _t(rq), _t(qq), True, R, Q
        )
        assert np.array_equal(ops.numpy(), np.asarray(p_ops)), fused
        assert np.array_equal(cnt.numpy(), np.asarray(p_cnt)), fused
    assert entries == {"sub": 1, "fill": 1}


# K2's edge shapes (chip_smoke.K2_EDGE_SHAPES) that stay small on the CPU
_K2_EDGE_CPU = [s for s in K2_EDGE_SHAPES if max(s[1:]) <= 129]


@pytest.mark.parametrize("scores", ["integer", "malde"])
@pytest.mark.parametrize(
    "B,Q,R", [(7, 8, 8), (130, 16, 16), (64, 32, 16), (40, 24, 48)] + _K2_EDGE_CPU
)
def test_fill_trace_matches_jax_fill_and_pallas(B, Q, R, scores):
    """K2's plain version: every trace cell, rows past m and columns past
    n included; at K2's edge shapes also runs of m > Q and n > R.  The
    Pallas kernel (interpret mode) joins where Q, R <= 64."""
    rng = np.random.default_rng(42 + B + Q + R)
    ref, qry, m, n = _runs(rng, B, Q, R)
    if (B, Q, R) in _K2_EDGE_CPU:
        m, n = k2_edge_lengths(rng, B, Q, R)
    if scores == "integer":
        sub = np.where(rng.random((B, Q, R)) < 0.3, 0.0, -1.0).astype(np.float32)
        go, ge = np.float32(0), np.float32(-1)
    else:
        rq = rng.integers(0, 42, (B, R))
        qq = rng.integers(0, 42, (B, Q))
        idx = rq[:, None, :] * 64 + qq[:, :, None]
        eq = qry[:, :, None] == ref[:, None, :]
        sub = np.where(eq, MT.reshape(-1)[idx], XT.reshape(-1)[idx]).astype(np.float32)
        go, ge = KGO, KGE
    want = np.asarray(jrb._fill_batch(jnp.asarray(sub), jnp.asarray(m), jnp.asarray(n), go, ge, R, Q))
    if max(Q, R) <= 64:
        pallas = np.asarray(
            fill_batch_pallas(jnp.asarray(sub), jnp.asarray(m), jnp.asarray(n), go, ge, R, Q, interpret=True)
        )
        assert np.array_equal(want, pallas)
    got = trb.fill_dispatch(_t(sub), _t(m), _t(n), go, ge, R, Q)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (B, Q + 1, R + 1)
    assert np.array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="sub must be"):
        fill_batch(_t(sub).double(), _t(m), _t(n), go, ge, R, Q)


def _q_wire_case(rng, S, R, Q, acgt):
    rl = rng.integers(0, R + 1, S).astype(np.int32)
    ql = rng.integers(0, Q + 1, S).astype(np.int32)
    rl[:2] = [0, R]
    ql[:2] = [Q, 0]
    lane_q = np.arange(Q)[None, :] < ql[:, None]
    alpha = b"ACGT" if acgt else b"ACGTNacgRY"
    qry = rng.choice(np.frombuffer(alpha, np.uint8), (S, Q)).astype(np.uint8)
    qry = np.where(lane_q, qry, 0).astype(np.uint8)
    qq = np.where(lane_q, rng.integers(0, 42, (S, Q)), 0).astype(np.uint8)
    return rl, ql, qry, qq


@pytest.mark.parametrize("route", ["fused", "split"])
@pytest.mark.parametrize("wire", ["classic", "refgather", "refgather2"])
def test_quality_wire_rows_match_jax(wire, route, monkeypatch):
    monkeypatch.setenv("PANVC3_PALLAS_FUSED", "0")  # JAX: its XLA scans
    rng = np.random.default_rng({"classic": 11, "refgather": 12, "refgather2": 13}[wire])
    S, R, Q = 200, 24, 24
    rl, ql, qry, qq = _q_wire_case(rng, S, R, Q, acgt=wire == "refgather2")
    flat = rng.choice(np.frombuffer(b"ACGTACGTacgtNnUuRY", np.uint8), 5000).astype(np.uint8)
    start = rng.integers(0, 5000 - R, S).astype(np.int64)
    start[2] = 5000 - 3  # a row running off the end is clamped
    if wire == "classic":
        ref = np.where(
            np.arange(R)[None, :] < rl[:, None],
            rng.choice(np.frombuffer(b"ACGTN", np.uint8), (S, R)), 0,
        ).astype(np.uint8)
        packed = jrb.pack_realign_wire_input_q(ref, qry, rl, ql, qq)
        want = jrb.realign_device_kernel_wire_q(packed, KGO, KGE, R, Q)
        run = lambda: trb._realign_wire_q(_t(packed), KGO, KGE, R, Q)  # noqa: E731
    elif wire == "refgather":
        packed = jrb.pack_realign_refgather_input_q(qry, start, rl, ql, qq)
        want = jrb.realign_device_kernel_wire_refgather_q(
            packed, jnp.asarray(flat), KGO, KGE, R, Q
        )
        run = lambda: trb._realign_wire_refgather_q(_t(packed), _t(flat), KGO, KGE, R, Q)  # noqa: E731
    else:
        assert jrb.query_wire2_eligible(qry, ql)
        packed = jrb.pack_realign_refgather2_input_q(qry, start, rl, ql, qq)
        want = jrb.realign_device_kernel_wire_refgather2_q(
            packed, jnp.asarray(flat), KGO, KGE, R, Q
        )
        run = lambda: trb._realign_wire_refgather2_q(_t(packed), _t(flat), KGO, KGE, R, Q)  # noqa: E731
    monkeypatch.setenv("PANVC3_PALLAS_FUSED", "1" if route == "fused" else "0")
    got = run()
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_quality_pack_helpers_match_jax(monkeypatch):
    rng = np.random.default_rng(21)
    S, R, Q = 64, 16, 24
    ref = rng.integers(0, 256, (S, R)).astype(np.uint8)
    qry = rng.choice(np.frombuffer(b"ACGTN\x00x", np.uint8), (S, Q)).astype(np.uint8)
    rl = rng.integers(0, R + 1, S).astype(np.int32)
    ql = rng.integers(0, Q + 1, S).astype(np.int32)
    start = rng.integers(0, 1 << 31, S).astype(np.int64)
    qq = rng.integers(0, 64, (S, Q)).astype(np.uint8)  # the full 6-bit range
    assert np.array_equal(
        trb.pack_realign_wire_input_q(ref, qry, rl, ql, qq),
        jrb.pack_realign_wire_input_q(ref, qry, rl, ql, qq),
    )
    for fn in ("pack_realign_refgather_input_q", "pack_realign_refgather2_input_q"):
        assert np.array_equal(
            getattr(trb, fn)(qry, start, rl, ql, qq), getattr(jrb, fn)(qry, start, rl, ql, qq)
        ), fn
    # the 6-bit phreds decode back on the port's 2-bit wire
    acgt = np.where(
        np.arange(Q)[None, :] < ql[:, None],
        rng.choice(np.frombuffer(b"ACGT", np.uint8), (S, Q)), 0,
    ).astype(np.uint8)
    qq = np.where(np.arange(Q)[None, :] < ql[:, None], qq, 0).astype(np.uint8)
    packed = trb.pack_realign_refgather2_input_q(acgt, start, rl, ql, qq)
    seen = {}

    def spy(ref, query, qq_dec, *rest):
        seen["qq"] = qq_dec
        return torch.zeros((S, R + Q), dtype=torch.int8), torch.zeros(S, dtype=torch.int32)

    monkeypatch.setattr(trb, "_qual_dp", spy)
    trb._realign_wire_refgather2_q(_t(packed), torch.zeros(16, dtype=torch.uint8), 0, -1, R, Q)
    assert np.array_equal(seen["qq"].numpy(), qq.astype(np.int32))


def _quality_fixtures():
    groups: dict[tuple[int, int], list] = {}
    for line in (DATA_DIR / "tiebreak_fixtures.tsv").read_text().splitlines():
        if not line or line.startswith("#"):
            continue
        kind, go, ge, s1, s2, quals, _score, cigar = line.split("\t")
        if quals != "-":
            row = (kind, s1, s2, [int(q) for q in quals.split(",")], cigar)
            groups.setdefault((int(go), int(ge)), []).append(row)
    return groups


@pytest.mark.parametrize("route", ["fused", "split", "explicit-sub", "host-c-dp", "batch-device"])
def test_tiebreak_fixtures_quality_cases(route, monkeypatch, entries):
    """The 268 quality rows of the locked tie-break table (kinds qual and
    qualhomo) reproduce their CIGARs through every route of the port."""
    groups = _quality_fixtures()
    assert sum(len(g) for g in groups.values()) == 268
    monkeypatch.setenv("PANVC3_PALLAS_FUSED", "0" if route == "split" else "1")
    monkeypatch.setenv("PANVC3_HOST_DP", "1" if route == "host-c-dp" else "0")
    for (go, ge), rows in groups.items():
        if route in ("host-c-dp", "batch-device"):
            got = trb.realign_batch(
                [r[1].encode() for r in rows], [r[2].encode() for r in rows], go, ge,
                trb.PINNED_REF_QUALS, [np.asarray(r[3], np.int32) for r in rows],
                device="cpu",
            )
        else:
            B = len(rows)
            R = max(len(r[1]) for r in rows)
            Q = max(len(r[2]) for r in rows)
            ref = np.zeros((B, R), np.uint8)
            qry = np.zeros((B, Q), np.uint8)
            qq = np.zeros((B, Q), np.int32)
            n = np.array([len(r[1]) for r in rows], np.int32)
            m = np.array([len(r[2]) for r in rows], np.int32)
            for b, r in enumerate(rows):
                ref[b, :n[b]] = np.frombuffer(r[1].encode(), np.uint8)
                qry[b, :m[b]] = np.frombuffer(r[2].encode(), np.uint8)
                qq[b, :m[b]] = r[3]
            # an explicit all-max reference-quality tile scores as pinned
            rq = _t(np.full((B, R), PHRED42_MAX, np.int32)) if route == "explicit-sub" else None
            ops, cnt = trb.realign_device_kernel(
                _t(ref), _t(qry), _t(n), _t(m), go * MALDE_SCALE, ge * MALDE_SCALE,
                rq, _t(qq), True, R, Q,
            )
            got = trb.realign_batch_finish((ops, cnt))
        for row, g in zip(rows, got):
            assert format_cigar(g) == row[4], f"{row[0]} {row[1]} {row[2]} go={go} ge={ge} {route}"
    want = {
        "fused": {"qual"}, "batch-device": {"qual"}, "explicit-sub": {"sub"},
        "split": {"fill"}, "host-c-dp": set(),
    }[route]
    assert set(entries) == want


def _with_random_quals(sam: bytes, seed: int) -> bytes:
    """Replace every record's quality string by seeded phreds 2..41."""
    rng = np.random.default_rng(seed)
    out = []
    for ln in sam.split(b"\n"):
        f = ln.split(b"\t")
        if ln and not ln.startswith(b"@") and len(f) > 10:
            f[10] = (rng.integers(2, 42, len(f[9])) + 33).astype(np.uint8).tobytes()
        out.append(b"\t".join(f))
    return b"\n".join(out)


def test_cli_quality_device_lane_matches_jax(msa_files, founder_seqs, tmp_path):  # noqa: F811
    """``project_alignments -q --device cpu`` on the device lane."""
    index_path, _, _ = msa_files
    sam = _rich_sam(founder_seqs)
    want, want_ranges = _jax_host(
        sam, index_path, GENOME, tmp_path, use_read_base_qualities=True
    )
    got, got_ranges, diag, err = _port_cli(sam, index_path, GENOME, tmp_path, extra=("-q",))
    assert _strip_pg(got) == _strip_pg(want)
    assert got_ranges == want_ranges
    assert diag["device"] == "cpu"
    assert diag["dispatches"] > 0 and diag["refgather"] > 0 and diag["wire2"] > 0
    # every entry is counted, and none launches on CPU tensors
    assert diag["kernel_launches"] == {
        "realign_fused_int": 0, "realign_fused_qual": 0,
        "realign_fused_sub": 0, "realign_fill_sub": 0, "realign_traceback": 0,
    }
    assert "Matched reads:     160" in err
    # the qualities were used: the integer run differs
    int_want, _ = _jax_host(sam, index_path, GENOME, tmp_path)
    assert _strip_pg(int_want) != _strip_pg(want)


def test_cli_quality_adversarial_matches_fixtures_and_jax(tmp_path):
    rows = [r for r in ROWS if r["mode"] == "q"]
    assert len(rows) >= 30
    index_path, fa_path, sam = _build_inputs(tmp_path, rows)
    want, want_ranges = _jax_host(sam, index_path, fa_path, tmp_path, use_read_base_qualities=True)
    got, got_ranges, diag, _ = _port_cli(sam, index_path, fa_path, tmp_path, extra=("-q",))
    assert _strip_pg(got) == _strip_pg(want)
    assert got_ranges == want_ranges
    assert diag["dispatches"] > 0
    fields = {}
    for line in got.decode().splitlines():
        if not line.startswith("@"):
            f = line.split("\t")
            fields[f[0]] = (int(f[3]) - 1, f[5])
    for i, r in enumerate(rows):
        assert fields[f"r{i}"] == (r["exp_pos"], r["exp_cigar"]), r["name"]


@pytest.fixture(scope="module")
def rich_cases(msa_files, founder_seqs, tmp_path_factory):  # noqa: F811
    index_path, _, _ = msa_files
    sam = _rich_sam(founder_seqs, n_reads=480, seed=13)
    want = {
        q: _jax_host(
            sam, index_path, GENOME, tmp_path_factory.mktemp("jax"),
            use_read_base_qualities=q,
        )
        for q in (True, False)
    }
    return index_path, sam, want


_DEVICE = {"PANVC3_HOST_DP": "0"}


@pytest.mark.parametrize(
    "quality,variant,engaged,entry",
    [
        # per-batch device dispatch (the unwired -q call), no aggregation
        (True, {**_DEVICE, "PANVC3_DP_AGGREGATE": "0"}, {"dispatches": 0}, "qual"),
        # aggregate dispatch shipping staged reference rows (classic -q wire)
        (True, {**_DEVICE, "PANVC3_DP_REFGATHER": "0"}, {"refgather": 0}, "qual"),
        # 4-bit ref-gather -q wire
        (True, {**_DEVICE, "PANVC3_DP_WIRE2": "0"}, {"wire2": 0}, "qual"),
        # host C DP lane with the Malde tables
        (True, {"PANVC3_HOST_DP_CELLS": str(10**18)}, {"dispatches": 0}, None),
        # adaptive lane choice and the device lane under scheduling jitter
        (True, {"PANVC3_FASTLANE_CHAOS": "5"}, {}, "any"),
        (True, {**_DEVICE, "PANVC3_FASTLANE_CHAOS": "6"}, {}, "qual"),
        # the split route: K2's fill, then the plain traceback
        (True, {**_DEVICE, "PANVC3_PALLAS_FUSED": "0"}, {}, "fill"),
        (False, {**_DEVICE, "PANVC3_PALLAS_FUSED": "0"}, {}, "fill"),
    ],
    ids=[
        "per-batch", "no-refgather", "wire4", "host-lane", "chaos-adaptive",
        "chaos-device", "split", "split-integer",
    ],
)
def test_quality_fastlane_variants_match_jax(
    rich_cases, tmp_path, monkeypatch, entries, quality, variant, engaged, entry
):
    from panvc3_tpu_torch.pipeline import fastlane

    index_path, sam, want_all = rich_cases
    want, want_ranges = want_all[quality]
    for key in ("PANVC3_HOST_DP", "PANVC3_HOST_DP_CELLS", "PANVC3_PALLAS_FUSED"):
        monkeypatch.delenv(key, raising=False)
    for key, val in variant.items():
        monkeypatch.setenv(key, val)
    before = dict(fastlane.AGG_DIAG)
    got, got_ranges, stats = _port_inprocess(
        sam, index_path, tmp_path, use_read_base_qualities=quality
    )
    delta = {k: fastlane.AGG_DIAG[k] - before[k] for k in before}
    assert stats.realigned_range_count > 0
    assert _strip_pg(got) == _strip_pg(want)
    assert got_ranges == want_ranges
    for key, val in engaged.items():
        assert delta[key] == val, (key, delta)
    if "PANVC3_DP_AGGREGATE" not in variant and "PANVC3_HOST_DP" in variant:
        assert delta["dispatches"] > 0, delta
    if "PANVC3_DP_WIRE2" in variant:
        assert delta["refgather"] > 0, delta
    if entry is None:
        assert not entries, entries
    elif entry != "any":
        assert set(entries) == {entry}, entries


@pytest.mark.parametrize("aggregate", ["1", "0"])
def test_quality_long_runs_match_jax(msa_files, founder_seqs, tmp_path, monkeypatch, entries, aggregate):  # noqa: F811
    """-q runs with R+Q >= 256: no wire carries them (the unwired call)."""
    index_path, _, _ = msa_files
    sam = _with_random_quals(_long_run_sam(founder_seqs), seed=9)
    want, want_ranges = _jax_host(sam, index_path, GENOME, tmp_path, use_read_base_qualities=True)
    monkeypatch.setenv("PANVC3_HOST_DP", "0")
    monkeypatch.setenv("PANVC3_DP_AGGREGATE", aggregate)
    from panvc3_tpu_torch.pipeline import fastlane

    before = dict(fastlane.AGG_DIAG)
    got, got_ranges, stats = _port_inprocess(
        sam, index_path, tmp_path, use_read_base_qualities=True
    )
    delta = {k: fastlane.AGG_DIAG[k] - before[k] for k in before}
    assert delta["refgather"] == 0
    assert (delta["dispatches"] > 0) == (aggregate == "1")
    assert stats.realigned_range_count >= 24
    assert _strip_pg(got) == _strip_pg(want)
    assert got_ranges == want_ranges
    assert set(entries) == {"qual"}
