"""The split route's traceback on the port against panvc3_tpu's, byte for
byte, and the traceback kernel against its plain version on a card.

Inputs are made from a seed with numpy and handed to both packages.  The
tolerance is zero: the traceback moves bytes and compares integers, and
every DP score is an integer exact in f32 (Malde scores in 1/256 units,
gap costs scaled to match), so the trace, the ops and the counts must be
identical.  The JAX side runs on the CPU: the fill and the traceback as
XLA scans (``panvc3_tpu.ops.realign_batch._fill_batch`` and
``_traceback_batch``).  On CPU tensors ``traceback_batch`` runs the plain
PyTorch ``_traceback_batch``; the CUDA kernel (``realign_traceback.cu``)
only runs on a card.  The module imports no JAX at its top, so its
``cuda``-marked test runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_traceback.py -m cuda -q
"""

from __future__ import annotations

import pathlib
import re

import numpy as np
import pytest
import torch

from chip_smoke import K2_EDGE_SHAPES, TB_EDGE_CASES, k2_edge_lengths, tb_edge_case
from panvc3_tpu_torch.align import MALDE_SCALE
from panvc3_tpu_torch.ops import _kernels
from panvc3_tpu_torch.ops import realign_batch as trb
from panvc3_tpu_torch.ops.realign_pallas import fill_batch
from panvc3_tpu_torch.ops.realign_traceback import traceback_batch

SOURCE = pathlib.Path(trb.__file__).parent / "csrc" / "realign_traceback.cu"


@pytest.fixture(scope="module")
def jax_ops():
    """JAX's realign_batch module and ``jnp``, imported here so that the
    card test below runs without JAX."""
    import jax.numpy as jnp

    from panvc3_tpu.ops import realign_batch as jrb

    return jrb, jnp


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _runs(rng, B, Q, R, lengths):
    """[ref, query, m, n] as numpy: every run full, random lengths (the
    first runs at the edges), or m, n or both 0."""
    letters = np.frombuffer(b"ACGT", np.uint8)
    ref = rng.choice(letters, (B, R)).astype(np.uint8)
    qry = rng.choice(letters, (B, Q)).astype(np.uint8)
    m = rng.integers(0, Q + 1, B).astype(np.int32)
    n = rng.integers(0, R + 1, B).astype(np.int32)
    if lengths == "full":
        m[:], n[:] = Q, R
    elif lengths == "random":
        k = min(B, 4)
        m[:k] = [Q, 0, Q, 0][:k]
        n[:k] = [R, R, 0, 0][:k]
    elif lengths == "m0":
        m[:] = 0
    elif lengths == "n0":
        n[:] = 0
    elif lengths == "both0":
        m[:], n[:] = 0, 0
    return ref, qry, m, n


# (B, Q, R, lengths): the split route's window (full and random 48x48),
# runs of R != Q, empty runs, and 128x128
_CASES = [
    (64, 48, 48, "full"),
    (200, 48, 48, "random"),
    (120, 16, 24, "random"),
    (90, 24, 9, "random"),
    (50, 16, 16, "m0"),
    (50, 16, 16, "n0"),
    (20, 16, 16, "both0"),
    (8, 128, 128, "random"),
]


def _scores(scoring, rng, B, Q):
    """(go, ge, query phreds or None): integer costs, or ``-q``'s Malde
    costs in 1/MALDE_SCALE units with seeded query phreds."""
    if scoring == "integer":
        return -6.0, -1.0, None
    return -6 * MALDE_SCALE, -1 * MALDE_SCALE, rng.integers(0, 42, (B, Q)).astype(np.int32)


@pytest.mark.parametrize("scoring", ["integer", "quality"])
@pytest.mark.parametrize("B,Q,R,lengths", _CASES)
def test_traceback_matches_jax(jax_ops, B, Q, R, lengths, scoring):
    """JAX's fill and traceback scans against the port's fill and
    ``traceback_batch`` (its plain version on the CPU): the trace, then
    the ops and counts, byte for byte; the port's traceback also on JAX's
    own trace."""
    jrb, jnp = jax_ops
    rng = np.random.default_rng(B * 1000 + Q * 10 + R + len(lengths))
    ref, qry, m, n = _runs(rng, B, Q, R, lengths)
    go, ge, qq = _scores(scoring, rng, B, Q)
    use_q = qq is not None
    j_sub = jrb._substitution_scores(
        jnp.asarray(ref), jnp.asarray(qry), None, None if qq is None else jnp.asarray(qq), use_q
    )
    j_trace = jrb._fill_batch(j_sub, jnp.asarray(m), jnp.asarray(n), jnp.float32(go), jnp.float32(ge), R, Q)
    j_ops, j_cnt = jrb._traceback_batch(
        j_trace, jnp.asarray(ref), jnp.asarray(qry), jnp.asarray(m), jnp.asarray(n), R, Q
    )
    j_ops, j_cnt, j_trace = np.asarray(j_ops), np.asarray(j_cnt), np.asarray(j_trace)

    ref_t, qry_t, m_t, n_t = (_t(a) for a in (ref, qry, m, n))
    sub = trb._substitution_scores(ref_t, qry_t, None, None if qq is None else _t(qq), use_q)
    trace = fill_batch(sub.contiguous(), m_t, n_t, go, ge, R, Q)
    assert np.array_equal(trace.numpy(), j_trace)
    ops, cnt = traceback_batch(trace, ref_t, qry_t, m_t, n_t, R, Q)
    assert ops.dtype == torch.int8 and cnt.dtype == torch.int32
    assert np.array_equal(ops.numpy(), j_ops)
    assert np.array_equal(cnt.numpy(), j_cnt)
    ops, cnt = traceback_batch(_t(j_trace.copy()), ref_t, qry_t, m_t, n_t, R, Q)
    assert np.array_equal(ops.numpy(), j_ops)
    assert np.array_equal(cnt.numpy(), j_cnt)


@pytest.mark.parametrize("quality", [False, True], ids=["int", "q"])
def test_split_route_dp_matches_jax(jax_ops, monkeypatch, quality):
    """The split route's dispatch (``_dp`` under PANVC3_PALLAS_FUSED=0, K2's
    fill and ``traceback_batch``) against JAX's scans, through the unwired
    entry ``realign_device_kernel``."""
    jrb, jnp = jax_ops
    monkeypatch.setenv("PANVC3_PALLAS_FUSED", "0")
    called = []
    monkeypatch.setattr(trb, "traceback_batch", lambda *a: called.append(1) or traceback_batch(*a))
    rng = np.random.default_rng(11 + quality)
    B, Q, R = 150, 40, 48
    ref, qry, m, n = _runs(rng, B, Q, R, "random")
    go, ge, qq = _scores("quality" if quality else "integer", rng, B, Q)
    j_sub = jrb._substitution_scores(
        jnp.asarray(ref), jnp.asarray(qry), None, None if qq is None else jnp.asarray(qq), quality
    )
    j_trace = jrb._fill_batch(j_sub, jnp.asarray(m), jnp.asarray(n), jnp.float32(go), jnp.float32(ge), R, Q)
    j_ops, j_cnt = jrb._traceback_batch(
        j_trace, jnp.asarray(ref), jnp.asarray(qry), jnp.asarray(m), jnp.asarray(n), R, Q
    )
    ops, cnt = trb.realign_device_kernel(
        _t(ref), _t(qry), _t(n), _t(m), go, ge, None,
        None if qq is None else _t(qq.astype(np.uint8)), quality, R, Q,
    )
    assert called == [1]
    assert np.array_equal(ops.numpy(), np.asarray(j_ops))
    assert np.array_equal(cnt.numpy(), np.asarray(j_cnt))


def _random_bytes(rng, B, Q, R, lengths):
    """[trace, ref, query, m, n] as numpy: a trace of random bytes (every
    move value, both open bits, the high bits set), ref and query of
    random bytes, and lengths inside the run (``in``) or past it: m > Q,
    n > R, m < 0, or all of them around the run."""
    trace = rng.integers(0, 256, (B, Q + 1, R + 1), dtype=np.uint8)
    ref = rng.integers(0, 256, (B, R), dtype=np.uint8)
    qry = rng.integers(0, 256, (B, Q), dtype=np.uint8)
    m = rng.integers(0, Q + 1, B).astype(np.int32)
    n = rng.integers(0, R + 1, B).astype(np.int32)
    if lengths == "m>Q":
        m = rng.integers(Q + 1, Q + 10, B).astype(np.int32)
    elif lengths == "n>R":
        n = rng.integers(R + 1, R + 10, B).astype(np.int32)
    elif lengths == "m<0":
        m = rng.integers(-6, 0, B).astype(np.int32)
    elif lengths == "around":
        m = rng.integers(-5, Q + 10, B).astype(np.int32)
        n = rng.integers(-5, R + 10, B).astype(np.int32)
    return trace, ref, qry, m, n


def _jax_traceback(jax_ops, trace, ref, qry, m, n, R, Q):
    jrb, jnp = jax_ops
    ops, cnt = jrb._traceback_batch(*(jnp.asarray(np.asarray(a)) for a in (trace, ref, qry, m, n)), R, Q)
    return np.asarray(ops), np.asarray(cnt)


@pytest.mark.parametrize("lengths", ["in", "m>Q", "n>R", "m<0", "around"])
@pytest.mark.parametrize("B,Q,R", [(64, 6, 7), (40, 16, 16), (24, 48, 48), (12, 1, 9)])
def test_plain_matches_jax_on_random_bytes(jax_ops, B, Q, R, lengths):
    """The plain ``_traceback_batch`` against JAX's scan on traces of random
    bytes, with lengths inside and outside the contract: the semantics the
    kernel keeps (a flat index outside the run's trace, and a query or
    reference index outside its row, reads 0; move 3 emits D and stays)."""
    rng = np.random.default_rng(B * 100 + Q * 10 + R + len(lengths))
    trace, ref, qry, m, n = _random_bytes(rng, B, Q, R, lengths)
    assert set(np.unique(trace & 3)) == {0, 1, 2, 3}
    assert (trace & 4).any() and (trace & 8).any()
    want_ops, want_cnt = _jax_traceback(jax_ops, trace, ref, qry, m, n, R, Q)
    ops, cnt = trb._traceback_batch(*(_t(a) for a in (trace, ref, qry, m, n)), R, Q)
    assert np.array_equal(ops.numpy(), want_ops)
    assert np.array_equal(cnt.numpy(), want_cnt)


# the kernel plan's edge cases small enough for JAX's scan on the CPU
_CPU_EDGE_CASES = [c for c in TB_EDGE_CASES if c[1] <= 64 and c[2] <= 64]


@pytest.mark.parametrize("case", _CPU_EDGE_CASES, ids=str)
def test_plain_matches_jax_at_plan_edges(jax_ops, case):
    """``traceback_batch`` on CPU tensors (the plain version) against JAX's
    scan on the kernel plan's edge cases (``chip_smoke.TB_EDGE_CASES``):
    B = 1, B not a multiple of the runs per group, R+1 odd, views at an
    offset, random bytes with lengths around the run."""
    B, Q, R = case[:3]
    args = tb_edge_case(np.random.default_rng(B + Q + R), case, "cpu")
    assert args[0].shape == (B, Q + 1, R + 1)
    want_ops, want_cnt = _jax_traceback(jax_ops, *args, R, Q)
    ops, cnt = traceback_batch(*args, R, Q)
    assert np.array_equal(ops.numpy(), want_ops)
    assert np.array_equal(cnt.numpy(), want_cnt)


def test_traceback_batch_checks_its_inputs():
    """A wrong dtype, shape, device or layout raises; so does a device
    other than the CPU or CUDA (no plain walk runs there)."""
    B, Q, R = 4, 5, 6
    trace = torch.zeros((B, Q + 1, R + 1), dtype=torch.uint8)
    ref = torch.zeros((B, R), dtype=torch.uint8)
    qry = torch.zeros((B, Q), dtype=torch.uint8)
    m = torch.full((B,), Q, dtype=torch.int32)
    n = torch.full((B,), R, dtype=torch.int32)
    bad = {
        "trace": trace[:, :, :R],
        "ref": ref.int(),
        "query": torch.zeros((B, Q + 1), dtype=torch.uint8),
        "m": m.long(),
        "n": torch.zeros((2 * B,), dtype=torch.int32)[::2],
    }
    for name, value in bad.items():
        args = dict(trace=trace, ref=ref, query=qry, m=m, n=n)
        args[name] = value
        with pytest.raises(ValueError, match=name):
            traceback_batch(**args, R=R, Q=Q)
    meta = [t.to("meta") for t in (trace, ref, qry, m, n)]
    with pytest.raises(ValueError, match="unsupported device"):
        traceback_batch(*meta, R, Q)
    with pytest.raises(ValueError, match="is on"):
        traceback_batch(trace, ref, qry, m, meta[4], R, Q)


def test_realign_batch_on_cuda_raises_without_a_card(monkeypatch):
    """``realign_batch`` on the split route with ``device="cuda"`` and no
    card raises; it never runs the plain traceback in the kernel's place."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: realign_batch would launch the kernels")
    monkeypatch.setenv("PANVC3_PALLAS_FUSED", "0")
    monkeypatch.setenv("PANVC3_HOST_DP", "0")

    def plain(*args):
        raise AssertionError("the plain traceback ran in the kernel's place")

    monkeypatch.setattr(trb, "_traceback_batch", plain)
    with pytest.raises(RuntimeError, match="is_available"):
        trb.realign_batch([b"ACGTAC"] * 3, [b"ACTTTAC"] * 3, -6, -1, device="cuda")
    # the same call on the CPU reaches the plain version through the wrapper
    with pytest.raises(AssertionError, match="kernel's place"):
        trb.realign_batch([b"ACGTAC"] * 3, [b"ACTTTAC"] * 3, -6, -1, device="cpu")


def test_kernel_entry_matches_its_binding():
    """The C entry's parameters are the ctypes signature's, one pointer per
    buffer, and its launches are counted."""
    source, argtypes = _kernels._SIGNATURES["realign_traceback"]
    assert source == SOURCE.name
    text = SOURCE.read_text()
    params = re.search(r'extern "C" int realign_traceback\(([^)]*)\)', text).group(1)
    kinds = ["int" if p.split()[0] == "int" else "ptr" for p in params.split(",")]
    assert kinds == ["int" if a is _kernels._I else "ptr" for a in argtypes]
    assert "realign_traceback" in _kernels.LAUNCHES


def test_plan_helper_matches_its_binding():
    """The plan helper's C parameters are its ctypes signature's, it is not
    counted as a launch, and it fills one int per ``PLAN_FIELDS`` entry."""
    from panvc3_tpu_torch.ops.realign_traceback import PLAN_FIELDS

    source, argtypes = _kernels._HELPERS["realign_traceback_plan"]
    assert source == SOURCE.name
    text = SOURCE.read_text()
    params = re.search(r'extern "C" int realign_traceback_plan\(([^)]*)\)', text).group(1)
    kinds = ["int" if p.split()[0] == "int" else "ptr" for p in params.split(",")]
    assert kinds == ["int" if a is _kernels._I else "ptr" for a in argtypes]
    assert "realign_traceback_plan" not in _kernels.LAUNCHES
    assert f"v[{len(PLAN_FIELDS)}]" in text


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc for the hand-written kernel")
    return torch.device("cuda")


# the split route's shapes, 1x1, and K2's edge shapes (each chunk boundary
# of the fill, R on both sides of Q, long queries, R > 2047), with lengths
# inside the run (the traceback's contract)
_CARD_SHAPES = [(4096, 48, 48), (256, 128, 128), (33, 7, 29), (1, 1, 1)] + K2_EDGE_SHAPES


@pytest.mark.cuda
@pytest.mark.parametrize("scoring", ["integer", "quality"])
@pytest.mark.parametrize("B,Q,R", _CARD_SHAPES)
def test_kernel_matches_plain_version(cuda, B, Q, R, scoring):
    """The kernel on K2's trace against the plain ``_traceback_batch`` on
    the card: every op and count, full, empty and random runs; one launch."""
    rng = np.random.default_rng(B * 7 + Q + R)
    ref, qry = (_t(a).to(cuda) for a in _runs(rng, B, Q, R, "random")[:2])
    m, n = k2_edge_lengths(rng, B, Q, R)
    m, n = (_t(np.clip(a, 0, hi)).to(cuda) for a, hi in ((m, Q), (n, R)))
    go, ge, qq = _scores(scoring, rng, B, Q)
    qq_t = None if qq is None else _t(qq).to(cuda)
    sub = trb._substitution_scores(ref, qry, None, qq_t, qq is not None).contiguous()
    trace = fill_batch(sub, m, n, go, ge, R, Q)
    before = _kernels.LAUNCHES["realign_traceback"]
    ops, cnt = traceback_batch(trace, ref, qry, m, n, R, Q)
    assert _kernels.LAUNCHES["realign_traceback"] == before + 1
    want_ops, want_cnt = trb._traceback_batch(trace, ref, qry, m, n, R, Q)
    torch.cuda.synchronize()
    assert torch.equal(ops, want_ops)
    assert torch.equal(cnt, want_cnt)


def test_chip_smoke_split_route_phase_on_cpu(tmp_path, monkeypatch, capsys):
    """``chip_smoke.py`` phase 5 (b) at a small size with ``--device cpu``:
    the split route gives the device lane's SAM; no card, so nothing is
    launched."""
    import chip_smoke
    from panvc3_tpu_torch import synth

    for key in chip_smoke.Tool.ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    n_reads = 1024
    rows = synth.make_msa(200_000, seed=5)
    index_path, fasta_path, founders = synth.write_inputs(tmp_path, "chr21", rows)
    q_sam = tmp_path / "reads_q.sam"
    q_sam.write_bytes(synth.reads_sam("chr21", founders, n_reads, 6, qualities=True))
    tool = chip_smoke.Tool("cpu rehearsal", tmp_path, index_path, fasta_path, device="cpu")
    q_dev, *_ = tool.run("q-device", {"PANVC3_HOST_DP": "0"}, q_sam, quality=True, expect=n_reads)
    used = {}
    q_split = chip_smoke.phase_split_route(tool, q_sam, used, n_reads=n_reads)
    assert chip_smoke.strip_pg(q_split) == chip_smoke.strip_pg(q_dev)
    assert used == {"realign_fill_sub": 0, "realign_traceback": 0}
    assert "[slice] -q split route" in capsys.readouterr().out


@pytest.mark.cuda
@pytest.mark.parametrize("case", TB_EDGE_CASES, ids=str)
def test_kernel_at_plan_edges(cuda, case):
    """The kernel against the plain version at the plan's edges: both
    schedules, B = 1 and 77, offset views, random-byte traces with lengths
    inside and around the run; one launch each."""
    B, Q, R = case[:3]
    args = tb_edge_case(np.random.default_rng(B * 3 + Q + R), case, cuda)
    before = _kernels.LAUNCHES["realign_traceback"]
    ops, cnt = traceback_batch(*args, R, Q)
    assert _kernels.LAUNCHES["realign_traceback"] == before + 1
    want_ops, want_cnt = trb._traceback_batch(*args, R, Q)
    torch.cuda.synchronize()
    assert torch.equal(ops, want_ops)
    assert torch.equal(cnt, want_cnt)


@pytest.mark.cuda
def test_kernel_plan(cuda):
    """The plan: the window's 48x48 runs in groups of 22, four walking warps
    on a buffer each; one 300x300 run on each of two; 400x400 on the global
    schedule."""
    from panvc3_tpu_torch.ops.realign_traceback import traceback_plan

    window = traceback_plan(16384, 48, 48)
    assert (window["shared"], window["runs"], window["warps"]) == (1, 22, 4)
    assert 0 < window["smem_bytes"] <= 232448 and window["threads"] == 160
    assert 0 < window["blocks"] <= -(-16384 // 22)
    big = traceback_plan(7, 300, 300)
    assert (big["shared"], big["runs"], big["warps"]) == (1, 1, 2)
    assert traceback_plan(9, 400, 400)["shared"] == 0
