"""The port's fused projection engines, their engine lane and the arbiter
against panvc3_tpu.

Function by function: ``fused_projection_kernel`` (v3),
``_fused_event_body`` (v4) and ``projection_step`` get the same seeded
numpy inputs as their JAX counterparts, over a ``DeviceGapIndex`` and a
``DeviceEventGeometry`` of each package built from the same MSA rows, and
every output element must be equal.  The cases cover no overflow,
event-slot overflow, run-pool overflow, run-length overflow, a deletion
run >= 255 and op counts >= 2**26; where the run pool overflowed, several
runs share its last slot (unspecified content, discarded by the engine),
so only the wire outputs and the flags are compared there.

End to end: ``ProjectConfig(fused_kernel=True)`` on the CPU must give
panvc3_tpu's SAM (``@PG`` stripped) and realigned-ranges TSV byte for byte,
and the port's own object path's, with the route counters asserting that
v4's own DP answered.  panvc3_tpu's fused lane is gated on its native
build, which this sandbox lacks, so its side is the run it takes there:
its host engine or its split path (the engines are byte-identical by
design); no test here patches its native loader.
"""

from __future__ import annotations

import io
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import panvc3_tpu.ops.fused as jax_fused
import panvc3_tpu.ops.rank_select as jax_rs
from panvc3_tpu.bitvec import GapBitVector as JaxGapBitVector
from panvc3_tpu.ops.forward import projection_step as jax_projection_step
from panvc3_tpu.ops.fused_event import make_fused_event_kernel as jax_make_fused_event_kernel
from panvc3_tpu.pipeline import project_alignments as jax_pa
from panvc3_tpu_torch.bitvec import GapBitVector
from panvc3_tpu_torch.ops import engine as port_engine
from panvc3_tpu_torch.ops import fused, fused_event
from panvc3_tpu_torch.ops.forward import projection_step
from panvc3_tpu_torch.ops.rank_select import DeviceGapIndex
from panvc3_tpu_torch.ops.rewrite_batch import expand_cigars

from .test_engine import _synthesise_indel_sam
from .test_torch_device_event import _geometries
from .test_workflow_data import WORKFLOW, founder_seqs, msa_files  # noqa: F401 (fixtures)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GENOME = str(WORKFLOW / "genome/genome.fa.gz")
LETTERS = np.frombuffer(b"ACGT", np.uint8)

V3_WIRE = ("dst_pos", "d8", "main_code", "d_run")
V4_WIRE = ("initial", "gapbits", "d_vals", "d_pos8", "d_n8")


# ---------------------------------------------------------------------------
# function by function
# ---------------------------------------------------------------------------


def _row(rng, n_cols, rate, every=0, long_gap=None):
    """One aligned row as gap-string bytes: random gaps at ``rate``, or a
    gap every ``every`` columns, and optionally one long gap run."""
    row = np.full(n_cols, ord("A"), np.uint8)
    if every:
        row[every - 1::every] = ord("-")
    else:
        row[rng.random(n_cols) < rate] = ord("-")
    if long_gap is not None:
        row[long_gap[0]:long_gap[1]] = ord("-")
    row[0] = ord("A")
    return row.tobytes()


def _cigar(rng, budget, kind):
    """A CIGAR of at most ``budget`` reference units with indel runs (I+D
    adjacent), pass-through ops and clips."""
    cig = []
    if rng.random() < 0.3:
        cig.append((int(rng.integers(1, 4)), "S"))
    if rng.random() < 0.2:
        cig.insert(0, (int(rng.integers(1, 3)), "H"))
    used = 0
    for _ in range(int(rng.integers(1, 4))):
        m = int(rng.integers(2, 12))
        if used + m > budget:
            break
        cig.append((m, "=" if rng.random() < 0.7 else "M"))
        used += m
        r = rng.random()
        big = kind == "length"
        ni = int(rng.integers(1, 21 if big else 5))
        nd = int(rng.integers(1, 21 if big else 5))
        if used + nd + 2 > budget:
            break
        if r < 0.55:
            cig += [(ni, "I"), (nd, "D")] if rng.random() < 0.5 else [(nd, "D"), (ni, "I")]
            used += nd
        elif r < 0.65:
            cig += [(ni, "I"), (1, "P"), (nd, "D")]
            used += nd
        elif r < 0.75:
            cig.append((nd, "N"))
            used += nd
        elif r < 0.85:
            cig.append((ni, "I"))
        else:
            cig.append((nd, "D"))
            used += nd
    if not any(op in "M=XDN" for _, op in cig):
        cig.append((2, "="))
    if rng.random() < 0.3:
        cig.append((int(rng.integers(1, 4)), "S"))
    if kind == "count" and rng.random() < 0.5:
        cig.append((int(rng.choice([1 << 26, (1 << 26) + 3, 1 << 30])), "H"))
    return cig


def _case(kind: str, seed: int = 0, B: int = 96):
    """(JAX and port gap indexes, JAX and port event geometries, the
    staged batch, ref_flat, ref ids, run pad, slot pool) of one case."""
    rng = np.random.default_rng({"none": 1, "event": 2, "pool": 3, "length": 4,
                                 "count": 5, "deletion": 6}[kind] * 100 + seed)
    n_pairs, n_cols = 3, 1200
    if kind == "event":
        dsts = [_row(rng, n_cols, 0, every=4) for _ in range(n_pairs)]
    else:
        dsts = [_row(rng, n_cols, 0.03) for _ in range(n_pairs)]
    long_gap = (400, 720) if kind == "deletion" else None
    srcs = [_row(rng, n_cols, 0.03, long_gap=long_gap if p == 0 else None) for p in range(n_pairs)]
    rim = list(range(n_pairs))
    jh, jd, th, td = _geometries(srcs, dsts, rim)
    vectors = []
    for s, d in zip(srcs, dsts):
        vectors += [JaxGapBitVector.from_gap_string(s), JaxGapBitVector.from_gap_string(d)]
    jidx = jax_rs.DeviceGapIndex.build(vectors)
    tidx = DeviceGapIndex.build(
        [GapBitVector.from_state(**v.state()) for v in vectors], device="cpu"
    )
    # the output references: random bytes, some lower case and N
    ref_parts = []
    for d in dsts:
        nz = d.count(b"A")
        part = rng.choice(np.frombuffer(b"ACGTacgtN", np.uint8), nz, p=[0.22] * 4 + [0.02] * 4 + [0.04])
        ref_parts.append(part.astype(np.uint8))
    ref_offs = np.cumsum([0] + [len(p) for p in ref_parts[:-1]]).tolist()
    ref_flat = np.concatenate(ref_parts)

    cigars, positions, queries, pairs = [], [], [], []
    for i in range(B):
        p = int(rng.integers(0, n_pairs))
        nz = srcs[p].count(b"A")
        if kind == "deletion" and i % 4 == 0:
            p, pos = 0, int(rng.integers(330, 390))
            cig = [(30, "="), (2, "I"), (3, "D"), (20, "=")]
        else:
            pos = int(rng.integers(-2, nz - 60)) if i % 17 else int(rng.integers(nz - 40, nz))
            cig = _cigar(rng, 60 if kind != "event" else 90, kind)
        qlen = sum(n for n, op in cig if op in "M=XIS")
        cigars.append(cig)
        positions.append(pos)
        queries.append(rng.choice(LETTERS, qlen).tobytes())
        pairs.append(p)
    max_ops = max(len(c) for c in cigars)
    max_ref = max(sum(n for n, op in c if op in "M=XDN") for c in cigars)
    batch = expand_cigars(
        cigars, positions, queries,
        [2 * p for p in pairs], [2 * p + 1 for p in pairs], [ref_offs[p] for p in pairs],
        pad_ops=port_engine.next_pow2(max_ops),
        pad_ref_units=max(8, port_engine.next_pow2(max_ref)),
        pad_query=max(2, port_engine.next_pow2(max(len(q) for q in queries))),
    )
    run_pad = 16
    slot_pool = 8 if kind == "pool" else max(256, B // 2)
    return jidx, tidx, jd, td, batch, ref_flat, np.asarray(pairs, np.int32), run_pad, slot_pool


def _assert_equal(got, want, names, what):
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        g = g.numpy()
        assert g.dtype == w.dtype, (what, name, g.dtype, w.dtype)
        assert g.shape == w.shape, (what, name)
        assert np.array_equal(g, w), (what, name)


def _assert_flags(flags, kind, fires):
    """The flag a case is built to raise is set; no flag is set on the
    case built to raise none."""
    if kind == "none":
        assert not flags[:2].any(), flags
    elif kind in fires:
        assert flags[fires[kind]] > 0, (kind, flags)


CASES = ["none", "event", "pool", "length", "count", "deletion"]


@pytest.mark.parametrize("kind", CASES)
def test_fused_projection_kernel_matches_jax(kind):
    jidx, tidx, _, _, b, ref_flat, _, run_pad, slot_pool = _case(kind)
    R = b.pad_ref_units
    args = (ref_flat, b.src_seq, b.dst_seq, b.rec_src_pos, b.ref_off, b.ops, b.counts, b.query,
            np.float32(-6), np.float32(-1), R, R + b.ops.shape[1], run_pad, run_pad, slot_pool)
    want = [np.asarray(x) for x in jax_fused.fused_projection_kernel(jidx, *args)]
    got = fused.fused_projection_kernel(tidx, *args)
    flags = got[5].numpy()
    _assert_equal(got[5:], want[5:], ("flags", "d_run"), kind)
    _assert_equal([got[i] for i in (0, 1, 2)], [want[i] for i in (0, 1, 2)], V3_WIRE, kind)
    total_runs = int(flags[2])
    assert total_runs > 0
    if total_runs <= slot_pool:
        _assert_equal(got[3:5], want[3:5], ("realign_ops", "realign_counts"), kind)
    _assert_flags(flags, kind, {"pool": 0, "length": 0, "deletion": 1})


@pytest.mark.parametrize("kind", CASES)
def test_fused_event_body_matches_jax(kind):
    _, _, jd, td, b, ref_flat, ref_ids, run_pad, slot_pool = _case(kind)
    R = b.pad_ref_units
    args = (ref_flat, ref_ids, b.rec_src_pos, b.n_ref_units, b.ref_off, b.ops, b.counts, b.query,
            np.float32(-6), np.float32(-1))
    kw = dict(R=R, run_r=run_pad, run_q=run_pad, slot_pool=slot_pool)
    want = [np.asarray(x) for x in jax_make_fused_event_kernel(jd)(*args, **kw)]
    got = fused_event.make_fused_event_kernel(td)(*args, **kw)
    flags = got[7].numpy()
    _assert_equal(got[7:], want[7:], ("flags",), kind)
    _assert_equal(got[:5], want[:5], V4_WIRE, kind)
    if int(flags[2]) <= slot_pool:
        _assert_equal(got[5:7], want[5:7], ("realign_ops", "realign_counts"), kind)
    _assert_flags(flags, kind, {"event": 1, "pool": 0, "length": 0, "count": 0, "deletion": 1})
    if kind == "none":
        assert int(flags[2]) > 10


@pytest.mark.parametrize("kind", ["none", "deletion"])
def test_projection_step_matches_jax(kind):
    jidx, tidx, _, _, b, ref_flat, _, _, _ = _case(kind)
    rng = np.random.default_rng(3)
    B, run_r, run_q = b.src_seq.shape[0], 24, 16
    run_ref = rng.choice(LETTERS, (B, run_r)).astype(np.uint8)
    run_query = rng.choice(LETTERS, (B, run_q)).astype(np.uint8)
    rl = rng.integers(0, run_r + 1, B).astype(np.int32)
    ql = rng.integers(0, run_q + 1, B).astype(np.int32)
    run_ref[np.arange(run_r)[None, :] >= rl[:, None]] = 0
    run_query[np.arange(run_q)[None, :] >= ql[:, None]] = 0
    args = (ref_flat, b.src_seq, b.dst_seq, b.rec_src_pos, b.ref_off, b.ops, b.counts, b.query,
            run_ref, run_query, rl, ql, np.float32(-6), np.float32(-1))
    want = jax_projection_step(jidx, *args, R=b.pad_ref_units, run_r=run_r, run_q=run_q)
    got = projection_step(tidx, *args, R=b.pad_ref_units, run_r=run_r, run_q=run_q)
    _assert_equal(got, want, ("dst_pos", "d_run", "main_code", "ops", "counts", "stats"), kind)


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------


def _strip_pg(sam: bytes) -> bytes:
    return b"\n".join(ln for ln in sam.split(b"\n") if not ln.startswith(b"@PG"))


def _cfg(mod, index_path, ref_path, ranges, **kw):
    return mod.ProjectConfig(
        msa_index_path=str(index_path),
        reference_path=str(ref_path),
        reference_msa_id="REF",
        ref_id_separator="/",
        tags=mod.TagSpec(rec_idx="XI"),
        output_realigned_ranges_path=str(ranges),
        keep_duplicate_ranges=True,
        debugging_output=True,
        status_output_interval=0,
        **kw,
    )


def _jax_run(index_path, ref_path, sam, tmp_path, batch, **kw):
    """panvc3_tpu's SAM and ranges; with ``fused_kernel=True`` it runs its
    split path here (its fused lane needs its native build)."""
    ranges = tmp_path / "jax_ranges.tsv"
    out = io.BytesIO()
    jax_pa.run_project_alignments(
        io.BytesIO(sam), out,
        _cfg(jax_pa, index_path, ref_path, ranges, device_batch_size=batch, **kw),
    )
    return _strip_pg(out.getvalue()), ranges.read_text()


def _port_run(index_path, ref_path, sam, tmp_path, batch, tag, **kw):
    from panvc3_tpu_torch.pipeline import project_alignments as port

    ranges = tmp_path / f"port_{tag}.tsv"
    out = io.BytesIO()
    stats = port.run_project_alignments(
        io.BytesIO(sam), out,
        _cfg(port, index_path, ref_path, ranges, engine="device", device_batch_size=batch, **kw),
        device="cpu",
    )
    return _strip_pg(out.getvalue()), ranges.read_text(), stats


def _fused_against_references(index_path, ref_path, sam, tmp_path, monkeypatch, batch,
                              want=None, quality=False):
    """The port's fused lane against panvc3_tpu (``want``, else its host
    engine) and the port's own object path, SAM and ranges byte for byte;
    returns the route counts of the fused run."""
    monkeypatch.setenv("PANVC3_HOST_DP", "0")
    monkeypatch.setattr(port_engine.BatchProjector, "FUSED_RUN_PAD", 64)
    if want is None:
        want = _jax_run(index_path, ref_path, sam, tmp_path, batch, engine="host",
                        use_read_base_qualities=quality)
    obj_sam, obj_ranges, _ = _port_run(
        index_path, ref_path, sam, tmp_path, batch, "object", fastlane=False,
        use_read_base_qualities=quality,
    )
    got_sam, got_ranges, stats = _port_run(
        index_path, ref_path, sam, tmp_path, batch, "fused", fused_kernel=True,
        use_read_base_qualities=quality,
    )
    assert stats.matched_reads > 0 and stats.realigned_range_count > 0
    assert got_sam == want[0] and got_ranges == want[1]
    assert obj_sam == want[0] and obj_ranges == want[1]
    return dict(port_engine.FUSED_ROUTES)


@pytest.fixture(scope="module")
def indel_case(msa_files, founder_seqs, tmp_path_factory):  # noqa: F811
    """120 reads with I+D runs on the bundled MSA, and panvc3_tpu's output
    with ``fused_kernel=True`` (its split path here)."""
    index_path, _, _ = msa_files
    sam = _synthesise_indel_sam(founder_seqs, n_reads=120)
    want = _jax_run(index_path, GENOME, sam, tmp_path_factory.mktemp("jax"), 64,
                    engine="device", fused_kernel=True)
    return index_path, sam, want


@pytest.mark.parametrize("pallas_fused", ["1", "0"])
@pytest.mark.parametrize("fused_event", ["1", "0"])
@pytest.mark.parametrize("batch", [32, 64])
def test_fused_lane_matches_jax_and_object_path(indel_case, tmp_path, monkeypatch,
                                                 batch, fused_event, pallas_fused):
    """v4 (and v3 under PANVC3_FUSED_EVENT=0), with K1's plain version or
    the split route (PANVC3_PALLAS_FUSED=0), answer every batch by their
    own DP."""
    index_path, sam, want = indel_case
    monkeypatch.setenv("PANVC3_FUSED_EVENT", fused_event)
    monkeypatch.setenv("PANVC3_PALLAS_FUSED", pallas_fused)
    routes = _fused_against_references(
        index_path, GENOME, sam, tmp_path, monkeypatch, batch, want=want
    )
    n_batches = -(-120 // batch)
    if fused_event == "1":
        assert routes == {"v4_dp": n_batches, "v4_to_v3": 0, "v3": 0, "host_realign": 0}
    else:
        assert routes == {"v4_dp": 0, "v4_to_v3": 0, "v3": n_batches, "host_realign": 0}


def test_fused_lane_production_run_pad(indel_case, tmp_path, monkeypatch):
    """At the production run pad of 16 the toy MSA's projected runs are
    longer: their batches realign on the host path, with the same bytes."""
    index_path, sam, want = indel_case
    monkeypatch.setenv("PANVC3_HOST_DP", "0")
    got_sam, got_ranges, _ = _port_run(index_path, GENOME, sam, tmp_path, 64, "pad16",
                                       fused_kernel=True)
    assert (got_sam, got_ranges) == want
    assert port_engine.FUSED_ROUTES["host_realign"] > 0


def _single_chr_msa(tmp_path, ref_aligned, founder_aligned):
    """An index of one chromosome ``test`` with rows REF and 1, and the
    REF FASTA."""
    from panvc3_tpu.msa_index import ChrEntry, MsaIndex, SequenceEntry

    index = MsaIndex()
    ce = ChrEntry("test")
    ce.sequence_entries = sorted(
        [
            SequenceEntry("REF", JaxGapBitVector.from_gap_string(ref_aligned.tobytes())),
            SequenceEntry("1", JaxGapBitVector.from_gap_string(founder_aligned.tobytes())),
        ],
        key=lambda e: e.seq_id,
    )
    index.chr_entries.append(ce)
    index.sort()
    index_path = tmp_path / "msa.npz"
    index.save(str(index_path))
    ref_path = tmp_path / "ref.fa"
    ref_path.write_bytes(b">test\n" + ref_aligned.tobytes().replace(b"-", b"") + b"\n")
    return index_path, ref_path


def test_event_overflow_redispatches_v3(tmp_path, monkeypatch):
    """Reads overlapping more gap events than v4's slots re-dispatch
    through v3 (test_engine.py's overflow case)."""
    rng = np.random.default_rng(9)
    base = rng.choice(LETTERS, 1024)
    ref_aligned = base.copy()
    ref_aligned[7::8] = ord("-")  # a destination gap run every 8 columns
    index_path, ref_path = _single_chr_msa(tmp_path, ref_aligned, base.copy())
    founder = base.tobytes()
    lines = ["@HD\tVN:1.6", f"@SQ\tSN:test/1\tLN:{len(founder)}"]
    for i, pos in enumerate((10, 200, 400)):
        seq = (founder[pos:pos + 50] + b"AC" + founder[pos + 53:pos + 103]).decode()
        lines.append(f"r{i}\t0\ttest/1\t{pos + 1}\t60\t50=2I3D50=\t*\t0\t0\t{seq}\t{'I' * len(seq)}")
    sam = ("\n".join(lines) + "\n").encode()
    routes = _fused_against_references(index_path, ref_path, sam, tmp_path, monkeypatch, 64)
    assert routes["v4_to_v3"] == 1 and routes["v3"] == 1 and routes["v4_dp"] == 0


def test_clips_and_passthrough_ops(msa_files, founder_seqs, tmp_path, monkeypatch):  # noqa: F811
    """Pass-through ops (S/H/P/I) around and inside indel runs
    (test_engine.py's clip case), v4 answering."""
    index_path, _, _ = msa_files
    stripped = {sid: s.replace(b"-", b"") for sid, s in founder_seqs.items()}
    rng = np.random.default_rng(31)
    lines = ["@HD\tVN:1.6"] + [f"@SQ\tSN:test/{sid}\tLN:{len(fs)}" for sid, fs in stripped.items()]
    names = [s for s in stripped if s != "REF"]
    for i in range(80):
        sid = names[int(rng.integers(len(names)))]
        s = stripped[sid]
        pos = int(rng.integers(0, len(s) - 160))
        kind = i % 5
        if kind == 0:
            sc1, sc2 = int(rng.integers(1, 8)), int(rng.integers(1, 8))
            seq = (rng.choice(LETTERS, sc1).tobytes() + s[pos:pos + 30] + rng.choice(LETTERS, 3).tobytes()
                   + s[pos + 33:pos + 63] + rng.choice(LETTERS, sc2).tobytes())
            cigar = f"{sc1}S30=3I3D30={sc2}S"
        elif kind == 1:
            seq = s[pos:pos + 25] + rng.choice(LETTERS, 2).tobytes() + s[pos + 29:pos + 54]
            cigar = "4H25=2I4D25=6H"
        elif kind == 2:
            seq = s[pos:pos + 25] + rng.choice(LETTERS, 2).tobytes() + s[pos + 27:pos + 52]
            cigar = "25=2I1P2D25="
        elif kind == 3:
            sc = int(rng.integers(1, 10))
            seq = rng.choice(LETTERS, sc).tobytes() + s[pos:pos + 60]
            cigar = f"{sc}S60="
        else:
            seq = (s[pos:pos + 20] + rng.choice(LETTERS, 2).tobytes() + s[pos + 22:pos + 42]
                   + rng.choice(LETTERS, 3).tobytes() + s[pos + 46:pos + 66])
            cigar = "20=2I2D20=3I4D20="
        lines.append(f"c{i}\t0\ttest/{sid}\t{pos + 1}\t60\t{cigar}\t*\t0\t0\t{seq.decode()}\t{'I' * len(seq)}")
    sam = ("\n".join(lines) + "\n").encode()
    routes = _fused_against_references(index_path, GENOME, sam, tmp_path, monkeypatch, 32)
    assert routes["v4_dp"] == 3 and routes["v4_to_v3"] == 0


def test_zero_width_boundary_on_passthrough_op(tmp_path, monkeypatch):
    """A destination gap run ending just before a pass-through op (an I, a
    trailing S) makes a zero-length segment owned by the op, which v4 must
    not emit twice (test_engine.py's regression case); v4 answers."""
    rng = np.random.default_rng(17)
    base = rng.choice(LETTERS, 512)
    ref_aligned = base.copy()
    for a, b_ in ((10, 12), (100, 102), (218, 220)):
        ref_aligned[a:b_] = ord("-")
    index_path, ref_path = _single_chr_msa(tmp_path, ref_aligned, base.copy())
    f = base.tobytes()
    lines = ["@HD\tVN:1.6", f"@SQ\tSN:test/1\tLN:{len(f)}"]
    for i, pos in enumerate((10, 100)):
        seq = (f[pos:pos + 2] + b"A" + f[pos + 4:pos + 24]).decode()
        lines.append(f"r{i}\t0\ttest/1\t{pos + 1}\t60\t2=1I2D20=\t*\t0\t0\t{seq}\t{'I' * len(seq)}")
    seq2 = (f[200:220] + b"AC").decode()
    lines.append(f"r2\t0\ttest/1\t201\t60\t20=2S\t*\t0\t0\t{seq2}\t{'I' * len(seq2)}")
    sam = ("\n".join(lines) + "\n").encode()
    routes = _fused_against_references(index_path, ref_path, sam, tmp_path, monkeypatch, 16)
    assert routes == {"v4_dp": 1, "v4_to_v3": 0, "v3": 0, "host_realign": 0}


@pytest.fixture(scope="module")
def boundary_case(tmp_path_factory):
    """The gap-boundary enumeration of test_fused_boundary_fuzz.py."""
    from .test_fused_boundary_fuzz import _build_case_msa, _reads_for_cases

    tmp = tmp_path_factory.mktemp("boundary")
    rng = np.random.default_rng(20260820)
    founder_aligned, ref_aligned, cases = _build_case_msa(rng)
    index_path, ref_path = _single_chr_msa(tmp, ref_aligned, founder_aligned)
    f_len = int((founder_aligned != ord("-")).sum())
    lines = ["@HD\tVN:1.6", f"@SQ\tSN:test/1\tLN:{f_len}"]
    lines += _reads_for_cases(founder_aligned, cases, rng)
    return index_path, ref_path, ("\n".join(lines) + "\n").encode(), len(cases)


@pytest.mark.parametrize("quality", [False, True], ids=["int", "q"])
def test_boundary_enumeration(boundary_case, tmp_path, monkeypatch, quality):
    """Every gap-row, gap-length, offset and clip combination: v4 answers
    every batch (under -q the fused lane gates itself off)."""
    index_path, ref_path, sam, n_cases = boundary_case
    routes = _fused_against_references(
        index_path, ref_path, sam, tmp_path, monkeypatch, 32, quality=quality
    )
    n_batches = -(-n_cases // 32)
    if quality:
        assert not any(routes.values())
    else:
        assert routes == {"v4_dp": n_batches, "v4_to_v3": 0, "v3": 0, "host_realign": 0}


def test_cli_engine_lane_fused(msa_files, founder_seqs, tmp_path):  # noqa: F811
    """``PANVC3_ENGINE_LANE=fused python -m panvc3_tpu_torch
    project_alignments --device cpu`` runs the fused lane through the
    arbiter and gives panvc3_tpu's output."""
    from .test_fastpath import _rich_sam
    from .test_torch_fastlane import _jax_host

    index_path, _, _ = msa_files
    sam = _rich_sam(founder_seqs)
    want, want_ranges = _jax_host(sam, index_path, GENOME, tmp_path)
    (tmp_path / "in.sam").write_bytes(sam)
    proc = subprocess.run(
        [
            sys.executable, "-m", "panvc3_tpu_torch", "project_alignments",
            "--device", "cpu", "-a", str(tmp_path / "in.sam"), "-m", str(index_path),
            "-r", GENOME, "-d", "REF", "-s", "/", "--record-index-tag", "XI", "-t", "XA",
            "--device-batch-size", "32", "--status-output-interval", "0",
            "-l", str(tmp_path / "ranges.tsv"), "-o", str(tmp_path / "out.sam"),
        ],
        env=dict(os.environ, PYTHONPATH=REPO, PANVC3_ENGINE_LANE="fused",
                 PANVC3_FASTLANE_PROF="1"),
        capture_output=True, timeout=300, cwd=REPO,
    )
    err = proc.stderr.decode()
    assert proc.returncode == 0, err
    assert _strip_pg((tmp_path / "out.sam").read_bytes()) == _strip_pg(want)
    assert (tmp_path / "ranges.tsv").read_text() == want_ranges
    # the object path ran the fused lane (no fast-lane diag line)
    assert "[fused routes]" in err and "[fastlane diag]" not in err


# ---------------------------------------------------------------------------
# the arbiter
# ---------------------------------------------------------------------------


def test_choose_engine_lane(monkeypatch):
    monkeypatch.delenv("PANVC3_ENGINE_LANE", raising=False)
    # a device other than CUDA takes the split lane, whatever the host
    assert port_engine.choose_engine_lane("cpu", host_cores=1, d2h_mbps=1000.0) == "split"
    # the rule proper on a CUDA device (the probe's figure given)
    assert port_engine.choose_engine_lane("cuda", host_cores=4) == "split"
    assert port_engine.choose_engine_lane("cuda", host_cores=2, d2h_mbps=1000.0) == "fused"
    assert port_engine.choose_engine_lane("cuda", host_cores=2, d2h_mbps=10.0) == "split"
    # with 2 cores and no figure, the probe decides
    calls = []
    monkeypatch.setattr(port_engine, "probe_d2h_mbps", lambda dev: calls.append(dev) or 500.0)
    assert port_engine.choose_engine_lane("cuda", host_cores=2) == "fused"
    assert calls == ["cuda"]
    # the forced lane comes first
    for lane in ("fused", "split"):
        monkeypatch.setenv("PANVC3_ENGINE_LANE", lane)
        assert port_engine.choose_engine_lane("cpu", host_cores=16) == lane
        assert port_engine.choose_engine_lane("cuda", host_cores=1, d2h_mbps=0.0) == lane


def test_probe_d2h_mbps_on_cpu():
    """The probe's three stages run on any device and give a rate."""
    assert port_engine.probe_d2h_mbps("cpu", size=1 << 20) >= 0.0


def test_arbiter_forces_fused_and_keeps_bytes(indel_case, tmp_path, monkeypatch):
    """PANVC3_ENGINE_LANE=fused moves the run from the fast lane to the
    fused lane without changing a byte; PANVC3_ENGINE_AUTO=0 skips the
    arbiter."""
    from panvc3_tpu_torch.pipeline import fastlane

    index_path, sam, want = indel_case
    calls = []
    real = fastlane.run_fast
    monkeypatch.setattr(fastlane, "run_fast", lambda *a: calls.append("fast") or real(*a))
    split = _port_run(index_path, GENOME, sam, tmp_path, 64, "split")
    monkeypatch.setenv("PANVC3_ENGINE_LANE", "fused")
    fused_run = _port_run(index_path, GENOME, sam, tmp_path, 64, "forced")
    assert calls == ["fast"] and sum(port_engine.FUSED_ROUTES.values()) > 0
    assert split[:2] == fused_run[:2] == want
    monkeypatch.setenv("PANVC3_ENGINE_AUTO", "0")
    _port_run(index_path, GENOME, sam, tmp_path, 64, "auto0")
    assert calls == ["fast", "fast"] and not any(port_engine.FUSED_ROUTES.values())


def test_arbiter_not_consulted_under_q(indel_case, tmp_path, monkeypatch):
    index_path, sam, _ = indel_case

    def boom(*a, **kw):
        raise AssertionError("choose_engine_lane consulted under -q")

    monkeypatch.setattr(port_engine, "choose_engine_lane", boom)
    _, _, stats = _port_run(index_path, GENOME, sam, tmp_path, 64, "q",
                            use_read_base_qualities=True)
    assert stats.realigned_range_count > 0
    # and not when the caller chose the fused lane itself
    _port_run(index_path, GENOME, sam, tmp_path, 64, "chosen", fused_kernel=True)


# ---------------------------------------------------------------------------
# chip_smoke.py's fused phase, rehearsed on the CPU
# ---------------------------------------------------------------------------

_REHEARSAL = r"""
import pathlib, sys

def run(work):
    import chip_smoke
    from panvc3_tpu_torch import synth

    n_reads = 2048
    rows = synth.make_msa(200_000, seed=5)
    index_path, fasta_path, founders = synth.write_inputs(work, "chr21", rows)
    sam_path = work / "reads.sam"
    sam_path.write_bytes(synth.reads_sam("chr21", founders, n_reads, 6))
    tool = chip_smoke.Tool("cpu rehearsal", work, index_path, fasta_path, device="cpu")
    dev_sam, *_ = tool.run("int-device", {"PANVC3_HOST_DP": "0"}, sam_path, expect=n_reads)
    used = {"realign_fused_int": 0, "realign_fill_sub": 0, "realign_traceback": 0}
    routes = chip_smoke.phase_fused(tool, sam_path, dev_sam, used, n_reads=512, batch=64)
    # no card: no launch
    assert used == {"realign_fused_int": 0, "realign_fill_sub": 0, "realign_traceback": 0}
    assert routes["fused-b-even"]["v4_dp"] > 0, routes
    assert routes["fused-c-v3"]["v3"] > 0, routes
    assert not any(m == "jax" or m.startswith(("jax.", "panvc3_tpu.")) for m in sys.modules)
    print("REHEARSAL_OK", routes)

if __name__ == "__main__":
    run(pathlib.Path(sys.argv[1]))
"""


def test_chip_smoke_fused_phase_on_cpu(tmp_path):
    """Phase 9 of ``chip_smoke.py`` (the fused engines through the CLI, four
    rows) at a small size with ``--device cpu``, in a process of its own
    as on the card; every comparison it makes there is made here."""
    script = tmp_path / "rehearse_phase9.py"
    script.write_text(_REHEARSAL)
    work = tmp_path / "work"
    work.mkdir()
    env = {k: v for k, v in os.environ.items() if not k.startswith("PANVC3_")}
    proc = subprocess.run(
        [sys.executable, str(script), str(work)],
        env=dict(env, PYTHONPATH=REPO), capture_output=True, timeout=600, cwd=str(tmp_path),
    )
    out = proc.stdout.decode()
    assert proc.returncode == 0, (out[-3000:], proc.stderr.decode()[-3000:])
    assert "REHEARSAL_OK" in out and "[fused] fused-d-split-route" in out
