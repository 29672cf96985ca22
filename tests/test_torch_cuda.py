"""Card-only tests of the port: the CUDA kernels against their plain versions.

Every test here needs an NVIDIA GPU and ``nvcc`` and skips without them.
The module imports no JAX, so on a machine with a card and no JAX it runs
without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q
"""

from __future__ import annotations

import io
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from chip_smoke import K1_EDGE_SHAPES, K2_EDGE_SHAPES, k2_edge_lengths

pytestmark = pytest.mark.cuda

# the split route's kernels (PANVC3_PALLAS_FUSED=0): K2's fill, then the
# traceback
_SPLIT_ROUTE = {"realign_fill_sub", "realign_traceback"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc for the hand-written kernel")
    return torch.device("cuda")


# K1's shapes: a few of the main path's and, at go -6 ge -1, the edges of
# its schedule (chip_smoke.K1_EDGE_SHAPES: each query bucket's lanes per
# run and rows per lane, R on both sides of Q, several strips, the
# global-scratch branch, B not a multiple of the runs per block)
_K1_SHAPES = [
    (300, 16, 16, -6, -1),
    (4096, 48, 48, 0, -1),
    (512, 128, 128, -6, -1),
    (33, 7, 29, -3, -2),
    (1, 1, 1, 0, -1),
] + [(B, Q, R, -6, -1) for B, Q, R in K1_EDGE_SHAPES]


def _check_scratch(mode: int, R: int, Q: int) -> None:
    """Only the 400x400 edge shape's tiles overflow shared memory."""
    from panvc3_tpu_torch.ops import _kernels

    words = _kernels.kernel("realign_fused_scratch")(R, Q, mode)
    assert (words > 0) == (Q == R == 400)


def _runs(rng, B, Q, R):
    letters = np.frombuffer(b"ACGT", np.uint8)
    ref = rng.choice(letters, (B, R)).astype(np.uint8)
    qry = rng.choice(letters, (B, Q)).astype(np.uint8)
    n = rng.integers(0, R + 1, B).astype(np.int32)
    m = rng.integers(0, Q + 1, B).astype(np.int32)
    if B >= 3:
        n[:3] = [0, R, R]
        m[:3] = [Q, 0, Q]
    return [torch.from_numpy(a) for a in (ref, qry, m, n)]


@pytest.mark.parametrize("B,Q,R,go,ge", _K1_SHAPES)
def test_kernel_matches_plain_version(cuda, B, Q, R, go, ge):
    from panvc3_tpu_torch.ops import _kernels
    from panvc3_tpu_torch.ops import realign_pallas_fused as rpf

    args = [t.to(cuda) for t in _runs(np.random.default_rng(B + Q + R), B, Q, R)]
    _check_scratch(0, R, Q)
    before = _kernels.LAUNCHES["realign_fused_int"]
    ops, cnt = rpf.realign_fused(*args, go, ge, R, Q)
    assert _kernels.LAUNCHES["realign_fused_int"] == before + 1
    want_ops, want_cnt = rpf.realign_fused_reference(*args, go, ge, R, Q)
    torch.cuda.synchronize()
    assert torch.equal(ops, want_ops)
    assert torch.equal(cnt, want_cnt)


_MALDE = 256.0  # panvc3_tpu.align.MALDE_SCALE


@pytest.mark.parametrize("B,Q,R,go,ge", _K1_SHAPES)
@pytest.mark.parametrize("mode", ["qual", "sub"])
def test_quality_entries_match_plain_version(cuda, mode, B, Q, R, go, ge):
    from panvc3_tpu_torch.ops import _kernels
    from panvc3_tpu_torch.ops import realign_batch as trb
    from panvc3_tpu_torch.ops import realign_pallas_fused as rpf

    rng = np.random.default_rng(B + Q + R + 1)
    args = [t.to(cuda) for t in _runs(rng, B, Q, R)]
    # phreds 0..63: the staged range 0..41 and the rest of the 6-bit wire's
    qq = torch.from_numpy(rng.integers(0, 64, (B, Q)).astype(np.int32)).to(cuda)
    if mode == "qual":
        kw = {"qual": (qq, *trb.malde_rows(cuda))}
    else:
        rq = torch.from_numpy(rng.integers(0, 42, (B, R)).astype(np.int32)).to(cuda)
        kw = {"sub": trb._substitution_scores(args[0], args[1], rq, qq.clamp(max=41), True)}
    _check_scratch(["int", "qual", "sub"].index(mode), R, Q)
    name = f"realign_fused_{mode}"
    before = _kernels.LAUNCHES[name]
    ops, cnt = rpf.realign_fused(*args, go * _MALDE, ge * _MALDE, R, Q, **kw)
    assert _kernels.LAUNCHES[name] == before + 1
    want_ops, want_cnt = rpf.realign_fused_reference(*args, go * _MALDE, ge * _MALDE, R, Q, **kw)
    torch.cuda.synchronize()
    assert torch.equal(ops, want_ops)
    assert torch.equal(cnt, want_cnt)


# K2's shapes: a few of the split route's and the edges of its schedule
# (chip_smoke.K2_EDGE_SHAPES: every chunk boundary, R on both sides of Q,
# long queries, one run, B not a multiple of the runs per block, the
# global-scratch branch)
@pytest.mark.parametrize(
    "B,Q,R",
    [(300, 16, 16), (4096, 48, 48), (256, 128, 128), (40, 24, 48), (33, 7, 29), (1, 1, 1)]
    + K2_EDGE_SHAPES,
)
@pytest.mark.parametrize("scores", ["integer", "malde"])
def test_fill_kernel_matches_plain_version(cuda, scores, B, Q, R):
    """K2: every trace cell, rows past m and columns past n included, with
    runs of m = 0, n = 0, m > Q and n > R."""
    from panvc3_tpu_torch.ops import _kernels
    from panvc3_tpu_torch.ops import realign_batch as trb
    from panvc3_tpu_torch.ops.realign_pallas import fill_batch

    rng = np.random.default_rng(B * 7 + Q + R)
    ref, qry = [t.to(cuda) for t in _runs(rng, B, Q, R)[:2]]
    m, n = (torch.from_numpy(a).to(cuda) for a in k2_edge_lengths(rng, B, Q, R))
    if scores == "integer":
        sub, go, ge = trb._substitution_scores(ref, qry), 0.0, -1.0
    else:
        qq = torch.from_numpy(rng.integers(0, 42, (B, Q)).astype(np.int32)).to(cuda)
        rq = torch.from_numpy(rng.integers(0, 42, (B, R)).astype(np.int32)).to(cuda)
        sub = trb._substitution_scores(ref, qry, rq, qq, True)
        go, ge = -6 * _MALDE, -1 * _MALDE
    before = _kernels.LAUNCHES["realign_fill_sub"]
    got = fill_batch(sub, m, n, go, ge, R, Q)
    assert _kernels.LAUNCHES["realign_fill_sub"] == before + 1
    want = trb._fill_batch(sub, m, n, go, ge, R, Q)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_kernel_rejects_mixed_devices(cuda):
    from panvc3_tpu_torch.ops.realign_pallas_fused import realign_fused

    ref, qry, m, n = _runs(np.random.default_rng(0), 8, 8, 8)
    with pytest.raises(ValueError, match="is on"):
        realign_fused(ref.to(cuda), qry.to(cuda), m, n.to(cuda), 0, -1, 8, 8)


@pytest.mark.parametrize("wire", ["classic", "refgather", "refgather2"])
@pytest.mark.parametrize("route", ["fused", "split"])
@pytest.mark.parametrize("quality", [False, True], ids=["int", "q"])
def test_wires_on_card_match_cpu(cuda, monkeypatch, wire, quality, route):
    from panvc3_tpu_torch.ops import realign_batch as trb

    monkeypatch.setenv("PANVC3_PALLAS_FUSED", "1" if route == "fused" else "0")
    rng = np.random.default_rng(3)
    S, R, Q = 2000, 48, 48
    rl = rng.integers(0, R + 1, S).astype(np.int32)
    ql = rng.integers(0, Q + 1, S).astype(np.int32)
    qry = rng.choice(np.frombuffer(b"ACGT", np.uint8), (S, Q)).astype(np.uint8)
    qry = np.where(np.arange(Q)[None, :] < ql[:, None], qry, 0).astype(np.uint8)
    qq = np.where(np.arange(Q)[None, :] < ql[:, None], rng.integers(0, 42, (S, Q)), 0).astype(np.uint8)
    flat = torch.from_numpy(rng.choice(np.frombuffer(b"ACGTacgtNn", np.uint8), 9000))
    start = rng.integers(0, 9000, S).astype(np.int64)
    go, ge = (0.0, -1.0 * _MALDE) if quality else (0.0, -1.0)
    q = "_q" if quality else ""
    extra = (qq,) if quality else ()
    if wire == "classic":
        ref = rng.choice(np.frombuffer(b"ACGTN", np.uint8), (S, R)).astype(np.uint8)
        ref = np.where(np.arange(R)[None, :] < rl[:, None], ref, 0).astype(np.uint8)
        packed = torch.from_numpy(getattr(trb, f"pack_realign_wire_input{q}")(ref, qry, rl, ql, *extra))
        fn = getattr(trb, f"_realign_wire{q}")
        run = lambda p, f: fn(p, go, ge, R, Q)  # noqa: E731
    else:
        kind = "" if wire == "refgather" else "2"
        pack = getattr(trb, f"pack_realign_refgather{kind}_input{q}")
        packed = torch.from_numpy(pack(qry, start, rl, ql, *extra))
        fn = getattr(trb, f"_realign_wire_refgather{kind}{q}")
        run = lambda p, f: fn(p, f, go, ge, R, Q)  # noqa: E731
    got = run(packed.to(cuda), flat.to(cuda)).cpu()
    want = run(packed, flat)
    assert torch.equal(got, want)


@pytest.mark.parametrize(
    "quality,env,entries",
    [
        (False, {}, {"realign_fused_int"}),
        (False, {"PANVC3_FASTLANE_CHAOS": "5"}, {"realign_fused_int"}),
        (True, {}, {"realign_fused_qual"}),
        (True, {"PANVC3_PALLAS_FUSED": "0"}, _SPLIT_ROUTE),
        (False, {"PANVC3_PALLAS_FUSED": "0"}, _SPLIT_ROUTE),
    ],
    ids=["int", "int-chaos", "q", "q-split", "int-split"],
)
def test_slice_on_card_matches_cpu(cuda, tmp_path, monkeypatch, quality, env, entries):
    """The whole fast lane on the device lane, card vs CPU: pinned
    copies, events and the fetch pool on the card path, with integer and
    quality scoring, on K1 and on the split route, also under scheduling
    jitter at every cross-thread handoff.  The split route launches K2
    and the traceback kernel, once each per dispatch."""
    from panvc3_tpu_torch import synth
    from panvc3_tpu_torch.ops import _kernels
    from panvc3_tpu_torch.pipeline import fastlane
    from panvc3_tpu_torch.pipeline.project_alignments import (
        ProjectConfig,
        run_project_alignments,
    )

    rows = synth.make_msa(300_000, seed=5)
    index_path, fasta_path, founders = synth.write_inputs(tmp_path, "c1", rows)
    sam = synth.reads_sam("c1", founders, 6000, seed=6, qualities=quality)
    monkeypatch.setenv("PANVC3_HOST_DP", "0")
    outs = {}
    for dev in ("cpu", "cuda"):
        if dev == "cuda":
            for key, val in env.items():
                monkeypatch.setenv(key, val)
        cfg = ProjectConfig(
            msa_index_path=str(index_path), reference_path=str(fasta_path),
            reference_msa_id="REF", ref_id_separator="/", engine="device",
            device_batch_size=1024, status_output_interval=0,
            use_read_base_qualities=quality,
        )
        before = (dict(_kernels.LAUNCHES), fastlane.AGG_DIAG["wire2"])
        out = io.BytesIO()
        run_project_alignments(io.BytesIO(sam), out, cfg, device=dev)
        outs[dev] = out.getvalue()
        launched = {k: v - before[0][k] for k, v in _kernels.LAUNCHES.items()}
        assert fastlane.AGG_DIAG["wire2"] > before[1]
        if dev == "cuda":
            assert {k for k, v in launched.items() if v} == entries, launched
        else:
            assert not any(launched.values()), launched
    assert outs["cuda"] == outs["cpu"]


# -- the device gap index, the gap kernel, the device event geometry and the
# object path: plain PyTorch, the same function on the card as on the CPU

def _gap_rows(rng, n, rate):
    s = np.where(rng.random(n) < rate, ord("-"), ord("A")).astype(np.uint8)
    s[0] = ord("A")
    return s.tobytes()


@pytest.mark.parametrize("select,rank", [(None, None), (False, None), (None, False), (False, False)])
def test_gap_index_queries_on_card_match_cpu(cuda, select, rank):
    """Every query at positions, ranks and sequence ids past each end (the
    gathers clamp as XLA's do)."""
    from panvc3_tpu_torch.bitvec import GapBitVector
    from panvc3_tpu_torch.ops.rank_select import DeviceGapIndex

    rng = np.random.default_rng(7)
    vectors = [GapBitVector.from_gap_string(_gap_rows(rng, n, 0.3)) for n in (33, 64, 500, 70_000)]
    idx = {d: DeviceGapIndex.build(vectors, select, rank, device=d) for d in ("cpu", cuda)}
    assert idx[cuda].words.device.type == "cuda"
    B = 4096
    seq = torch.from_numpy(rng.integers(-2, 6, B).astype(np.int32))
    pos = torch.from_numpy(rng.integers(-40, 70_040, B).astype(np.int32))
    k = torch.from_numpy(rng.integers(-5, 50_000, B).astype(np.int32))
    for name, arg in (("rank0", pos), ("bit", pos), ("select0", k)):
        want = getattr(idx["cpu"], name)(seq, arg)
        assert torch.equal(getattr(idx[cuda], name)(seq.to(cuda), arg.to(cuda)).cpu(), want), name
    for g, w in zip(idx[cuda].rank0_and_bit(seq.to(cuda), pos.to(cuda)), idx["cpu"].rank0_and_bit(seq, pos)):
        assert torch.equal(g.cpu(), w)
    for R in (128, 5000):
        want = idx["cpu"].select0_consecutive(seq[:64], k[:64], R)
        assert torch.equal(idx[cuda].select0_consecutive(seq[:64].to(cuda), k[:64].to(cuda), R).cpu(), want)


@pytest.mark.parametrize("cause", ["none", "R>255", "long-deletion", "many-deletions"])
def test_gap_wire_on_card_matches_cpu(cuda, cause):
    from panvc3_tpu_torch.bitvec import GapBitVector
    from panvc3_tpu_torch.ops import rewrite_batch as rb
    from panvc3_tpu_torch.ops.rank_select import DeviceGapIndex

    rng = np.random.default_rng(len(cause))
    src = np.frombuffer(_gap_rows(rng, 900, 0.02), np.uint8).copy()
    if cause == "long-deletion":
        src[300:600] = ord("-")
    elif cause == "many-deletions":
        src[200:500:3] = ord("-")
    dst = _gap_rows(rng, 900, 0.02)
    vectors = [GapBitVector.from_gap_string(r) for r in (src.tobytes(), dst)]
    R = 256 if cause == "R>255" else 64
    B = 8192
    pos = rng.integers(-3, 520, B).astype(np.int32)
    pos[:6] = [150, 180, 250, 290, 0, -1]
    n_units = rng.integers(0, min(R, 255) + 1, B).astype(np.int32)
    packed = rb.pack_gap_wire_input(pos, n_units, np.zeros(B, np.int32), np.ones(B, np.int32))
    out = {}
    for d in ("cpu", cuda):
        index = DeviceGapIndex.build(vectors, device=d)
        out[d] = [t.cpu() for t in rb.rewrite_gap_kernel_wire(index, torch.from_numpy(packed).to(d), R)]
    for g, w in zip(out[cuda], out["cpu"]):
        assert torch.equal(g, w)
    assert (int(out["cpu"][1]) > 0) == (cause != "none")


@pytest.mark.parametrize("buckets", ["1", "0"])
def test_device_event_wire_on_card_matches_cpu(cuda, monkeypatch, buckets):
    from panvc3_tpu_torch.bitvec import GapBitVector
    from panvc3_tpu_torch.msa_index import SequenceEntry
    from panvc3_tpu_torch.ops.event_geometry import DeviceEventGeometry, EventGeometry

    monkeypatch.setenv("PANVC3_EVENT_BUCKETS", buckets)
    rng = np.random.default_rng(11)
    entries = [
        SequenceEntry(str(i), GapBitVector.from_gap_string(_gap_rows(rng, 400_000, 0.02)))
        for i in range(3)
    ]
    host = EventGeometry(entries, [entries[0]], [0, 0, 0])
    B, R = 8192, 128
    ref_ids = rng.integers(0, 3, B).astype(np.int32)
    nz = np.asarray([entries[r].gaps.n_zeros for r in ref_ids])
    pos = rng.integers(-5, nz + 6).astype(np.int32)
    n_units = rng.integers(0, 101, B).astype(np.int32)
    out = {}
    for d in ("cpu", cuda):
        geo = DeviceEventGeometry(host, d)
        out[d] = [t.cpu() for t in geo.kernel_wire(*(torch.from_numpy(a).to(d) for a in (ref_ids, pos, n_units)), R)]
    assert geo.post_tab.device.type == "cuda"
    for g, w in zip(out[cuda], out["cpu"]):
        assert torch.equal(g, w)


@pytest.mark.parametrize(
    "quality,fastlane,geometry,entry",
    [
        (False, False, "1", "realign_fused_int"),
        (True, False, "1", "realign_fused_qual"),
        (False, True, "0", "realign_fused_int"),
        (False, True, "device", "realign_fused_int"),
    ],
    ids=["object-int", "object-q", "fastlane-gap-kernel", "fastlane-device-events"],
)
def test_device_geometry_paths_on_card_match_cpu(cuda, tmp_path, monkeypatch, quality, fastlane, geometry, entry):
    """The object path (a batch through BatchProjector: the gap kernel, the
    host finalize, K1) and the fast lane's two device geometry routes,
    card vs CPU."""
    from panvc3_tpu_torch import synth
    from panvc3_tpu_torch.ops import _kernels
    from panvc3_tpu_torch.pipeline.project_alignments import (
        ProjectConfig,
        run_project_alignments,
    )

    rows = synth.make_msa(300_000, seed=5)
    index_path, fasta_path, founders = synth.write_inputs(tmp_path, "c1", rows)
    sam = synth.reads_sam("c1", founders, 3000, seed=6, qualities=quality)
    monkeypatch.setenv("PANVC3_HOST_DP", "0")
    monkeypatch.setenv("PANVC3_EVENT_GEOMETRY", geometry)
    outs = {}
    for dev in ("cpu", "cuda"):
        cfg = ProjectConfig(
            msa_index_path=str(index_path), reference_path=str(fasta_path),
            reference_msa_id="REF", ref_id_separator="/", engine="device",
            device_batch_size=1024, status_output_interval=0,
            use_read_base_qualities=quality, fastlane=fastlane,
        )
        before = dict(_kernels.LAUNCHES)
        out = io.BytesIO()
        run_project_alignments(io.BytesIO(sam), out, cfg, device=dev)
        outs[dev] = out.getvalue()
        launched = {k: v - before[k] for k, v in _kernels.LAUNCHES.items()}
        if dev == "cuda":
            assert {k for k, v in launched.items() if v} == {entry}, launched
        else:
            assert not any(launched.values()), launched
    assert outs["cuda"] == outs["cpu"]


# -- BAM on the device lane, and the tools beside a live CUDA context


@pytest.mark.parametrize("quality,entry", [(False, "realign_fused_int"), (True, "realign_fused_qual")], ids=["int", "q"])
def test_bam_in_and_out_on_card_matches_sam_run(cuda, tmp_path, monkeypatch, quality, entry):
    """project_alignments -B -b on the device lane: the records read back
    from its BAM are the lines of the SAM run, and K1 launched."""
    from panvc3_tpu_torch import synth
    from panvc3_tpu_torch.cli.main import main
    from panvc3_tpu_torch.io.sam import SamReader, SamWriter
    from panvc3_tpu_torch.ops import _kernels

    rows = synth.make_msa(300_000, seed=5)
    index_path, fasta_path, founders = synth.write_inputs(tmp_path, "c1", rows)
    sam_path = tmp_path / "in.sam"
    sam_path.write_bytes(synth.reads_sam("c1", founders, 6000, seed=6, qualities=quality))
    reader = SamReader(str(sam_path))
    writer = SamWriter(str(tmp_path / "in.bam"), reader.header, bam=True)
    for block in reader.raw_record_line_blocks():
        writer.write_raw(b"".join(block))
    writer.close()
    monkeypatch.setenv("PANVC3_HOST_DP", "0")
    common = ["project_alignments", "--device", "cuda", "-m", str(index_path), "-r", str(fasta_path),
              "-d", "REF", "-s", "/", "--status-output-interval", "0"] + (["-q"] if quality else [])
    assert main(common + ["-a", str(sam_path), "-o", str(tmp_path / "out.sam")]) == 0
    before = _kernels.LAUNCHES[entry]
    assert main(common + ["-a", str(tmp_path / "in.bam"), "-B", "-b", "-o", str(tmp_path / "out.bam")]) == 0
    assert _kernels.LAUNCHES[entry] > before
    out = SamReader(str(tmp_path / "out.bam"))
    assert out.is_bam
    got = b"".join(ln for block in out.raw_record_line_blocks() for ln in block)
    want = b"".join(
        ln + b"\n" for ln in (tmp_path / "out.sam").read_bytes().split(b"\n")
        if ln and not ln.startswith(b"@")
    )
    assert got == want and got.count(b"\n") == 6000


def test_recalculate_mapq_spawns_beside_a_cuda_context(cuda, tmp_path):
    """After a launch on the card the pool's start method is ``spawn``;
    --jobs 3 then gives the output of --jobs 1, and the tool neither
    allocates on the card nor launches a kernel."""
    import multiprocessing

    from panvc3_tpu_torch import synth
    from panvc3_tpu_torch.cli.main import main
    from panvc3_tpu_torch.ops import _kernels
    from panvc3_tpu_torch.pipeline import recalculate_mapq as rm

    rows = synth.make_msa(300_000, seed=5)
    index_path, fasta_path, founders = synth.write_inputs(tmp_path, "c1", rows)
    founder_pairs = tmp_path / "founder_pairs.sam"
    founder_pairs.write_bytes(synth.pairs_sam("c1", founders, 6000, seed=7))
    # projection on the card gives the records their XR/XP/YR/YP tags, and
    # leaves the process with a live CUDA context
    pairs = tmp_path / "pairs.sam"
    assert main(["project_alignments", "--device", "cuda", "-a", str(founder_pairs), "-o", str(pairs),
                 "-m", str(index_path), "-r", str(fasta_path), "-d", "REF", "-s", "/",
                 "--status-output-interval", "0"]) == 0
    assert torch.cuda.is_initialized() and rm.mp_start_method() == "spawn"
    methods = []
    get_context = multiprocessing.get_context
    multiprocessing.get_context = lambda m=None: (methods.append(m), get_context(m))[1]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    allocated = torch.cuda.memory_allocated()
    launches = dict(_kernels.LAUNCHES)
    try:
        for jobs in (1, 3):
            assert main(["recalculate_mapq", "-a", str(pairs), "-o", str(tmp_path / f"j{jobs}.sam"),
                         "--jobs", str(jobs), "--status-output-interval", "0"]) == 0
    finally:
        multiprocessing.get_context = get_context
    assert methods == ["spawn"]
    strip = lambda b: [ln for ln in b.split(b"\n") if not ln.startswith(b"@PG")]  # noqa: E731
    assert strip((tmp_path / "j1.sam").read_bytes()) == strip((tmp_path / "j3.sam").read_bytes())
    assert len(strip((tmp_path / "j1.sam").read_bytes())) > 48000
    assert torch.cuda.max_memory_allocated() == allocated == torch.cuda.memory_allocated()
    assert dict(_kernels.LAUNCHES) == launches


# -- the fused engines (v4, v3) and projection_step: plain PyTorch around K1
# and K2, the same function on the card as on the CPU


@pytest.mark.parametrize(
    "fused_event,pallas_fused,entries,route",
    [
        ("1", "1", {"realign_fused_int"}, "v4_dp"),
        ("0", "1", {"realign_fused_int"}, "v3"),
        ("1", "0", _SPLIT_ROUTE, "v4_dp"),
    ],
    ids=["v4", "v3", "v4-split-route"],
)
def test_fused_lane_on_card_matches_cpu(cuda, tmp_path, monkeypatch, fused_event, pallas_fused, entries, route):
    """The fused lane (PANVC3_ENGINE_LANE=fused: the object path through
    the v4 engine, or v3 under PANVC3_FUSED_EVENT=0), card vs CPU, on the
    mixed reads, whose runs fit the engines' 16x16 DP; K1 launches, or K2
    and the traceback kernel under PANVC3_PALLAS_FUSED=0."""
    from panvc3_tpu_torch import synth
    from panvc3_tpu_torch.ops import _kernels, engine
    from panvc3_tpu_torch.pipeline.project_alignments import (
        ProjectConfig,
        run_project_alignments,
    )

    rows = synth.make_msa(300_000, seed=5)
    index_path, fasta_path, founders = synth.write_inputs(tmp_path, "c1", rows)
    sam = synth.every_other(synth.reads_sam("c1", founders, 6000, seed=6), 3000)
    for key, val in (("PANVC3_HOST_DP", "0"), ("PANVC3_ENGINE_LANE", "fused"),
                     ("PANVC3_FUSED_EVENT", fused_event), ("PANVC3_PALLAS_FUSED", pallas_fused)):
        monkeypatch.setenv(key, val)
    outs = {}
    for dev in ("cpu", "cuda"):
        cfg = ProjectConfig(
            msa_index_path=str(index_path), reference_path=str(fasta_path),
            reference_msa_id="REF", ref_id_separator="/", engine="device",
            device_batch_size=512, status_output_interval=0,
        )
        before = dict(_kernels.LAUNCHES)
        out = io.BytesIO()
        run_project_alignments(io.BytesIO(sam), out, cfg, device=dev)
        outs[dev] = out.getvalue()
        launched = {k: v - before[k] for k, v in _kernels.LAUNCHES.items()}
        assert engine.FUSED_ROUTES[route] > 0, engine.FUSED_ROUTES
        if dev == "cuda":
            assert {k for k, v in launched.items() if v} == entries, launched
        else:
            assert not any(launched.values()), launched
    assert outs["cuda"] == outs["cpu"]


def test_projection_step_on_card_matches_cpu(cuda):
    """projection_step: the rewrite math over the device gap index and K2
    plus the traceback kernel, card vs CPU."""
    from panvc3_tpu_torch.bitvec import GapBitVector
    from panvc3_tpu_torch.ops import _kernels
    from panvc3_tpu_torch.ops.forward import projection_step
    from panvc3_tpu_torch.ops.rank_select import DeviceGapIndex
    from panvc3_tpu_torch.ops.rewrite_batch import expand_cigars

    rng = np.random.default_rng(13)
    vectors = [GapBitVector.from_gap_string(_gap_rows(rng, 5000, 0.03)) for _ in range(2)]
    letters = np.frombuffer(b"ACGT", np.uint8)
    B, run_r, run_q = 2048, 24, 16
    cigars = [[(20, "="), (int(rng.integers(1, 5)), "I"), (int(rng.integers(1, 5)), "D"), (30, "=")]
              for _ in range(B)]
    queries = [rng.choice(letters, sum(n for n, op in c if op in "=I")).tobytes() for c in cigars]
    batch = expand_cigars(cigars, rng.integers(0, 4000, B).tolist(), queries, [0] * B, [1] * B,
                          [0] * B, pad_ops=4, pad_ref_units=64, pad_query=64)
    ref_flat = rng.choice(letters, vectors[1].n_zeros).astype(np.uint8)
    run_ref = rng.choice(letters, (B, run_r)).astype(np.uint8)
    run_query = rng.choice(letters, (B, run_q)).astype(np.uint8)
    rl = rng.integers(0, run_r + 1, B).astype(np.int32)
    ql = rng.integers(0, run_q + 1, B).astype(np.int32)
    out = {}
    for d in ("cpu", cuda):
        index = DeviceGapIndex.build(vectors, device=d)
        before = {k: _kernels.LAUNCHES[k] for k in _SPLIT_ROUTE}
        out[d] = [t.cpu() for t in projection_step(
            index, ref_flat, batch.src_seq, batch.dst_seq, batch.rec_src_pos, batch.ref_off,
            batch.ops, batch.counts, batch.query, run_ref, run_query, rl, ql,
            np.float32(-6), np.float32(-1), R=64, run_r=run_r, run_q=run_q,
        )]
        assert all(_kernels.LAUNCHES[k] == before[k] + (d == cuda) for k in _SPLIT_ROUTE)
    for g, w in zip(out[cuda], out["cpu"]):
        assert torch.equal(g, w)


# -- the mesh: shards on one card (a device may repeat) against one call


@pytest.mark.parametrize("n_shards", [2, 3])
def test_sharded_gap_kernel_on_card_matches_unsharded(cuda, n_shards):
    """The gap kernel over [cuda:0] * n: one launch set per shard over the
    one copy of the index, every output equal to one call's."""
    from panvc3_tpu_torch.bitvec import GapBitVector
    from panvc3_tpu_torch.ops import rewrite_batch as rb
    from panvc3_tpu_torch.ops.fetch import DeviceFetch
    from panvc3_tpu_torch.ops.rank_select import DeviceGapIndex
    from panvc3_tpu_torch.parallel.mesh import make_mesh, replicate

    rng = np.random.default_rng(21)
    src_row = np.frombuffer(_gap_rows(rng, 900, 0.02), np.uint8).copy()
    src_row[200:500:3] = ord("-")  # records with more than 8 deletions overflow
    vectors = [GapBitVector.from_gap_string(r) for r in (src_row.tobytes(), _gap_rows(rng, 900, 0.02))]
    R, B = 64, 8190
    args = (np.zeros(B, np.int32), np.ones(B, np.int32),
            rng.integers(-3, 520, B).astype(np.int32), rng.integers(0, R + 1, B).astype(np.int32))
    index = DeviceGapIndex.build(vectors, device="cuda:0")
    mesh = make_mesh(None, ["cuda:0"] * n_shards)
    replicas = replicate(mesh, index)
    assert all(r is index for r in replicas)
    out = rb.rewrite_gap_kernel_sharded(mesh, replicas, *args, R)
    assert all(p.device == torch.device("cuda:0") for p in out[0])
    got = DeviceFetch(*out).get()
    want = [t.cpu().numpy() for t in rb.rewrite_gap_kernel_packed(index, *args, R)]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert int(want[5]) > 0


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_v4_on_card_matches_unsharded(cuda, tmp_path, n_shards):
    """v4 over [cuda:0] * n on 2048 staged reads (the mixed kinds): every
    output equal to one call's, and K1 launched once per shard that holds
    slots."""
    import types

    from chip_smoke import projector_batch
    from panvc3_tpu_torch import synth
    from panvc3_tpu_torch.ops import _kernels
    from panvc3_tpu_torch.ops.fetch import DeviceFetch
    from panvc3_tpu_torch.ops.fused_event import make_fused_event_kernel
    from panvc3_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch_arrays

    rows = synth.make_msa(300_000, seed=5)
    index_path, fasta_path, founders = synth.write_inputs(tmp_path, "c1", rows)
    sam = synth.every_other(synth.reads_sam("c1", founders, 4096, seed=6), 2048)
    tool = types.SimpleNamespace(index_path=index_path, fasta_path=fasta_path, device="cuda")
    bp, records = projector_batch(tool, sam)
    _, _, staged = bp.stage(records)
    arrays = bp.v4_inputs(records, staged)
    kw = dict(R=staged.pad_ref_units, run_r=16, run_q=16, slot_pool=max(256, len(records) // 2))
    costs = (np.float32(0), np.float32(-1))
    want = DeviceFetch(*make_fused_event_kernel(bp.event_geometry)(
        bp.ref_flat_dev, *arrays.values(), *costs, **kw)).get()
    mesh = make_mesh(None, ["cuda:0"] * n_shards)
    before = _kernels.LAUNCHES["realign_fused_int"]
    out = make_fused_event_kernel(bp.event_geometry, mesh)(
        replicate(mesh, bp.ref_flat_dev), *shard_batch_arrays(mesh, arrays).values(), *costs, **kw)
    got = DeviceFetch(*out[:8]).get()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert int(want[7][2]) > 0
    held = sum(hi > lo for lo, hi in out.slot_ranges)
    assert _kernels.LAUNCHES["realign_fused_int"] - before == held


@pytest.mark.parametrize("quality,fused", [(False, True), (True, False)], ids=["fused-v4", "q"])
def test_data_parallel_on_card_matches_cpu(cuda, tmp_path, monkeypatch, quality, fused):
    """project_alignments with data_parallel=-1 over [cuda:0, cuda:0] (the
    fused v4 lane, or the object path under -q) against one CPU run."""
    from panvc3_tpu_torch import synth
    from panvc3_tpu_torch.ops import _kernels, engine
    from panvc3_tpu_torch.pipeline.project_alignments import (
        ProjectConfig,
        run_project_alignments,
    )

    rows = synth.make_msa(300_000, seed=5)
    index_path, fasta_path, founders = synth.write_inputs(tmp_path, "c1", rows)
    sam = synth.every_other(synth.reads_sam("c1", founders, 6000, seed=6, qualities=quality), 3000)
    monkeypatch.setenv("PANVC3_HOST_DP", "0")
    outs = {}
    for dev, dp in (("cpu", 0), (["cuda:0", "cuda:0"], -1)):
        cfg = ProjectConfig(
            msa_index_path=str(index_path), reference_path=str(fasta_path),
            reference_msa_id="REF", ref_id_separator="/", engine="device",
            device_batch_size=512, status_output_interval=0, fastlane=False,
            use_read_base_qualities=quality, fused_kernel=fused, data_parallel=dp,
        )
        before = dict(_kernels.LAUNCHES)
        out = io.BytesIO()
        run_project_alignments(io.BytesIO(sam), out, cfg, device=dev)
        outs[dp] = out.getvalue()
        launched = {k: v - before[k] for k, v in _kernels.LAUNCHES.items() if v - before[k]}
    entry = "realign_fused_qual" if quality else "realign_fused_int"
    assert set(launched) == {entry}, launched
    if fused:
        assert engine.FUSED_ROUTES["v4_dp"] > 0, engine.FUSED_ROUTES
    assert outs[-1] == outs[0]


# -- the installed port: the distribution's wheel, unpacked, on the card

def test_installed_command_on_card_matches_checkout_cpu(cuda, tmp_path):
    """``panvc3_torch_project_alignments --device cuda`` from the unpacked
    wheel (``PYTHONPATH`` the target alone, a temporary ``XDG_CACHE_HOME``,
    run from outside the checkout) builds its C extension and kernels into
    that cache, launches K1 and gives the checkout's CPU run's SAM."""
    from chip_smoke import (
        build_wheel,
        console_script,
        fastlane_diag,
        installed_env,
        snapshot,
        strip_pg,
        unpack_wheel,
    )
    from panvc3_tpu_torch import synth

    repo = pathlib.Path(__file__).resolve().parent.parent
    rows = synth.make_msa(300_000, seed=5)
    index_path, fasta_path, founders = synth.write_inputs(tmp_path, "c1", rows)
    sam = tmp_path / "in.sam"
    sam.write_bytes(synth.reads_sam("c1", founders, 6000, seed=6))
    target, cache, run = tmp_path / "site", tmp_path / "cache", tmp_path / "run"
    scripts = unpack_wheel(build_wheel(tmp_path / "wheel"), target)
    run.mkdir()
    before = snapshot(target)
    args = ["-a", str(sam), "-m", str(index_path), "-r", str(fasta_path), "-d", "REF", "-s", "/",
            "--device-batch-size", "1024", "--status-output-interval", "0"]
    outs, diags = {}, {}
    for dev, argv, env, cwd in (
        ("cuda", console_script(scripts, "panvc3_torch_project_alignments"),
         installed_env(target, cache), run),
        ("cpu", [sys.executable, "-m", "panvc3_tpu_torch", "project_alignments"],
         installed_env(repo, cache), repo),
    ):
        out = tmp_path / f"{dev}.sam"
        env.update(PANVC3_HOST_DP="0", PANVC3_FASTLANE_PROF="1")
        proc = subprocess.run(argv + args + ["--device", dev, "-o", str(out)], env=env, cwd=cwd,
                              capture_output=True, text=True, timeout=900)
        assert proc.returncode == 0, proc.stderr
        diags[dev] = fastlane_diag(proc.stderr)
        outs[dev] = out.read_bytes()
    assert diags["cuda"]["kernel_launches"]["realign_fused_int"] > 0, diags
    assert strip_pg(outs["cuda"]) == strip_pg(outs["cpu"])
    assert list((cache / "panvc3_tpu_torch/kernels").glob("*/librealign_fused.so"))
    assert list((cache / "panvc3_tpu_torch/native").glob("*/_panvc3_native*.so"))
    assert snapshot(target) == before
