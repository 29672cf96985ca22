"""The port's data-parallel execution (``panvc3_tpu_torch.parallel``)
against panvc3_tpu's.

panvc3_tpu shards over the 8 virtual CPU devices of ``tests/conftest.py``;
the port over an explicit device list in which a device may repeat
(``["cpu"] * 8``), which runs its shard, pad and gather code for real on
the one CPU.  Covered: the host helpers of ``distributed.py`` and the
mesh helpers; the gap kernel over a mesh against one device; the v4
engine over a mesh against one device and against panvc3_tpu's sharded
call, every output element (the one exception is a run-pool overflow's
last slot, whose content is unspecified on one device too: there the
flags and wire outputs are compared); the object path with
``data_parallel`` (integer, ``-q``, the fused v4 lane) against the
single-device run and panvc3_tpu's 8-device run; the CLI's
``--data-parallel -1``; and two processes under ``gloo``, four shards
each, against a process-local replay.
"""

from __future__ import annotations

import inspect
import io
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from panvc3_tpu.io.sam import SamRecord as JaxSamRecord
from panvc3_tpu.ops import rewrite_batch as jax_rb
from panvc3_tpu.ops.fused_event import make_fused_event_kernel as jax_make_fused_event_kernel
from panvc3_tpu.parallel import distributed as jax_dist
from panvc3_tpu.parallel import mesh as jax_mesh
from panvc3_tpu.pipeline import project_alignments as jax_pa
from panvc3_tpu_torch.io.sam import SamRecord
from panvc3_tpu_torch.ops import engine as port_engine
from panvc3_tpu_torch.ops import fused_event
from panvc3_tpu_torch.ops import rewrite_batch as rb
from panvc3_tpu_torch.ops.fetch import DeviceFetch
from panvc3_tpu_torch.parallel import distributed as dist
from panvc3_tpu_torch.parallel.mesh import Mesh, make_mesh, replicate, shard_batch_arrays
from panvc3_tpu_torch.pipeline import project_alignments as port_pa

from .test_engine import _synthesise_indel_sam
from .test_torch_device_event import _assert_tables_equal
from .test_torch_fused import V4_WIRE, _case
from .test_torch_gap_index import _gap_vectors, _pair
from .test_workflow_data import WORKFLOW, founder_seqs, msa_files  # noqa: F401 (fixtures)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GENOME = str(WORKFLOW / "genome/genome.fa.gz")
V4_NAMES = V4_WIRE + ("realign_ops", "realign_counts", "flags")
GAP_NAMES = ("initial", "gapbits", "d_vals", "d_pos", "d_n8", "overflow", "d_run")
CPU8 = ["cpu"] * 8


# ---------------------------------------------------------------------------
# distributed.py: the host helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", [1, 3, 8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_distributed_helpers_match_jax(seed, n_shards):
    rng = np.random.default_rng(seed)
    names = [f"q{seed}_{i}_{int(v)}" for i, v in enumerate(rng.integers(0, 10**9, 300))]
    assert [dist.qname_shard(q, n_shards) for q in names] == [
        jax_dist.qname_shard(q, n_shards) for q in names
    ]
    got = dist.split_records_by_qname([SamRecord(qname=q) for q in names], n_shards)
    want = jax_dist.split_records_by_qname([JaxSamRecord(qname=q) for q in names], n_shards)
    assert [[r.qname for r in s] for s in got] == [[r.qname for r in s] for s in want]
    size = int(rng.integers(0, 10**7))
    assert dist.byte_ranges(size, n_shards) == jax_dist.byte_ranges(size, n_shards)
    chr_ids = [f"chr{int(v)}" for v in rng.permutation(25)[: int(rng.integers(1, 25))]]
    assert dist.split_chromosomes(chr_ids, n_shards) == jax_dist.split_chromosomes(chr_ids, n_shards)
    for c in chr_ids:
        assert dist.chr_shard(c, chr_ids, n_shards) == jax_dist.chr_shard(c, chr_ids, n_shards)
    ref_chr = [chr_ids[int(v)] for v in rng.integers(0, len(chr_ids), 6)]
    recs = [(int(v), f"r{i}") for i, v in enumerate(rng.integers(0, 6, 200))]
    got = dist.split_records_by_chr(
        [SamRecord(qname=q, ref_id=r) for r, q in recs], ref_chr, chr_ids, n_shards
    )
    want = jax_dist.split_records_by_chr(
        [JaxSamRecord(qname=q, ref_id=r) for r, q in recs], ref_chr, chr_ids, n_shards
    )
    assert [[r.qname for r in s] for s in got] == [[r.qname for r in s] for s in want]


def test_distributed_raises_as_jax():
    for mod in (dist, jax_dist):
        with pytest.raises(ValueError, match="positive"):
            mod.split_chromosomes(["chr1"], 0)
        with pytest.raises(KeyError):
            mod.chr_shard("chrX", ["chr1"], 2)
    # one process: no process group is set up
    dist.initialise(None, 1, 0)
    assert not torch.distributed.is_initialized()


# tests/test_parallel.py, run on the port's copies


def test_qname_shard_stable_and_balanced():
    n = 8
    counts = [0] * n
    for i in range(4000):
        s = dist.qname_shard(f"read{i}", n)
        assert s == dist.qname_shard(f"read{i}", n)  # deterministic
        counts[s] += 1
    assert min(counts) > 4000 / n * 0.7  # roughly balanced


def test_split_records_keeps_groups_together():
    recs = [SamRecord(qname=f"pair{i}") for i in range(100) for _ in range(2)]
    shards = dist.split_records_by_qname(recs, 4)
    assert sum(len(s) for s in shards) == 200
    for shard in shards:
        names: dict[str, int] = {}
        for r in shard:
            names[r.qname] = names.get(r.qname, 0) + 1
        assert set(names.values()) == {2}  # both mates on the same shard


def test_byte_ranges_cover():
    rngs = dist.byte_ranges(1000, 3)
    assert rngs[0][0] == 0
    assert rngs[-1][1] == 1000
    for (_, b), (c, _) in zip(rngs, rngs[1:]):
        assert b == c


# ---------------------------------------------------------------------------
# mesh.py
# ---------------------------------------------------------------------------


def test_make_mesh_takes_the_first_n_devices():
    assert make_mesh(None, CPU8).devices == (torch.device("cpu"),) * 8
    assert make_mesh(3, CPU8).size == 3
    # one CPU: any count gives a mesh of it, as JAX's devices[:n]
    for n in (None, 1, 4):
        assert make_mesh(n, "cpu").devices == (torch.device("cpu"),)
    assert jax_mesh.make_mesh(3).devices.size == 3 == make_mesh(3, CPU8).size
    mesh = make_mesh(None, CPU8)
    assert mesh.axis == "dp" and mesh.unique_devices == (torch.device("cpu"),)
    assert mesh.local_shards == range(8)
    with pytest.raises(ValueError):
        Mesh(())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            make_mesh(None, "cuda")
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            make_mesh(2, ["cpu", "cuda:0"])
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            Mesh(("cuda",))


@pytest.mark.parametrize("as_numpy", [True, False], ids=["numpy", "tensor"])
def test_shard_batch_arrays_row_blocks_and_replication(as_numpy):
    """Arrays with at least mesh.size rows are cut into equal row blocks,
    smaller ones and scalars replicated: the JAX rule, checked against
    JAX's shards."""
    rng = np.random.default_rng(0)
    arrays = {
        "rows": rng.integers(0, 100, (16, 3)).astype(np.int32),
        "vec": rng.integers(0, 100, 8).astype(np.int8),
        "small": np.arange(5, dtype=np.int32),
        "scalar": np.float32(2.5),
    }
    mesh = make_mesh(None, CPU8)
    got = shard_batch_arrays(
        mesh, {k: (v if as_numpy else torch.as_tensor(v)) for k, v in arrays.items()}
    )
    want = jax_mesh.shard_batch_arrays(jax_mesh.make_mesh(8), arrays)
    for key, pieces in got.items():
        assert len(pieces) == 8
        jax_shards = sorted(want[key].addressable_shards, key=lambda s: s.device.id)
        for piece, shard in zip(pieces, jax_shards):
            assert piece.device == torch.device("cpu")
            assert np.array_equal(piece.numpy(), np.asarray(shard.data)), key
    assert got["rows"][1].shape == (2, 3) and got["small"][3].shape == (5,)
    with pytest.raises(ValueError, match="divide"):
        shard_batch_arrays(mesh, {"odd": np.zeros(12, np.int32)})


def test_replicate_makes_one_copy_per_device():
    """Shards on one device share one copy; each other device gets one
    copy, made from the first without a rebuild.  The ``meta`` device
    stands in for a second card."""
    from panvc3_tpu_torch.ops.event_geometry import DeviceEventGeometry

    _, tidx, _, td, *_ = _case("none")
    mesh = Mesh(("cpu", "meta", "cpu", "meta"))
    assert mesh.size == 4 and mesh.unique_devices == (torch.device("cpu"), torch.device("meta"))
    for obj in (tidx, td, torch.arange(6)):
        reps = replicate(mesh, obj)
        assert reps[0] is obj and reps[2] is obj
        assert reps[1] is reps[3] and reps[1] is not obj
    index_meta = replicate(mesh, tidx)[1]
    for key in tidx.FIELDS:
        t = getattr(tidx, key)
        if t is not None:
            assert getattr(index_meta, key).device.type == "meta"
            assert getattr(index_meta, key).shape == t.shape
    assert index_meta.search_steps == tidx.search_steps
    geo_meta = td.to("meta")
    assert isinstance(geo_meta, DeviceEventGeometry) and geo_meta.device.type == "meta"
    for key in DeviceEventGeometry.DEVICE_TABLES:
        assert getattr(geo_meta, key).device.type == "meta"
        assert getattr(td, key).device.type == "cpu"
    assert td.to("cpu") is td
    # a numpy array is copied to each device once
    arr = np.arange(4)
    reps = replicate(Mesh(("cpu", "cpu")), arr)
    assert reps[0] is reps[1] and np.array_equal(reps[0].numpy(), arr)


def test_device_fetch_joins_shards():
    pieces = [torch.arange(3) + 10 * i for i in range(4)]
    whole = torch.arange(5)
    got = DeviceFetch(pieces, whole).get()
    assert np.array_equal(got[0], torch.cat(pieces).numpy())
    assert np.array_equal(got[1], whole.numpy())
    assert not DeviceFetch(pieces).events  # the CPU needs no event


# ---------------------------------------------------------------------------
# the gap kernel over a mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", [3, 8])
@pytest.mark.parametrize("cause", ["none", "many-deletions"])
def test_sharded_gap_kernel_matches_unsharded(cause, n_shards):
    """90 records (not divisible by the mesh) padded with copies of row 0,
    the engine's rule, then the gap kernel per shard: equal to one call on
    the padded batch, to one call on the 90 records on their rows, and
    to panvc3_tpu's call sharded over its 8 devices."""
    rng = np.random.default_rng(len(cause))
    j, t = _pair(_gap_vectors(rng, cause), (None, None))
    R, B = 64, 90
    src = rng.integers(0, 3, B).astype(np.int32)
    src[src == 1] = 0
    dst = np.ones(B, np.int32)
    n_units = rng.integers(0, R + 1, B).astype(np.int32)
    pos = rng.integers(-3, 520, B).astype(np.int32)
    pos[:6] = [150, 160, 180, 250, 280, 290]
    n_units[:6] = R
    n_pad = 6  # 96 rows: 8 and 3 both divide
    padded = [np.concatenate([a, np.repeat(a[:1], n_pad)]) for a in (src, dst, pos, n_units)]
    mesh = make_mesh(None, ["cpu"] * n_shards)
    out = rb.rewrite_gap_kernel_sharded(mesh, replicate(mesh, t), *padded, R)
    assert all(len(out[k]) == n_shards for k in (0, 1, 2, 3, 4, 6))
    got = DeviceFetch(*out).get()
    one = [x.numpy() for x in rb.rewrite_gap_kernel_packed(t, *padded, R)]
    unpadded = [x.numpy() for x in rb.rewrite_gap_kernel_packed(t, src, dst, pos, n_units, R)]
    jm = jax_mesh.make_mesh(8)
    sharded = jax_mesh.shard_batch_arrays(jm, dict(zip("abcd", padded)))
    want = [np.asarray(x) for x in jax_rb.rewrite_gap_kernel_packed(j, *sharded.values(), R)]
    for k, name in enumerate(GAP_NAMES):
        assert got[k].dtype == one[k].dtype == want[k].dtype, name
        assert np.array_equal(got[k], one[k]), name
        assert np.array_equal(got[k], want[k]), name
        if name != "overflow":
            assert np.array_equal(got[k][:B], unpadded[k]), name
    assert (int(got[5]) > 0) == (cause != "none")
    for g, w in zip(rb.fetch_gap_outputs([*got[:6], out[6]], R), rb.fetch_gap_outputs(one, R)):
        assert np.array_equal(g, w)


# ---------------------------------------------------------------------------
# the v4 engine over a mesh
# ---------------------------------------------------------------------------


def _v4_arrays(batch, ref_ids):
    return dict(
        ref_ids=np.asarray(ref_ids, np.int32), rec_src_pos=batch.rec_src_pos,
        n_ref_units=batch.n_ref_units, ref_off=batch.ref_off, ops=batch.ops,
        counts=batch.counts, query=batch.query,
    )


def _pad_empty(arrays, n):
    """The engine's mesh pad: ``n`` empty records (no units, no ops)."""
    out = {}
    for key, arr in arrays.items():
        pad = np.zeros((n,) + arr.shape[1:], arr.dtype)
        if key == "ops":
            pad[:] = rb.CODE_NONE
        out[key] = np.concatenate([np.asarray(arr), pad])
    return out


def _port_sharded(geo, mesh, ref_flat, arrays, kw, go=-6):
    out = fused_event.make_fused_event_kernel(geo, mesh)(
        replicate(mesh, ref_flat), *shard_batch_arrays(mesh, arrays).values(),
        np.float32(go), np.float32(-1), **kw,
    )
    ranges = out.slot_ranges
    assert ranges[0][0] == 0 and ranges[-1][1] == kw["slot_pool"]
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    return DeviceFetch(*out[:8]).get()


def _assert_v4_equal(got, want, what):
    """Every output equal; the pool outputs only where the pool did not
    overflow (its last slot is then unspecified)."""
    flags = np.asarray(want[7])
    for k, name in enumerate(V4_NAMES):
        if name.startswith("realign") and int(flags[2]) > int(np.asarray(want[6]).shape[0]):
            continue
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype, (what, name)
        assert np.array_equal(got[k], w), (what, name)


@pytest.mark.parametrize("n_shards", [3, 8])
@pytest.mark.parametrize("kind", ["none", "event", "pool", "length", "count", "deletion"])
def test_sharded_v4_matches_unsharded(kind, n_shards):
    """Every overflow kind of test_torch_fused, 96 records over 3 and 8
    shards, against the port's single-device call."""
    _, _, _, td, b, ref_flat, ref_ids, run_pad, slot_pool = _case(kind)
    kw = dict(R=b.pad_ref_units, run_r=run_pad, run_q=run_pad, slot_pool=slot_pool)
    arrays = _v4_arrays(b, ref_ids)
    want = [x.numpy() for x in fused_event.make_fused_event_kernel(td)(
        ref_flat, *arrays.values(), np.float32(-6), np.float32(-1), **kw)]
    got = _port_sharded(td, make_mesh(None, ["cpu"] * n_shards), ref_flat, arrays, kw)
    _assert_v4_equal(got, want, kind)
    flags = want[7]
    fires = {"event": 1, "pool": 0, "length": 0, "count": 0, "deletion": 1}
    assert flags[fires[kind]] > 0 if kind in fires else not flags[:2].any(), flags


def _port_geometry(n_cols: int, seed: int):
    """The port's counterpart of ``__graft_entry__._toy_geometry``: the same
    sparse gap rows from the same seed, in the port's classes.  Returns
    (device geometry on the CPU, ref_flat, source units).  Self-contained:
    the two-process test runs its source in workers without JAX."""
    import numpy as np

    from panvc3_tpu_torch.bitvec import GapBitVector
    from panvc3_tpu_torch.msa_index import SequenceEntry
    from panvc3_tpu_torch.ops.event_geometry import DeviceEventGeometry, EventGeometry

    rng = np.random.default_rng(seed)

    def sparse_bits():
        bits = np.zeros(n_cols, np.uint8)
        starts = rng.integers(1, n_cols - 4, max(2, n_cols // 100))
        for s in starts:
            bits[s:s + int(rng.integers(1, 4))] = 1
        bits[0] = 0
        return bits

    src = GapBitVector.from_bits(sparse_bits())
    dst = GapBitVector.from_bits(sparse_bits())
    host = EventGeometry([SequenceEntry("founder", src)], [SequenceEntry("REF", dst)], [0])
    ref_flat = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), dst.n_zeros)
    return DeviceEventGeometry(host, "cpu"), ref_flat, src.n_zeros


def _graft_case(b: int, r: int, seed: int = 3):
    """``__graft_entry__._example_inputs`` as numpy, the JAX geometry and
    the port's geometry of the same rows."""
    jgeo, ref_flat, batch = graft._example_inputs(b=b, r=r, lq_pad=r, seed=seed)
    tgeo, t_ref_flat, _ = _port_geometry(4 * r + 64, seed)
    _assert_tables_equal(tgeo, jgeo)
    assert np.array_equal(t_ref_flat, np.asarray(ref_flat))
    return jgeo, tgeo, np.asarray(ref_flat), {k: np.asarray(v) for k, v in batch.items()}


def _jax_sharded(fn, ref_flat, arrays):
    jm = jax_mesh.make_mesh(8)
    out = fn(jax_mesh.replicate(jm, ref_flat), *jax_mesh.shard_batch_arrays(jm, arrays).values())
    return [np.asarray(x) for x in jax.block_until_ready(out)]


@pytest.mark.parametrize("n_shards", [2, 8])
@pytest.mark.parametrize("padded", [False, True], ids=["64", "90-padded"])
def test_sharded_v4_matches_jax_dryrun(padded, n_shards):
    """``dryrun_multichip``'s batch: v4's own DP answers (no flag but the
    run total), and the port's sharded call equals its unsharded call and
    panvc3_tpu's call sharded over 8 devices.  The padded case has 90
    records padded with 6 empty ones, as the engine pads for a mesh: its
    rows past 90 and its pool equal the unpadded call's."""
    b, r = (90, 32) if padded else (64, 32)
    jgeo, tgeo, ref_flat, arrays = _graft_case(b, r)
    if padded:
        arrays = _pad_empty(arrays, 6)
    bk = len(arrays["ops"])
    kw = dict(R=r, run_r=16, run_q=16, slot_pool=max(256, bk // 2))
    want = _jax_sharded(graft._kernel_fn(jgeo, bk, r), ref_flat, arrays)
    flags = want[7]
    assert flags[0] == flags[1] == 0 and flags[2] >= b, flags
    one = [x.numpy() for x in fused_event.make_fused_event_kernel(tgeo)(
        ref_flat, *arrays.values(), np.float32(0), np.float32(-1), **kw)]
    # _kernel_fn's gap costs are (0, -1)
    got = _port_sharded(tgeo, make_mesh(None, ["cpu"] * n_shards), ref_flat, arrays, kw, go=0)
    _assert_v4_equal(one, want, "unsharded")
    _assert_v4_equal(got, want, "sharded")
    if padded:
        unpadded = [x.numpy() for x in fused_event.make_fused_event_kernel(tgeo)(
            ref_flat, *(a[:b] for a in arrays.values()), np.float32(0), np.float32(-1), **kw)]
        for k, name in enumerate(V4_NAMES):
            assert np.array_equal(got[k][:b] if k < 5 else got[k], unpadded[k]), name


@pytest.mark.parametrize("kind", ["pool", "event"])
def test_sharded_v4_overflow_matches_jax_sharded(kind):
    """Run-pool and event overflow: the port over 8 shards against
    panvc3_tpu's v4 sharded over its 8 devices."""
    _, _, jd, td, b, ref_flat, ref_ids, run_pad, slot_pool = _case(kind)
    kw = dict(R=b.pad_ref_units, run_r=run_pad, run_q=run_pad, slot_pool=slot_pool)
    arrays = _v4_arrays(b, ref_ids)
    kernel = jax_make_fused_event_kernel(jd)

    def fn(ref, *args):
        return kernel(ref, *args, np.float32(-6), np.float32(-1), **kw)

    want = _jax_sharded(fn, ref_flat, arrays)
    got = _port_sharded(td, make_mesh(None, CPU8), ref_flat, arrays, kw)
    _assert_v4_equal(got, want, kind)
    assert want[7][0 if kind == "pool" else 1] > 0


# ---------------------------------------------------------------------------
# the object path over a mesh
# ---------------------------------------------------------------------------


def _strip_pg(sam: bytes) -> bytes:
    return b"\n".join(ln for ln in sam.split(b"\n") if not ln.startswith(b"@PG"))


def _cfg(mod, index_path, **kw):
    return mod.ProjectConfig(
        msa_index_path=str(index_path), reference_path=GENOME, reference_msa_id="REF",
        ref_id_separator="/", engine="device", device_batch_size=64,
        status_output_interval=0, **kw,
    )


def _jax_run(index_path, sam, **kw) -> bytes:
    out = io.BytesIO()
    jax_pa.run_project_alignments(io.BytesIO(sam), out, _cfg(jax_pa, index_path, **kw))
    return _strip_pg(out.getvalue())


def _port_run(index_path, sam, device, **kw) -> bytes:
    out = io.BytesIO()
    port_pa.run_project_alignments(
        io.BytesIO(sam), out, _cfg(port_pa, index_path, **kw), device=device
    )
    return _strip_pg(out.getvalue())


@pytest.fixture(scope="module")
def mesh_case(msa_files, founder_seqs):  # noqa: F811
    """90 reads (not divisible by 8) and panvc3_tpu's data_parallel=-1
    output on its 8 devices, integer and -q."""
    index_path, _, _ = msa_files
    sam = _synthesise_indel_sam(founder_seqs, n_reads=90)
    want = {q: _jax_run(index_path, sam, data_parallel=-1, use_read_base_qualities=q)
            for q in (False, True)}
    return index_path, sam, want


@pytest.mark.parametrize("quality", [False, True], ids=["int", "q"])
@pytest.mark.parametrize("dp", [0, -1, 3])
def test_data_parallel_matches_single_device_and_jax(mesh_case, monkeypatch, dp, quality):
    """data_parallel 0 (one device), -1 (8 shards) and 3 on
    ``device=["cpu"] * 8``: panvc3_tpu's 8-device SAM byte for byte, and
    the mesh runs take the object path through the sharded gap kernel."""
    index_path, sam, want = mesh_case
    calls = []
    real = port_engine.rewrite_gap_kernel_sharded

    def spy(mesh, *args):
        calls.append(mesh.size)
        return real(mesh, *args)

    monkeypatch.setattr(port_engine, "rewrite_gap_kernel_sharded", spy)
    monkeypatch.setenv("PANVC3_HOST_DP", "0")
    got = _port_run(index_path, sam, CPU8, data_parallel=dp, use_read_base_qualities=quality)
    assert got == want[quality]
    assert calls == ([] if dp == 0 else [8 if dp == -1 else 3] * 2)


def test_data_parallel_fused_v4(mesh_case, monkeypatch):
    """The fused v4 lane sharded over 8 CPU shards equals the single-device
    fused and split runs and panvc3_tpu's mesh output.  The spies show that
    v4's own DP answered: no batch realigned on the host path, none went
    through the v3 re-dispatch."""
    index_path, sam, want = mesh_case
    monkeypatch.setenv("PANVC3_HOST_DP", "0")
    # the toy MSA's runs exceed the production run pad of 16
    monkeypatch.setattr(port_engine.BatchProjector, "FUSED_RUN_PAD", 64)
    calls = {"host_realign": 0, "gap_redispatch": 0}
    orig_rs = port_engine.BatchProjector._realign_and_splice
    orig_fg = port_engine.BatchProjector._dispatch_fused_gap

    def spy_rs(self, *a, **kw):
        calls["host_realign"] += 1
        return orig_rs(self, *a, **kw)

    def spy_fg(self, *a, **kw):
        calls["gap_redispatch"] += 1
        return orig_fg(self, *a, **kw)

    single_split = _port_run(index_path, sam, "cpu", fastlane=False)
    monkeypatch.setattr(port_engine.BatchProjector, "_realign_and_splice", spy_rs)
    monkeypatch.setattr(port_engine.BatchProjector, "_dispatch_fused_gap", spy_fg)
    single_fused = _port_run(index_path, sam, "cpu", fused_kernel=True)
    mesh_fused = _port_run(index_path, sam, CPU8, data_parallel=-1, fused_kernel=True)
    assert calls == {"host_realign": 0, "gap_redispatch": 0}
    assert port_engine.FUSED_ROUTES["v4_dp"] > 0
    assert mesh_fused == single_fused == single_split == want[False]


@pytest.mark.parametrize("fused", [False, True], ids=["gap-kernel", "v4"])
def test_mesh_batch_projector_pads_and_replicates(mesh_case, monkeypatch, fused):
    """BatchProjector over 8 shards on one device holds one copy of the
    gap index and of the flat reference; a batch of 90 records is padded
    to 96 rows (the gap kernel's bucket of 64 is below it, so only the
    mesh pads: copies of row 0 for the gap kernel, empty records for v4),
    and its results equal one device's."""
    from panvc3_tpu_torch.io.fasta import FastaReader
    from panvc3_tpu_torch.io.sam import SamReader
    from panvc3_tpu_torch.msa_index import MsaIndex

    index_path, sam, _ = mesh_case
    monkeypatch.setenv("PANVC3_HOST_DP", "0")
    monkeypatch.setattr(port_engine.BatchProjector, "FUSED_RUN_PAD", 64)
    reader = SamReader(io.BytesIO(sam))
    records = list(reader)
    out_header, mapping = port_pa.process_headers(reader.header, "/", "REF", None)
    src, dst = port_pa.fill_sequence_entries(
        MsaIndex.load(str(index_path)), reader.header.ref_names, len(out_header.ref_names),
        "/", "REF", mapping,
    )
    fasta = FastaReader(GENOME)
    ref_seqs = {r: fasta.read_sequence(out_header.ref_names[r]) for r in set(mapping)}
    cfg = port_pa.ProjectConfig(device_batch_size=64, fused_kernel=fused)
    bp = port_engine.BatchProjector(src, dst, mapping, 0, -1, "cpu", mesh=make_mesh(None, CPU8))
    handle = bp.start_batch(records, ref_seqs, cfg)
    if fused:
        assert handle[0] == "fusedev"
        assert all(len(a) == 96 for a in handle[5].get()[:5])
        assert all(r is bp.ref_flat_dev for r in bp.ref_flat_replicas)
    else:
        assert handle[0] == "split" and handle[8] == 6
        assert [len(p) for p in handle[5][1]] == [12] * 8
        assert len(bp.index_replicas) == 8 and all(r is bp.index for r in bp.index_replicas)
    got = bp.finish_batch(handle)
    one = port_engine.BatchProjector(src, dst, mapping, 0, -1, "cpu")
    want = one.project_batch(records, ref_seqs, cfg)
    assert len(got) == len(want) == 90
    assert [vars(r) for r in got] == [vars(r) for r in want]
    assert sum(r.num_realignments for r in got) > 0


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_data_parallel_matches_jax(mesh_case, tmp_path):
    index_path, sam, _ = mesh_case
    src = tmp_path / "in.sam"
    src.write_bytes(sam)
    outs = {}
    for module, extra in (("panvc3_tpu", []), ("panvc3_tpu_torch", ["--device", "cpu"])):
        out = tmp_path / f"{module}.sam"
        proc = subprocess.run(
            [sys.executable, "-m", module, "project_alignments", *extra,
             "--data-parallel", "-1", "-a", str(src), "-m", str(index_path), "-r", GENOME,
             "-d", "REF", "-s", "/", "-o", str(out), "--status-output-interval", "0"],
            env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, timeout=300,
        )
        assert proc.returncode == 0, proc.stderr.decode()[-2000:]
        outs[module] = _strip_pg(out.read_bytes())
    assert outs["panvc3_tpu_torch"] == outs["panvc3_tpu"]
    assert outs["panvc3_tpu"].count(b"\n") > 90


# ---------------------------------------------------------------------------
# two processes
# ---------------------------------------------------------------------------


WORKER = r"""
import os, sys
pid, port = int(sys.argv[1]), sys.argv[2]
sys.path.insert(0, sys.argv[3])
import numpy as np
import torch
from panvc3_tpu_torch.ops.fetch import DeviceFetch
from panvc3_tpu_torch.ops.fused_event import make_fused_event_kernel
from panvc3_tpu_torch.ops.rewrite_batch import CODE_NONE
from panvc3_tpu_torch.cigar import D, EQ, I
from panvc3_tpu_torch.parallel.distributed import initialise
from panvc3_tpu_torch.parallel.mesh import Mesh, replicate, shard_batch_arrays

initialise(f"localhost:{port}", 2, pid, device="cpu")
mesh = Mesh.across_processes(["cpu"] * 4)
assert mesh.size == 8 and mesh.local_shards == range(4 * pid, 4 * pid + 4)

# __PORT_GEOMETRY__

# __graft_entry__._example_inputs's batch (b records of r reference units,
# one 4I 4D run each), from the same seed: both processes build the same
# global inputs
b, r, seed = 16, 32, 3
geo, ref_flat, src_units = _port_geometry(4 * r + 64, seed)
rng = np.random.default_rng(seed + 1)
starts = rng.integers(0, max(1, src_units - r - 1), b).astype(np.int32)
half = r // 2
ops = np.full((b, 8), CODE_NONE, np.int8)
counts = np.zeros((b, 8), np.int32)
ops[:, :4] = [EQ, I, D, EQ]
counts[:, :4] = [half, 4, 4, r - half - 4]
lq = r
query = np.zeros((b, r), np.uint8)
query[:, :lq] = rng.choice(np.frombuffer(b"ACGT", np.uint8), (b, lq))
batch = dict(ref_ids=np.zeros(b, np.int32), rec_src_pos=starts,
             n_ref_units=np.full(b, r, np.int32), ref_off=np.zeros(b, np.int32),
             ops=ops, counts=counts, query=query)
kw = dict(R=r, run_r=16, run_q=16, slot_pool=max(256, b // 2))
costs = (np.float32(0.0), np.float32(-1.0))
out = make_fused_event_kernel(geo, mesh)(
    replicate(mesh, ref_flat), *shard_batch_arrays(mesh, batch).values(), *costs, **kw)
# process-local single-device replay of the same global inputs
want = [x.numpy() for x in make_fused_event_kernel(geo)(ref_flat, *batch.values(), *costs, **kw)]
flags = want[7]
assert flags[0] == flags[1] == 0 and flags[2] >= b, flags
assert np.array_equal(out.flags.numpy(), flags), (out.flags, flags)
rows = b // mesh.size
for k, name in enumerate(("initial", "gapbits", "d_vals", "d_pos8", "d_n8")):
    for piece, g in zip(out[k], mesh.local_shards):
        assert np.array_equal(piece.numpy(), want[k][g * rows:(g + 1) * rows]), (pid, name)
for k, name in ((5, "realign_ops"), (6, "realign_counts")):
    for piece, (lo, hi) in zip(out[k], out.slot_ranges):
        assert np.array_equal(piece.numpy(), want[k][lo:hi]), (pid, name)
print(f"proc{pid} ok slots {out.slot_ranges}", flush=True)
"""


@pytest.mark.skipif(
    os.environ.get("PANVC3_SKIP_MULTIPROCESS") == "1", reason="multiprocess test disabled"
)
def test_two_process_sharded_v4(tmp_path):
    """Two processes under gloo, four CPU shards each, a global mesh of 8:
    each process compares its shards of the sharded v4 call, and the
    global flags, with a process-local single-device replay."""
    script = tmp_path / "worker.py"
    script.write_text(WORKER.replace("# __PORT_GEOMETRY__", inspect.getsource(_port_geometry)))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid), port, REPO],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out.decode(), err.decode()))
    for rc, _, err in outs:
        assert rc == 0, err[-2000:]
    assert "proc0 ok" in outs[0][1] and "proc1 ok" in outs[1][1]
    # the last shard also holds the empty slots past the runs
    assert outs[1][1].rstrip().endswith("256)]")


# ---------------------------------------------------------------------------
# chip_smoke.py's mesh phase, rehearsed on the CPU
# ---------------------------------------------------------------------------

_REHEARSAL = r"""
import pathlib, sys

def run(work):
    import chip_smoke
    from panvc3_tpu_torch import synth

    n_reads, n_obj = 1024, 256
    rows = synth.make_msa(200_000, seed=5)
    index_path, fasta_path, founders = synth.write_inputs(work, "chr21", rows)
    sam_path = work / "reads.sam"
    sam_path.write_bytes(synth.reads_sam("chr21", founders, n_reads, 6))
    q_sam_path = work / "reads_q.sam"
    q_sam_path.write_bytes(synth.reads_sam("chr21", founders, n_reads, 6, qualities=True))
    tool = chip_smoke.Tool("cpu rehearsal", work, index_path, fasta_path, device="cpu")
    device = {"PANVC3_HOST_DP": "0"}
    dev_sam, *_ = tool.run("int-device", device, sam_path, expect=n_reads)
    heads = (chip_smoke.head_sam(sam_path, work / "reads_head.sam", n_obj),
             chip_smoke.head_sam(q_sam_path, work / "reads_q_head.sam", n_obj))
    obj = tool.run("int-object", device, heads[0], fastlane=False, expect=n_obj)[0]
    q_obj = tool.run("q-object", device, heads[1], quality=True, fastlane=False, expect=n_obj)[0]
    used = {"realign_fused_int": 0, "realign_fused_qual": 0, "realign_fill_sub": 0,
            "realign_traceback": 0}
    routes = chip_smoke.phase_fused(tool, sam_path, dev_sam, used, n_reads=n_obj, batch=64)
    chip_smoke.phase_mesh(
        tool, heads, (obj, q_obj), work / "reads_fused_even.sam",
        synth.every_other(chip_smoke.strip_pg(dev_sam), n_obj), routes["fused-b-even"], used,
        batch=64,
    )
    assert not any(used.values()), used  # no card: no launch
    assert not any(m == "jax" or m.startswith(("jax.", "panvc3_tpu.")) for m in sys.modules)
    print("REHEARSAL_OK", routes["fused-b-even"])

if __name__ == "__main__":
    run(pathlib.Path(sys.argv[1]))
"""


def test_chip_smoke_mesh_phase_on_cpu(tmp_path):
    """Phase 10 of ``chip_smoke.py`` (the mesh: the dry run over 2 and 4
    shards, --data-parallel -1 through the CLI, integer and -q, and the
    fused lane through the library over two shards) at a small size with
    ``--device cpu``, in a process of its own as on the card; every
    comparison it makes there is made here."""
    script = tmp_path / "rehearse_phase10.py"
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
    assert "REHEARSAL_OK" in out
    for line in ("[mesh] dry run", "['cpu', 'cpu', 'cpu', 'cpu']", "[slice] mesh-q", "[mesh] --data-parallel -1"):
        assert line in out, line
