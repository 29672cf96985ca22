"""The event tables' C scan (``build_pair_events_c``,
``panvc3_tpu_torch/ops/csrc_host/event_tables.c``) against the NumPy
``build_pair_events`` it stands in for, and against the JAX package's:
array for array, in dtype and bytes, on word-edge cases and on
chromosome-shaped rows from the benchmark's MSA generator.  Then
``EventGeometry`` on either side of ``PANVC3_EVENT_GEOMETRY_NATIVE``, the
pairs each path builds in a fast-lane call as the counters and the
``[fastlane diag]`` line count them, and the scan's source carried by the
wheel and compiled by an installed port into its cache."""

from __future__ import annotations

import io
import json
import pathlib
import re
import subprocess
import sys
import types
import zipfile

import numpy as np
import pytest

from chip_smoke import build_wheel, installed_env, snapshot, unpack_wheel
from panvc3_tpu.ops import event_geometry as ref_geo
from panvc3_tpu_torch.bitvec import GapBitVector, pack_bits
from panvc3_tpu_torch.ops import event_geometry as geo
from panvc3_tpu_torch.pipeline import fastlane
from panvc3_tpu_torch.pipeline import project_alignments as port
from panvc3_tpu_torch.utils import log_time
from portbench.harness import msa as bench_msa

from .test_fastpath import _rich_sam
from .test_workflow_data import WORKFLOW, founder_seqs, msa_files  # noqa: F401 (fixtures)

REPO = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = "panvc3_tpu_torch"
GENOME = str(WORKFLOW / "genome/genome.fa.gz")
FIELDS = ("gap_start", "gap_end", "del_b", "del_len", "gap_clen", "del_clen")


def _vec(bits) -> GapBitVector:
    bits = np.asarray(bits, np.uint8)
    return GapBitVector(pack_bits(bits), len(bits))


def _words(words, n) -> GapBitVector:
    """A vector whose words may carry bits at or past ``n``."""
    return GapBitVector(np.asarray(words, np.uint32), n)


def _random(rng, n, rate):
    return _vec(rng.random(n) < rate)


def _runs(n, spans):
    """n columns, gaps over the half-open ``spans``."""
    bits = np.zeros(n, np.uint8)
    for a, b in spans:
        bits[a:b] = 1
    return bits


def _case_identical():
    rng = np.random.default_rng(1)
    v = _random(rng, 5000, 0.2)
    return [(v, v), (v, _words(v.words.copy(), v.n)), (_vec(np.zeros(100)), _vec(np.zeros(100)))]


def _case_unequal_lengths():
    rng = np.random.default_rng(2)
    out = []
    for ns, nd in ((1000, 900), (900, 1000), (1024, 1000), (1000, 1024), (33, 64), (5000, 31)):
        out.append((_random(rng, ns, 0.3), _random(rng, nd, 0.25)))
    # set bits at and past n inside the last word, and words past the shorter row
    out.append((_words(rng.integers(0, 2**32, 40, dtype=np.uint64), 1000),
                _words(rng.integers(0, 2**32, 35, dtype=np.uint64), 1100)))
    out.append((_words(rng.integers(0, 2**32, 35, dtype=np.uint64), 1107),
                _words(rng.integers(0, 2**32, 40, dtype=np.uint64), 1090)))
    return out


def _case_word_edges():
    n = 32 * 8
    # gap runs and deletion boundaries across word edges and on bit 31
    src = _runs(n, [(28, 37), (63, 64), (95, 97), (150, 160), (191, 200)])
    dst = _runs(n, [(31, 33), (60, 70), (96, 128), (127, 129), (159, 161), (223, 224)])
    out = [(_vec(src), _vec(dst)), (_vec(dst), _vec(src))]
    # a source-gap run over a word edge splitting a destination-gap run
    src = _runs(n, [(30, 34)])
    dst = _runs(n, [(25, 40)])
    out += [(_vec(src), _vec(dst)), (_vec(dst), _vec(src))]
    # every bit 31 and bit 0 differ
    bits = np.zeros(n, np.uint8)
    bits[31::32] = 1
    bits[0::32] = 1
    out += [(_vec(bits), _vec(np.zeros(n))), (_vec(np.zeros(n)), _vec(bits))]
    return out


def _case_all_gap_words():
    n = 32 * 6
    full = _runs(n, [(32, 96), (160, 192)])
    other = _runs(n, [(0, 32), (64, 128)])
    return [(_vec(full), _vec(np.zeros(n))), (_vec(np.zeros(n)), _vec(full)),
            (_vec(full), _vec(other)), (_vec(other), _vec(full)),
            (_vec(np.ones(n)), _vec(np.zeros(n))), (_vec(np.zeros(n)), _vec(np.ones(n))),
            (_vec(np.ones(n)), _vec(np.ones(n)))]


def _case_first_and_last_column():
    out = []
    for n in (1, 2, 31, 32, 33, 64, 100):
        first, last = np.zeros(n, np.uint8), np.zeros(n, np.uint8)
        first[0] = 1
        last[n - 1] = 1
        both = first | last
        for a, b in ((first, np.zeros(n)), (np.zeros(n), first), (last, np.zeros(n)),
                     (np.zeros(n), last), (both, np.zeros(n)), (np.zeros(n), both)):
            out.append((_vec(a), _vec(b)))
    return out


def _case_random():
    rng = np.random.default_rng(6)
    out = []
    for n, rs, rd in ((7, 0.5, 0.5), (300, 0.05, 0.6), (4096, 0.5, 0.5), (20000, 0.9, 0.1),
                      (20000, 0.02, 0.02), (65537, 0.3, 0.3)):
        out.append((_random(rng, n, rs), _random(rng, n, rd)))
    # runs of gaps, as MSA rows have them
    for _ in range(4):
        n = int(rng.integers(1000, 30000))
        rows = []
        for _ in range(2):
            starts = rng.integers(0, n, n // 40)
            rows.append(_runs(n, [(a, a + int(k)) for a, k in zip(starts, rng.integers(1, 40, starts.size))]))
        out.append((_vec(rows[0]), _vec(rows[1])))
    return out


def _case_chromosome():
    """Every founder row of the benchmark's f4 MSA at 2,097,152 columns
    against the reference row, and the reference against a founder."""
    config = json.loads((REPO / "portbench/configs/grch38_chr21_f4.json").read_text())
    config["msa_columns"] = 2_097_152
    made = bench_msa.Msa(2147489101, config, REPO / "portbench/configs")
    rows = [_vec(made.gap(i)) for i in range(made.n_rows)]
    return [(rows[i], rows[0]) for i in range(1, made.n_rows)] + [(rows[0], rows[1])]


CASES = {
    "identical": _case_identical,
    "unequal_lengths": _case_unequal_lengths,
    "word_edges": _case_word_edges,
    "all_gap_words": _case_all_gap_words,
    "first_and_last_column": _case_first_and_last_column,
    "random": _case_random,
    "chromosome": _case_chromosome,
}


@pytest.mark.parametrize("case", list(CASES))
def test_scan_matches_numpy(case):
    pairs = CASES[case]()
    assert pairs
    events = 0
    for k, (src, dst) in enumerate(pairs):
        got = geo.build_pair_events_c(src, dst)
        for want in (geo.build_pair_events(src, dst), ref_geo.build_pair_events(src, dst)):
            for name in FIELDS:
                g, w = getattr(got, name), getattr(want, name)
                assert g.dtype == w.dtype == np.int64, (k, name)
                assert g.shape == w.shape and g.tobytes() == w.tobytes(), (k, name)
        events += got.gap_start.size + got.del_b.size
    if case == "identical":
        assert events == 0
    else:
        assert events > 0
    if case == "chromosome":
        assert all(geo.build_pair_events_c(s, d).gap_start.size > 1_000 for s, d in pairs[:-1])


def _entries(made):
    return [types.SimpleNamespace(gaps=_vec(made.gap(i))) for i in range(made.n_rows)]


@pytest.mark.parametrize("native", [None, "0"], ids=["unset", "numpy"])
def test_event_geometry_matches_across_the_switch(native, monkeypatch):
    """``EventGeometry``'s tables and ``batch`` answers with the scan and
    the C batch (switch unset) or NumPy for both (``0``) against the JAX
    package's NumPy ``EventGeometry``, with an index-less input reference
    and a pair shared by two of them; ``pairs_built`` counts the distinct
    pairs on the path that built them."""
    if native is None:
        monkeypatch.delenv("PANVC3_EVENT_GEOMETRY_NATIVE", raising=False)
    else:
        monkeypatch.setenv("PANVC3_EVENT_GEOMETRY_NATIVE", native)
    config = json.loads((REPO / "portbench/configs/grch38_chr21_f4.json").read_text())
    config["msa_columns"] = 200_000
    made = bench_msa.Msa(7, config, REPO / "portbench/configs")
    ents = _entries(made)
    src = ents + [None, ents[2]]
    mapping = [0] * len(src)
    got = geo.EventGeometry(src, ents[:1], mapping)
    want = ref_geo.EventGeometry(src, ents[:1], mapping)
    assert (got._native is not None) == (native is None)
    distinct = made.n_rows
    assert got.pairs_built == ({"event_pairs_c": distinct, "event_pairs_numpy": 0} if native is None
                               else {"event_pairs_c": 0, "event_pairs_numpy": distinct})
    assert got.events[made.n_rows] is None and got.events[-1] is got.events[2]
    for g, w in zip(got.events, want.events):
        assert (g is None) == (w is None)
        if g is not None:
            for name in FIELDS:
                assert getattr(g, name).tobytes() == getattr(w, name).tobytes(), name
    rng = np.random.default_rng(3)
    B = 400
    ref_ids = rng.choice([0, 1, 2, 3, 4, 6], B).astype(np.int32)
    pos = rng.integers(0, 150_000, B).astype(np.int32)
    for R, K in ((128, 8), (256, 8), (512, 8)):
        units = rng.integers(1, R + 1, B).astype(np.int32)
        for g, w in zip(got.batch(ref_ids, pos, units, R, K), want.batch(ref_ids, pos, units, R, K)):
            g, w = np.asarray(g), np.asarray(w)
            assert g.dtype == w.dtype and np.array_equal(g, w)


SWITCHES = ("PANVC3_FASTLANE_PROF", "PANVC3_EVENT_GEOMETRY", "PANVC3_EVENT_GEOMETRY_NATIVE")


@pytest.mark.parametrize("route", ["host", "device", "gap_kernel"])
@pytest.mark.parametrize("native", [None, "0"], ids=["unset", "numpy"])
def test_fastlane_counts_the_pairs_each_path_builds(msa_files, founder_seqs, monkeypatch,  # noqa: F811
                                                    native, route):
    """Two traced fast-lane calls: ``AGG_DIAG`` gains the distinct pairs of
    each call on the path that built them, and each call's
    ``[fastlane diag]`` line shows that call's own counts.  The gap
    kernel's route builds no tables."""
    index_path, _, _ = msa_files
    sam = _rich_sam(founder_seqs, n_reads=120, seed=5)
    n_refs = sam.count(b"@SQ\t")
    assert n_refs == 5
    logged = io.StringIO()
    for module in (port, fastlane):
        monkeypatch.setattr(module, "log_time", lambda msg, file=None: log_time(msg, file=logged))
    for key in SWITCHES:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("PANVC3_FASTLANE_PROF", "1")
    monkeypatch.setenv("PANVC3_EVENT_GEOMETRY", {"host": "1", "device": "device", "gap_kernel": "0"}[route])
    if native is not None:
        monkeypatch.setenv("PANVC3_EVENT_GEOMETRY_NATIVE", native)
    cfg = port.ProjectConfig(
        msa_index_path=str(index_path), reference_path=GENOME, reference_msa_id="REF",
        ref_id_separator="/", engine="device", device_batch_size=32, status_output_interval=0,
    )
    built = 0 if route == "gap_kernel" else n_refs
    want = {"event_pairs_c": built if native is None else 0,
            "event_pairs_numpy": 0 if native is None else built}
    outs = []
    for _ in range(2):
        before = dict(fastlane.AGG_DIAG)
        out = io.BytesIO()
        port.run_project_alignments(io.BytesIO(sam), out, cfg, device="cpu")
        outs.append(out.getvalue())
        assert {k: fastlane.AGG_DIAG[k] - before[k] for k in want} == want
    lines = re.findall(r"\[fastlane diag\] (\{.*\})", logged.getvalue())
    assert len(lines) == 2
    for line in lines:
        diag = json.loads(line)
        assert {k: diag[k] for k in want} == want
    assert outs[0] == outs[1] and outs[0].count(b"\n") > 100


@pytest.fixture(scope="module")
def installed(tmp_path_factory):
    """(wheel, target, cache, a working directory outside the checkout)."""
    root = tmp_path_factory.mktemp("scan-install")
    wheel = build_wheel(root / "wheel")
    target = root / "site"
    unpack_wheel(wheel, target)
    run = root / "run"
    run.mkdir()
    return wheel, target, root / "cache", run


def test_wheel_carries_the_scan_source(installed):
    wheel = installed[0]
    with zipfile.ZipFile(wheel) as zf:
        name = f"{PACKAGE}/ops/csrc_host/{geo.SCAN_SOURCE.name}"
        assert zf.read(name) == geo.SCAN_SOURCE.read_bytes()


INSTALLED_SCAN = """
import json, sys
import numpy as np
from panvc3_tpu_torch.bitvec import GapBitVector, pack_bits
from panvc3_tpu_torch.ops import event_geometry as geo
rng = np.random.default_rng(9)
src = GapBitVector(pack_bits(rng.random(70000) < 0.2), 70000)
dst = GapBitVector(pack_bits(rng.random(70000) < 0.3), 70000)
got, want = geo.build_pair_events_c(src, dst), geo.build_pair_events(src, dst)
same = all(getattr(got, k).tobytes() == getattr(want, k).tobytes()
           for k in ("gap_start", "gap_end", "del_b", "del_len", "gap_clen", "del_clen"))
print(json.dumps({"module": geo.__file__, "library": str(geo.scan_library()),
                  "same": same, "events": int(got.gap_start.size + got.del_b.size)}))
"""


def test_installed_port_compiles_the_scan_into_its_cache(installed):
    _, target, cache, run = installed
    before = snapshot(target)
    proc = subprocess.run([sys.executable, "-c", INSTALLED_SCAN], env=installed_env(target, cache),
                          cwd=run, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    info = json.loads(proc.stdout.strip().splitlines()[-1])
    assert pathlib.Path(info["module"]).parent == target / PACKAGE / "ops"
    library = pathlib.Path(info["library"])
    assert library.parent.parent == cache / PACKAGE / "host"
    assert library.is_file() and info["same"] and info["events"] > 1000
    assert list((cache / PACKAGE / "host").glob("*/libevent_tables.so")) == [library]
    assert snapshot(target) == before
