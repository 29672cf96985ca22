"""The port's two opt-in switches against ``panvc3_tpu``.

``PANVC3_MALDE_EXACT=1`` scores the host oracle's quality (``-q``) DP in
unquantised float64, the reference's arithmetic: through ``align_global``
the scores must equal ``panvc3_tpu``'s to the last bit, and ``--engine host
-q`` through both CLIs must give the same bytes, on an input whose output
the switch changes (the port ignored it before, so it gave the quantised
bytes there).  ``PANVC3_LANE_MIX=1`` is ``LaneController``'s graduated
duty: one seeded stream of batches, lane timings and emits near a tie
through both controllers must give the same decisions, with the switch set
and unset, and the stream must reach the graduated duty.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from chip_smoke import strip_pg
from panvc3_tpu import align as ref_align
from panvc3_tpu.alphabet import PHRED42_MAX
from panvc3_tpu.pipeline import fastlane as ref_fastlane
from panvc3_tpu_torch import align as port_align
from panvc3_tpu_torch import synth
from panvc3_tpu_torch.pipeline import fastlane as port_fastlane

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("exact", ["1", None], ids=["exact", "quantised"])
def test_align_global_malde_cases_match(exact, monkeypatch):
    """``tests/test_projector.py``'s random Malde cases (seed 42, gap costs
    -6/-1, reference qualities pinned to the maximum) through both
    oracles: equal CIGARs, and scores equal to the last bit."""
    if exact:
        monkeypatch.setenv("PANVC3_MALDE_EXACT", exact)
    else:
        monkeypatch.delenv("PANVC3_MALDE_EXACT", raising=False)
    rng = np.random.default_rng(42)
    letters = np.frombuffer(b"ACGT", np.uint8)
    unquantised = 0
    for _ in range(60):
        n = int(rng.integers(1, 14))
        m = int(rng.integers(1, 14))
        seq1 = bytes(rng.choice(letters, n))
        seq2 = bytes(rng.choice(letters, m))
        q1 = np.full(n, PHRED42_MAX, np.int32)
        q2 = rng.integers(2, 42, m).astype(np.int32)
        s_ref, c_ref = ref_align.align_global(seq1, seq2, -6, -1, q1, q2)
        s_port, c_port = port_align.align_global(seq1, seq2, -6, -1, q1, q2)
        assert c_port == c_ref
        assert s_port.hex() == s_ref.hex()
        unquantised += s_ref * 256 != round(s_ref * 256)
    assert (unquantised > 0) == bool(exact)


def test_malde_exact_unquantised_score(monkeypatch):
    """``tests/test_projector.py``'s irrational-optimum case: the exact
    float64 Malde score, bit for bit the reference's."""
    monkeypatch.setenv("PANVC3_MALDE_EXACT", "1")
    q1 = np.full(4, PHRED42_MAX, np.int32)
    q2 = np.asarray([10, 20, 30, 40], np.int32)
    got = port_align.align_global(b"ACGT", b"ACGT", -6, -1, q1, q2)
    assert got == ref_align.align_global(b"ACGT", b"ACGT", -6, -1, q1, q2)
    want = sum(port_align.malde_score(True, PHRED42_MAX, int(q)) for q in q2)
    assert got[0] == want and got[1] == [(4, "=")]
    for matches in (True, False):
        for q in (2, 17, 41):
            assert port_align.malde_score(matches, PHRED42_MAX, q) == ref_align.malde_score(
                matches, PHRED42_MAX, q
            )


def test_malde_exact_host_cli_matches_jax(tmp_path):
    """``project_alignments --engine host -q`` under ``PANVC3_MALDE_EXACT=1``
    through both CLIs: the same bytes, @PG aside.  The input's 48I48D runs
    with seeded phreds hold near-ties, so the switch changes the output."""
    rows = synth.make_msa(50_000, seed=3)
    index_path, fasta_path, founders = synth.write_inputs(tmp_path, "c1", rows)
    sam = tmp_path / "in.sam"
    sam.write_bytes(synth.reads_sam("c1", founders, 64, seed=0, qualities=True))
    env = {k: v for k, v in os.environ.items() if not k.startswith("PANVC3_")}
    env.update(PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    outs = {}
    for package, extra in (("panvc3_tpu", []), ("panvc3_tpu_torch", ["--device", "cpu"])):
        for exact in ("0", "1"):
            out = tmp_path / f"{package}-{exact}.sam"
            proc = subprocess.run(
                [sys.executable, "-m", package, "project_alignments", "-a", str(sam),
                 "-m", str(index_path), "-r", str(fasta_path), "-d", "REF", "-s", "/",
                 "--engine", "host", "-q", "--status-output-interval", "0", "-o", str(out),
                 *extra],
                env=dict(env, PANVC3_MALDE_EXACT=exact), cwd=tmp_path,
                capture_output=True, text=True, timeout=300,
            )
            assert proc.returncode == 0, proc.stderr
            outs[package, exact] = strip_pg(out.read_bytes())
    assert outs["panvc3_tpu", "1"] != outs["panvc3_tpu", "0"]
    assert outs["panvc3_tpu_torch", "1"] == outs["panvc3_tpu", "1"]
    assert outs["panvc3_tpu_torch", "0"] == outs["panvc3_tpu", "0"]


def _lane_stream(ctrls, seed: int) -> list[bool]:
    """Feed one seeded stream to every controller in ``ctrls``; the lane
    each picked (True: host), asserted equal across them, per batch."""
    rng = np.random.default_rng(seed)
    picks = []
    now = 0
    host_rate = 2000.0
    for step in range(1500):
        # the lanes' rates cross the graduated duty's bands: within 1.15,
        # within 1.5 and beyond, in turns of 300 batches
        dev_rate = host_rate * (1.08, 1.3, 2.5, 0.9, 1.4)[step // 300]
        cells = int(rng.integers(1_000_000, 8_000_000))
        reads = int(rng.integers(1000, 9000))
        got = [c.decide(cells) for c in ctrls]
        assert len(set(got)) == 1, step
        host = got[0]
        picks.append(host)
        ns = int(reads * (host_rate if host else dev_rate) * rng.uniform(0.9, 1.1))
        now += ns
        for c in ctrls:
            if host:
                c.observe_host_dp(ns * 0.5, cells)
            else:
                c.observe_dev_batch(ns * 0.7)
            c.observe_emit(not host, reads, now, attribute=True, cells=cells)
    return picks


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("mix", ["1", None], ids=["lane-mix", "unset"])
def test_lane_controller_lane_mix_matches(mix, seed, monkeypatch):
    monkeypatch.delenv("PANVC3_LANE_MIX", raising=False)
    plain = _lane_stream([ref_fastlane.LaneController()], seed)
    if mix:
        monkeypatch.setenv("PANVC3_LANE_MIX", mix)
    ctrls = [ref_fastlane.LaneController(), port_fastlane.LaneController()]
    picks = _lane_stream(ctrls, seed)
    a, b = ctrls
    assert (a.mode, a.tick, a.backoff, a.span_count) == (b.mode, b.tick, b.backoff, b.span_count)
    assert a.ns_read == b.ns_read
    assert a.host_ns_cell == b.host_ns_cell and a.dev_ns_batch == b.dev_ns_batch
    # the switch changes the decisions on this stream: it reaches the
    # graduated duty
    assert (picks != plain) == bool(mix)
