"""Card-only tests of the port: the CUDA kernel against its plain version.

Every test here needs an NVIDIA GPU and ``nvcc`` and skips without them.
The module imports no JAX, so on a machine with a card and no JAX it runs
without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q
"""

from __future__ import annotations

import io

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc for the hand-written kernel")
    return torch.device("cuda")


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


@pytest.mark.parametrize(
    "B,Q,R,go,ge",
    [
        (300, 16, 16, -6, -1),
        (4096, 48, 48, 0, -1),
        (512, 128, 128, -6, -1),
        (33, 7, 29, -3, -2),
        (1, 1, 1, 0, -1),
    ],
)
def test_kernel_matches_plain_version(cuda, B, Q, R, go, ge):
    from panvc3_tpu_torch.ops import realign_pallas_fused as rpf

    args = [t.to(cuda) for t in _runs(np.random.default_rng(B + Q + R), B, Q, R)]
    before = rpf.LAUNCHES
    ops, cnt = rpf.realign_fused(*args, go, ge, R, Q)
    assert rpf.LAUNCHES == before + 1
    want_ops, want_cnt = rpf.realign_fused_reference(*args, go, ge, R, Q)
    torch.cuda.synchronize()
    assert torch.equal(ops, want_ops)
    assert torch.equal(cnt, want_cnt)


def test_kernel_rejects_mixed_devices(cuda):
    from panvc3_tpu_torch.ops.realign_pallas_fused import realign_fused

    ref, qry, m, n = _runs(np.random.default_rng(0), 8, 8, 8)
    with pytest.raises(ValueError, match="is on"):
        realign_fused(ref.to(cuda), qry.to(cuda), m, n.to(cuda), 0, -1, 8, 8)


@pytest.mark.parametrize("wire", ["classic", "refgather", "refgather2"])
def test_wires_on_card_match_cpu(cuda, wire):
    from panvc3_tpu_torch.ops import realign_batch as trb

    rng = np.random.default_rng(3)
    S, R, Q = 2000, 48, 48
    rl = rng.integers(0, R + 1, S).astype(np.int32)
    ql = rng.integers(0, Q + 1, S).astype(np.int32)
    qry = rng.choice(np.frombuffer(b"ACGT", np.uint8), (S, Q)).astype(np.uint8)
    qry = np.where(np.arange(Q)[None, :] < ql[:, None], qry, 0).astype(np.uint8)
    flat = torch.from_numpy(rng.choice(np.frombuffer(b"ACGTacgtNn", np.uint8), 9000))
    start = rng.integers(0, 9000, S).astype(np.int64)
    if wire == "classic":
        ref = rng.choice(np.frombuffer(b"ACGTN", np.uint8), (S, R)).astype(np.uint8)
        ref = np.where(np.arange(R)[None, :] < rl[:, None], ref, 0).astype(np.uint8)
        packed = torch.from_numpy(trb.pack_realign_wire_input(ref, qry, rl, ql))
        run = lambda p, f: trb._realign_wire(p, 0.0, -1.0, R, Q)  # noqa: E731
    elif wire == "refgather":
        packed = torch.from_numpy(trb.pack_realign_refgather_input(qry, start, rl, ql))
        run = lambda p, f: trb._realign_wire_refgather(p, f, 0.0, -1.0, R, Q)  # noqa: E731
    else:
        packed = torch.from_numpy(trb.pack_realign_refgather2_input(qry, start, rl, ql))
        run = lambda p, f: trb._realign_wire_refgather2(p, f, 0.0, -1.0, R, Q)  # noqa: E731
    got = run(packed.to(cuda), flat.to(cuda)).cpu()
    want = run(packed, flat)
    assert torch.equal(got, want)


@pytest.mark.parametrize("chaos", [None, "5"], ids=["plain", "chaos"])
def test_slice_on_card_matches_cpu(cuda, tmp_path, monkeypatch, chaos):
    """The whole fast lane on the device lane, card vs CPU: pinned
    copies, events and the fetch pool on the card path, also under
    scheduling jitter at every cross-thread handoff."""
    from panvc3_tpu.pipeline.project_alignments import ProjectConfig
    from panvc3_tpu_torch import synth
    from panvc3_tpu_torch.ops import realign_pallas_fused as rpf
    from panvc3_tpu_torch.pipeline import fastlane
    from panvc3_tpu_torch.pipeline.project_alignments import run_project_alignments

    rows = synth.make_msa(300_000, seed=5)
    index_path, fasta_path, founders = synth.write_inputs(tmp_path, "c1", rows)
    sam = synth.reads_sam("c1", founders, 6000, seed=6)
    monkeypatch.setenv("PANVC3_HOST_DP", "0")
    outs = {}
    for dev in ("cpu", "cuda"):
        if chaos and dev == "cuda":
            monkeypatch.setenv("PANVC3_FASTLANE_CHAOS", chaos)
        cfg = ProjectConfig(
            msa_index_path=str(index_path), reference_path=str(fasta_path),
            reference_msa_id="REF", ref_id_separator="/", engine="device",
            device_batch_size=1024, status_output_interval=0,
        )
        before = (rpf.LAUNCHES, fastlane.AGG_DIAG["wire2"])
        out = io.BytesIO()
        run_project_alignments(io.BytesIO(sam), out, cfg, device=dev)
        outs[dev] = out.getvalue()
        launched = rpf.LAUNCHES - before[0]
        assert fastlane.AGG_DIAG["wire2"] > before[1]
        assert (launched > 0) == (dev == "cuda")
    assert outs["cuda"] == outs["cpu"]
