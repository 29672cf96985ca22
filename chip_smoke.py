#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (panvc3_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure raises and exits non-zero:

1. environment: a CUDA device is required; prints the card's name and
   power limit (nvidia-smi);
2. builds: compiles the CUDA kernel (nvcc, sm_90a) and the C host
   extension from the checkout's sources, printing the seconds each took;
3. kernel vs plain version on the card: the fused realignment DP on
   16384 runs of 48x48 (the aggregate window the main path dispatches),
   2048 runs of 128x128 and every integer tie-break fixture, byte-equal to
   the plain PyTorch version, with both timed;
4. the project_alignments slice at chromosome scale: a synthetic founder
   MSA with the 46,709,983 columns of GRCh38 chr21 (REF + 4 founders, 2%
   gap columns each) and 262,144 reads of 100 bp, projected as one process
   of the multi-host layout projects one chromosome shard
   (--msa-index-chr-shard 0/1).  After a warm-up run and a one-read setup
   probe, run 1 forces the device lane (PANVC3_HOST_DP=0) and must launch
   the kernel through the ref-gather wires; run 2 forces the host C DP
   lane; their SAM output must be equal.

The second-to-last line is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}.  Every timing is printed beside the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
KERNEL_SOURCE = "panvc3_tpu_torch/ops/csrc/realign_fused.cu"
KERNEL_REPLACES = "panvc3_tpu/ops/realign_pallas_fused.py:69"
CHR21_COLUMNS = 46_709_983
N_READS = 262_144
OPS = {7: "=", 8: "X", 1: "I", 2: "D"}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def random_runs(rng, B, Q, R):
    import numpy as np
    import torch

    letters = np.frombuffer(b"ACGT", np.uint8)
    ref = rng.choice(letters, (B, R)).astype(np.uint8)
    qry = rng.choice(letters, (B, Q)).astype(np.uint8)
    n = rng.integers(0, R + 1, B).astype(np.int32)
    m = rng.integers(0, Q + 1, B).astype(np.int32)
    n[:3] = [0, R, R]
    m[:3] = [Q, 0, Q]
    return [torch.from_numpy(a).cuda() for a in (ref, qry, m, n)]


def fixture_runs():
    """Integer tie-break fixtures grouped by gap costs: (go, ge, tensors,
    locked CIGARs)."""
    import numpy as np
    import torch

    groups: dict[tuple[int, int], list] = {}
    path = ROOT / "tests/data/tiebreak_fixtures.tsv"
    for line in path.read_text().splitlines():
        if not line or line.startswith("#"):
            continue
        _kind, go, ge, s1, s2, quals, _score, cigar = line.split("\t")
        if quals == "-":
            groups.setdefault((int(go), int(ge)), []).append((s1, s2, cigar))
    out = []
    for (go, ge), rows in groups.items():
        R = max(len(r[0]) for r in rows)
        Q = max(len(r[1]) for r in rows)
        ref = np.zeros((len(rows), R), np.uint8)
        qry = np.zeros((len(rows), Q), np.uint8)
        n = np.zeros(len(rows), np.int32)
        m = np.zeros(len(rows), np.int32)
        for b, (s1, s2, _) in enumerate(rows):
            ref[b, :len(s1)] = np.frombuffer(s1.encode(), np.uint8)
            qry[b, :len(s2)] = np.frombuffer(s2.encode(), np.uint8)
            n[b], m[b] = len(s1), len(s2)
        tensors = [torch.from_numpy(a).cuda() for a in (ref, qry, m, n)]
        out.append((go, ge, tensors, R, Q, [r[2] for r in rows]))
    return out


def cigar_string(ops_row, k: int) -> str:
    out: list[list] = []
    for code in reversed(ops_row[:k]):
        ch = OPS[int(code)]
        if out and out[-1][1] == ch:
            out[-1][0] += 1
        else:
            out.append([1, ch])
    return "".join(f"{n}{c}" for n, c in out)


def phase_kernel(card: str) -> dict:
    import numpy as np
    import torch

    from panvc3_tpu_torch.ops.realign_pallas_fused import (
        realign_fused,
        realign_fused_reference,
    )

    rng = np.random.default_rng(1)
    max_err = 0
    timing = {}
    for B, Q, R in ((16384, 48, 48), (2048, 128, 128)):
        args = random_runs(rng, B, Q, R)
        ops, cnt = realign_fused(*args, 0.0, -1.0, R, Q)
        ref_ops, ref_cnt = realign_fused_reference(*args, 0.0, -1.0, R, Q)
        torch.cuda.synchronize()
        err = max(
            int((ops.int() - ref_ops.int()).abs().max()),
            int((cnt - ref_cnt).abs().max()),
        )
        max_err = max(max_err, err)
        if err:
            raise AssertionError(f"kernel != plain version at {(B, Q, R)}: max |diff| {err}")
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        iters = 20
        start.record()
        for _ in range(iters):
            realign_fused(*args, 0.0, -1.0, R, Q)
        stop.record()
        torch.cuda.synchronize()
        k_ms = start.elapsed_time(stop) / iters
        start.record()
        for _ in range(2):
            realign_fused_reference(*args, 0.0, -1.0, R, Q)
        stop.record()
        torch.cuda.synchronize()
        p_ms = start.elapsed_time(stop) / 2
        timing[(B, Q, R)] = (k_ms, p_ms)
        log(
            f"[kernel] B={B} Q={Q} R={R}: kernel == plain (byte-equal); "
            f"kernel {k_ms:.4f} ms, plain PyTorch {p_ms:.3f} ms ({card})"
        )
    n_fix = 0
    for go, ge, args, R, Q, cigars in fixture_runs():
        ops, cnt = realign_fused(*args, go, ge, R, Q)
        ref_ops, ref_cnt = realign_fused_reference(*args, go, ge, R, Q)
        if not (torch.equal(ops, ref_ops) and torch.equal(cnt, ref_cnt)):
            raise AssertionError(f"kernel != plain version on fixtures go={go} ge={ge}")
        ops_h, cnt_h = ops.cpu().numpy(), cnt.cpu().numpy()
        for b, want in enumerate(cigars):
            got = cigar_string(ops_h[b], int(cnt_h[b]))
            if got != want:
                raise AssertionError(f"fixture {b} go={go} ge={ge}: {got} != {want}")
        n_fix += len(cigars)
    log(f"[kernel] {n_fix} integer tie-break fixtures: kernel == plain == locked CIGARs")
    return {"max_abs_err": max_err, "timing": timing}


def strip_pg(sam: bytes) -> bytes:
    return b"\n".join(ln for ln in sam.split(b"\n") if not ln.startswith(b"@PG"))


def phase_slice(card: str, seed: int, work: pathlib.Path) -> dict:
    import torch

    from panvc3_tpu_torch import synth
    from panvc3_tpu_torch.cli.main import main as cli_main
    from panvc3_tpu_torch.ops import realign_pallas_fused
    from panvc3_tpu_torch.pipeline import fastlane

    t0 = time.perf_counter()
    rows = synth.make_msa(CHR21_COLUMNS, seed)
    index_path, fasta_path, founders = synth.write_inputs(work, "chr21", rows)
    del rows
    sam_path = work / "reads.sam"
    sam_path.write_bytes(synth.reads_sam("chr21", founders, N_READS, seed + 1))
    one_read = work / "one_read.sam"
    one_read.write_bytes(synth.reads_sam("chr21", founders, 1, seed + 1))
    del founders
    log(
        f"[slice] inputs: {CHR21_COLUMNS} MSA columns x {len(synth.SEQ_IDS)} rows, "
        f"{N_READS} reads of 100 bp ({time.perf_counter() - t0:.1f} s to make)"
    )

    def run(tag: str, env: dict, sam: pathlib.Path = sam_path) -> tuple[bytes, float]:
        for key in ("PANVC3_HOST_DP", "PANVC3_HOST_DP_CELLS"):
            os.environ.pop(key, None)
        os.environ.update(env)
        out_path = work / f"{tag}.sam"
        argv = [
            "project_alignments", "--device", "cuda",
            "-a", str(sam), "-m", str(index_path), "-r", str(fasta_path),
            "-d", "REF", "-s", "/", "--msa-index-chr-shard", "0/1",
            "-o", str(out_path), "--status-output-interval", "0",
        ]
        t1 = time.perf_counter()
        rc = cli_main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        if rc != 0:
            raise RuntimeError(f"project_alignments ({tag}) exited {rc}")
        return out_path.read_bytes(), wall

    # warm-up: the first device-lane run in a process also pays one-time
    # costs (lazy loading of PyTorch's kernels, the first pinned buffers)
    _, cold_wall = run("cold", {"PANVC3_HOST_DP": "0"})
    # setup probe: the same index and reference with one read (no
    # realignment); its wall time is the tool's fixed cost per call (index
    # load, event tables, FASTA parse, flat-reference upload)
    _, setup_wall = run("setup", {"PANVC3_HOST_DP": "0"}, one_read)
    log(
        f"[slice] first device-lane run in the process {cold_wall:.2f} s; "
        f"setup probe (1 read) {setup_wall:.2f} s ({card})"
    )

    # run 1: every realignment on the device lane; counts start at 0 here
    realign_pallas_fused.reset_launches()
    for key in fastlane.AGG_DIAG:
        fastlane.AGG_DIAG[key] = 0
    torch.cuda.reset_peak_memory_stats()
    dev_sam, dev_wall = run("device", {"PANVC3_HOST_DP": "0"})
    launches = realign_pallas_fused.LAUNCHES
    diag = dict(fastlane.AGG_DIAG)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    log(f"[slice] device lane: kernel launches {launches}, aggregate diag {json.dumps(diag)}")
    if launches <= 0 or diag["refgather"] <= 0 or diag["wire2"] <= 0:
        raise AssertionError("the device lane did not go through the kernel and the ref-gather wires")

    host_sam, host_wall = run("host", {"PANVC3_HOST_DP_CELLS": str(10**18)})
    n_out = sum(1 for ln in dev_sam.split(b"\n") if ln and not ln.startswith(b"@"))
    if n_out != N_READS:
        raise AssertionError(f"device lane wrote {n_out} records, expected {N_READS}")
    if strip_pg(dev_sam) != strip_pg(host_sam):
        raise AssertionError("device-lane SAM differs from host-lane SAM")
    log(f"[slice] device-lane SAM == host-lane SAM ({n_out} records, @PG stripped)")
    log(
        f"[slice] device lane {N_READS / dev_wall:.0f} reads/s ({dev_wall:.2f} s), "
        f"host lane {N_READS / host_wall:.0f} reads/s ({host_wall:.2f} s), "
        f"wall time of the whole tool run incl. index/FASTA load; "
        f"peak device memory {peak_mb:.1f} MiB ({card})"
    )
    return {"launches": launches}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    # per-stage timings of the fast lane, printed to stderr by each run
    os.environ["PANVC3_FASTLANE_PROF"] = "1"

    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"[env] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    from panvc3_tpu_torch import native
    from panvc3_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    _kernels.kernel("realign_fused_int")
    t_kernel = time.perf_counter() - t0
    t0 = time.perf_counter()
    native.get_native()
    t_native = time.perf_counter() - t0
    log(f"[build] CUDA kernel {t_kernel:.1f} s (nvcc, sm_90a), C host extension {t_native:.1f} s")
    log(_kernels.BUILD_LOG.get("realign_fused.cu", "").strip())

    kern = phase_kernel(card)
    work = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke-"))
    try:
        slice_res = phase_slice(card, args.seed, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    k_ms, p_ms = kern["timing"][(16384, 48, 48)]
    log(json.dumps({"kernels": [{
        "name": "realign_fused_int",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": slice_res["launches"],
        "max_abs_err": kern["max_abs_err"],
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    log(card_line())
    if "jax" in sys.modules:
        raise AssertionError("JAX was imported")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
