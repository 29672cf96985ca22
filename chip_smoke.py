#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (panvc3_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure raises and exits non-zero:

1. environment: a CUDA device is required; prints the card's name and
   power limit (nvidia-smi);
2. builds: compiles the three CUDA sources (nvcc, sm_90a, one process
   each, in parallel) and the C host extension from the checkout's
   sources, printing the seconds each took;
3. kernels vs plain versions on the card, byte-equal, both timed, each
   beside its bound: K1's integer and quality entries on 16384 runs all
   48x48 (the aggregate window the main path dispatches, length-sorted),
   16384 runs of random lengths up to 48x48 and 2048 of up to 128x128,
   its substitution entry on 4096 runs of 48x48 with an explicit
   reference-quality tile, its integer entry also on 4096 full runs of
   16x16 (the fused engines' slot pool) and 8192 runs of up to 64x64 (the
   object path's padded 48I48D runs), K2's fill on the three shapes of
   K1's two entries, on 512 runs of 16x16 (the fused engines' split
   route) and at the edges of its schedule (every trace cell), the
   traceback kernel on K2's traces at those shapes and edges and at its
   own plan's edges (TB_EDGE_CASES: both schedules, B = 1 and 77, offset
   views, random-byte traces with lengths inside and around the run;
   every op and count), and the locked tie-break fixtures (integer ones
   through K1, quality ones through K1's quality entry and through K2
   plus the traceback kernel).  Each traceback row prints its time with
   L2 warm and flushed (a 64 MiB write before each launch), its plan
   (runs per group, walking warps, shared bytes, schedule) and the bytes it
   staged with their rate.  Timed loops are queued behind a sleep kernel,
   so that they measure device time.  A bound is the larger of the operations
   the inputs need (12 f32 operations per DP cell, at 33.5 T op/s: the
   H100's 67 TFLOP/s FP32 counts an FMA as two; 20 integer operations per
   traceback step, at 16.75 T op/s, half the FP32 lanes) and the bytes
   moved at 3.35 TB/s: the input bytes the runs' lengths make the function
   read (K1: each run's m query and n reference bytes, m phreds or m x n
   scores; K2: the score rows 1..m at every column; the traceback: the
   trace cell each step reads and the query and reference byte of each
   diagonal step) and every output byte, each once;
4. the project_alignments slice at chromosome scale: a synthetic founder
   MSA with the 46,709,983 columns of GRCh38 chr21 (REF + 4 founders, 2%
   gap columns each) and 262,144 reads of 100 bp, projected as one process
   of the multi-host layout projects one chromosome shard
   (--msa-index-chr-shard 0/1).  After a warm-up run and a one-read setup
   probe, run 1 forces the device lane (PANVC3_HOST_DP=0) and must launch
   K1's integer entry through the ref-gather wires; run 2 forces the host
   C DP lane; their SAM output must be equal;
5. the same slice with quality scoring (project_alignments -q) on the same
   MSA and reads, now with seeded phreds: (a) the device lane must launch
   K1's quality entry through the ref-gather and 2-bit wires, (b) the
   split route (PANVC3_PALLAS_FUSED=0) must launch K2 and the traceback
   kernel, once each per dispatch, and nothing else, (c) the host C DP
   lane with the Malde tables; the three SAMs must be equal;
6. batch realignment with explicit reference qualities (the library entry
   realign_batch) on the card must launch K1's substitution entry and
   give the host C DP's CIGARs;
7. the device geometry routes and the object path on the same MSA and
   reads, every row on the device lane: (a) the fast lane with
   PANVC3_EVENT_GEOMETRY=0 (the gap kernel over the device gap index,
   whose build time and table size it prints), (b) the fast lane with
   PANVC3_EVENT_GEOMETRY=device (the device event geometry; it prints how
   many batches overflowed to the host event path), (c) the object path
   (ProjectConfig(fastlane=False), parsed records through BatchProjector)
   and (d) the object path under -q, both in-process through
   run_project_alignments on the first 65,536 reads.  The SAMs of (a) and
   (b) must equal phase 4's device-lane SAM, that of (c) its first 65,536
   records and that of (d) those of phase 5's; (c) and (d) must launch
   K1's integer and quality entries;
8. the nine tools, all through panvc3_tpu_torch.cli.main.main on the same
   MSA: (a) index_msa --build-index from the rows as the tool reads them
   (its index must equal the one of phase 4 array by array) and
   --list-contents; (b) project_alignments -B -b on the device lane, BAM in
   and BAM out, integer and -q (the records read back must equal the SAMs
   of phases 4 and 5, and K1 must launch), and one object-path BAM row on
   8,192 reads (the Python BAM encoder); (c) recalculate_mapq on 65,536
   read pairs aligned to all four founders and projected by (b)'s route,
   with --jobs 1 and --jobs 4 (which must spawn: a CUDA context is live),
   and with PANVC3_MAPQ_FAST=0 on a 1/16 sample, all equal, nothing
   allocated or launched on the card; (d) split_alignments_by_reference,
   subset_alignments, rewrite_cigar, alignment_statistics,
   count_supporting_reads and convert_bed_positions on the projected
   output, each with its switch on and, on a sample, =0, and SAM against
   BAM where the tool writes alignments.  Any inequality raises;
9. the fused engines through the CLI with PANVC3_ENGINE_LANE=fused (the
   object path's fused lane): (a) the first 65,536 reads at the default
   batch (mostly v4's event overflow to v3, or the host path for 48I48D
   runs), (b) the 65,536 even-numbered reads (the mixed kinds, whose runs
   fit 16x16) at --device-batch-size 1024, where v4's own DP must answer
   and launch K1, (c) (b) under PANVC3_FUSED_EVENT=0 (v3 throughout), (d)
   (b) under PANVC3_PALLAS_FUSED=0 (K2 and the traceback kernel, no K1);
   each SAM must equal the same records of phase 4's device-lane SAM.  Each
   row prints its routes, launches, build seconds, the device-to-host probe
   and what the engine-lane arbiter picks unforced on this host;
10. the mesh (--data-parallel): (a) the dry run, v4 on the first batch of
   1,024 of phase 9 (b)'s reads on which its own DP answers, sharded over
   [cuda:0] * 2, [cuda:0] * 4 and every visible card when there are
   several, every output byte-equal to the unsharded call, with K1's
   launches per shard and device ms per launch; (b) the CLI with
   --data-parallel -1 on phase 7's 65,536 reads, integer and -q, whose
   SAMs must equal phase 7 (c)'s and (d)'s; (c) the library with
   fused_kernel=True, data_parallel=-1 and device=[cuda:0, cuda:0] on
   phase 9 (b)'s reads at 1,024 per batch, whose SAM and route counts must
   equal phase 9 (b)'s, v4's own DP answering;
11. the installed port: (a) the distribution's wheel, built by pip from the
   checkout (no network) and unpacked into a temporary target, runs
   panvc3_torch_project_alignments, the console script its
   entry_points.txt names, on phase 4's MSA and reads on the device lane,
   in a process whose PYTHONPATH is the target alone, from outside the
   checkout, with a temporary XDG_CACHE_HOME: the C extension and both
   CUDA sources build cold into that cache (seconds printed), the SAM must
   equal phase 4's device-lane SAM and K1 must launch; (b) the port's test
   workflow (the Snakefile the wheel carries): its three panvc3 rules
   through the installed commands on the bundled reads (moved onto the
   founders by synth.founder_alignments, the aligner's stand-in; the
   samtools sorts in Python), with device cuda and cpu: equal final SAMs,
   K1 launched on the card.  Nothing may be written under the target or
   the checkout's build/.

Launch counts are set to 0 just before each path of phases 4-10 and read
just after it; phase 11's come from its processes' [fastlane diag] lines.  The kernels' JSON summary and the card's name and power
limit come before the last line, which is {"ok": true, "device": {...}}.
Every timing is printed beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import compileall
import configparser
import gzip
import io
import json
import os
import pathlib
import re
import shlex
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import zipfile

ROOT = pathlib.Path(__file__).resolve().parent
FUSED_SOURCE = "panvc3_tpu_torch/ops/csrc/realign_fused.cu"
FILL_SOURCE = "panvc3_tpu_torch/ops/csrc/realign_fill.cu"
TRACEBACK_SOURCE = "panvc3_tpu_torch/ops/csrc/realign_traceback.cu"
K1_REPLACES = "panvc3_tpu/ops/realign_pallas_fused.py:69"
K2_REPLACES = "panvc3_tpu/ops/realign_pallas.py:37"
# an XLA lax.scan in the JAX package, not a Pallas kernel
TRACEBACK_REPLACES = "panvc3_tpu/ops/realign_batch.py:180"
CHR21_COLUMNS = 46_709_983
N_READS = 262_144
N_OBJECT_READS = 65_536  # the object path's rows (phase 7 c, d)
N_BAM_OBJECT_READS = 8_192  # the object path's BAM row (phase 8 b)
N_PAIRS = 65_536  # read pairs, each aligned to four founders (phase 8 c)
N_SAMPLE = 16_384  # records on which a tool's Python path runs (phase 8 d)
N_COVERAGE = 2_048  # records of the coverage sweep, a line per covered position
N_VARIANTS = 46_000
N_BED = 50_000
TOOL_SWITCHES = (
    "PANVC3_MAPQ_FAST", "PANVC3_SUBSET_FAST", "PANVC3_SPLIT_FAST", "PANVC3_REWRITE_TOOL_FAST",
    "PANVC3_ALS_FAST", "PANVC3_CSR_FAST", "PANVC3_CSR_VCF_FAST",
)
MALDE_SCALE = 256.0  # panvc3_tpu_torch.align.MALDE_SCALE
OPS = {7: "=", 8: "X", 1: "I", 2: "D"}
# the H100 SXM's published rates: FP32 outside the tensor cores (an FMA
# counts as two, so unfused operations issue at half of it) and HBM3
OPS_PER_S = 67e12 / 2
BYTES_PER_S = 3.35e12
DP_CELL_OPS = 12  # f32 adds, maxes and trace compares per DP cell
# INT32 issues on half as many lanes per SM as FP32 on Hopper (64 against
# 128): a quarter of the FP32 FMA rate as counted above, one op per lane
INT_OPS_PER_S = 67e12 / 4
TB_STEP_OPS = 20  # integer ops per traceback step: decode, move, op, update
# the console scripts of the port in the distribution's wheel
PORT_COMMANDS = tuple(f"panvc3_torch_{tool}" for tool in (
    "index_msa", "project_alignments", "recalculate_mapq", "subset_alignments",
    "count_supporting_reads", "rewrite_cigar", "split_alignments_by_reference",
    "alignment_statistics", "convert_bed_positions",
))
WORKFLOW_DATA = ROOT / "workflows/test-workflow/data"
# the port's test workflow, as a path inside the installed package
TEST_SNAKEFILE = "panvc3_tpu_torch/workflows/test-workflow/Snakefile"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def random_runs(rng, B, Q, R, full=False):
    """[ref, query, m, n] on the card: random lengths (the first three runs
    at the edges), or every run at full length, as the length-sorted
    window of 48x48 runs that the main path dispatches."""
    import numpy as np
    import torch

    letters = np.frombuffer(b"ACGT", np.uint8)
    ref = rng.choice(letters, (B, R)).astype(np.uint8)
    qry = rng.choice(letters, (B, Q)).astype(np.uint8)
    if full:
        n = np.full(B, R, np.int32)
        m = np.full(B, Q, np.int32)
    else:
        n = rng.integers(0, R + 1, B).astype(np.int32)
        m = rng.integers(0, Q + 1, B).astype(np.int32)
        n[:3] = [0, R, R]
        m[:3] = [Q, 0, Q]
    return [torch.from_numpy(a).cuda() for a in (ref, qry, m, n)]


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(ops: int, moved: int, ops_per_s: float = OPS_PER_S) -> tuple[float, str]:
    """The least time for ``ops`` operations at ``ops_per_s`` and ``moved``
    bytes, and which of the two sets it."""
    t_ops = ops / ops_per_s * 1e3
    t_bytes = moved / BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def lengths(m, n, Q: int, R: int):
    """The runs' m and n (int64), clamped to the tile as the kernels do."""
    return m.clamp(0, Q).long(), n.clamp(0, R).long()


def k1_need(m, n, Q: int, R: int, mode: str) -> tuple[int, int, float]:
    """(operations, input bytes, op rate) that K1's ``mode`` entry needs for
    these runs: m*n cells; each run's lengths, m query and n reference
    bytes, and its m phreds (with the two 64-entry Malde rows) or m*n f32
    scores."""
    mc, nc = lengths(m, n, Q, R)
    cells = int((mc * nc).sum())
    moved = 8 * len(mc) + int(mc.sum() + nc.sum())
    if mode == "qual":
        moved += 4 * int(mc.sum()) + 2 * 64 * 4
    elif mode == "sub":
        moved += 4 * cells
    return cells * DP_CELL_OPS, moved, OPS_PER_S


def k2_need(m, n, Q: int, R: int) -> tuple[int, int, float]:
    """(operations, input bytes, op rate) of K2's fill: every column of rows
    1..m (its whole trace is the output, columns past n included), so m*R
    cells and scores, and the lengths."""
    mc, _ = lengths(m, n, Q, R)
    cells = int(mc.sum()) * R
    return cells * DP_CELL_OPS, 4 * cells + 8 * len(mc), OPS_PER_S


def tb_need(ops, count) -> tuple[int, int, float]:
    """(operations, input bytes, op rate) of the traceback on these runs:
    the steps their walks take (``count``) at TB_STEP_OPS integer
    operations each; the trace cells they read, one per step (the walk
    stops at (0, 0) without reading it); a query and a reference byte per
    diagonal step (an = or X in ``ops``); and the runs' m and n."""
    steps = int(count.long().sum())
    diag = int(((ops == 7) | (ops == 8)).sum())
    moved = steps + 2 * diag + 8 * len(count)
    return steps * TB_STEP_OPS, moved, INT_OPS_PER_S


def tb_staged(m, n, Q: int, R: int, plan: dict) -> int:
    """Bytes the traceback kernel moves into shared memory (0 on its global
    schedule): each run's trace up to its walk's first flat index
    m*(R+1)+n (none where that is negative, the whole tile where it is
    past it), and every ref and query row."""
    if not plan["shared"]:
        return 0
    cells = (Q + 1) * (R + 1)
    first = m.long() * (R + 1) + n.long()
    trace = int((first.clamp(max=cells - 1) + 1).clamp(min=0).sum())
    return trace + len(m) * (R + Q)


def fixture_runs(quality: bool):
    """Tie-break fixtures grouped by gap costs: (go, ge, [ref, query, m,
    n] on the card, query phreds or None, R, Q, locked CIGARs)."""
    import numpy as np
    import torch

    groups: dict[tuple[int, int], list] = {}
    path = ROOT / "tests/data/tiebreak_fixtures.tsv"
    for line in path.read_text().splitlines():
        if not line or line.startswith("#"):
            continue
        _kind, go, ge, s1, s2, quals, _score, cigar = line.split("\t")
        if (quals != "-") == quality:
            groups.setdefault((int(go), int(ge)), []).append((s1, s2, quals, cigar))
    out = []
    for (go, ge), rows in groups.items():
        R = max(len(r[0]) for r in rows)
        Q = max(len(r[1]) for r in rows)
        ref = np.zeros((len(rows), R), np.uint8)
        qry = np.zeros((len(rows), Q), np.uint8)
        qq = np.zeros((len(rows), Q), np.int32)
        n = np.zeros(len(rows), np.int32)
        m = np.zeros(len(rows), np.int32)
        for b, (s1, s2, quals, _) in enumerate(rows):
            ref[b, :len(s1)] = np.frombuffer(s1.encode(), np.uint8)
            qry[b, :len(s2)] = np.frombuffer(s2.encode(), np.uint8)
            n[b], m[b] = len(s1), len(s2)
            if quality:
                qq[b, :len(s2)] = [int(q) for q in quals.split(",")]
        tensors = [torch.from_numpy(a).cuda() for a in (ref, qry, m, n)]
        qq_t = torch.from_numpy(qq).cuda() if quality else None
        out.append((go, ge, tensors, qq_t, R, Q, [r[3] for r in rows]))
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


def check_cigars(ops, cnt, cigars, what: str) -> None:
    ops_h, cnt_h = ops.cpu().numpy(), cnt.cpu().numpy()
    for b, want in enumerate(cigars):
        got = cigar_string(ops_h[b], int(cnt_h[b]))
        if got != want:
            raise AssertionError(f"{what}, fixture {b}: {got} != {want}")


# cycles of the sleep kernel ahead of a timed loop (~10-20 ms): the host
# queues the loop's launches behind it, so that the span between the events
# holds device time, not the host's launch overhead
QUEUE_SLEEP_CYCLES = 20_000_000
L2_FLUSH_BYTES = 64 << 20  # written before each flushed launch: above the 50 MB L2


def time_ms(fn, iters: int) -> float:
    """Mean device ms of ``fn`` over ``iters`` calls back to back."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def time_flushed_ms(fn, iters: int, flush) -> float:
    """Mean device ms of ``fn`` with the L2 cache flushed before each call:
    ``flush`` (``L2_FLUSH_BYTES`` on the card) is written between calls,
    outside each call's pair of events."""
    import torch

    spans = []
    torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
    for k in range(iters):
        flush.fill_(k & 0x7F)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        spans.append((start, stop))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in spans) / iters


def compare(name, shape, kernel, plain, card, results, need) -> None:
    """Hold one kernel call against its plain version (every output
    element equal), time both, and set the kernel's time beside its bound:
    ``need`` is (operations, input bytes read, op rate) for the timed runs,
    and every output byte is written once.  Record the result under ``name`` and
    ``shape``."""
    import torch

    got = kernel()
    want = plain()
    torch.cuda.synchronize()
    err = max(int((g.int() - w.int()).abs().max()) if g.numel() else 0 for g, w in zip(got, want))
    if err:
        raise AssertionError(f"{name} != plain version at {shape}: max |diff| {err}")
    n_ops, read, rate = need
    moved = read + nbytes(*got)
    b_ms, b_by = bound_ms(n_ops, moved, rate)
    k_ms = time_ms(kernel, 20)
    p_ms = time_ms(plain, 2)
    res = results.setdefault(name, {"max_abs_err": 0, "timing": {}})
    res["max_abs_err"] = max(res["max_abs_err"], err)
    res["timing"][shape] = (k_ms, p_ms, b_ms, b_by)
    log(
        f"[kernel] {name} B,Q,R={shape[:3]} {shape[3]} lengths: kernel == plain "
        f"(byte-equal); kernel {k_ms:.4f} ms, plain PyTorch {p_ms:.3f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}: {n_ops} ops, {moved} bytes), {b_ms / k_ms:.1%} of "
        f"bound ({card})"
    )


# (B, Q, R) at the edges of K1's schedule: each query bucket's lanes per
# run and rows per lane, Q not a multiple of the rows per lane, R on both
# sides of Q, several strips of rows (Q > 256), a tile too large for shared
# memory (400x400: global scratch), B not a multiple of the runs per block
K1_EDGE_SHAPES = [
    (77, q + dq, q + dr)
    for q in (1, 5, 6, 7, 31, 32, 33, 48, 49, 64, 65, 128, 129)
    for dq, dr in ((0, 11), (11, 0))
] + [(77, 5, 300), (21, 300, 5), (21, 300, 40), (9, 400, 400)]


def check_k1_edges(rng, rows) -> None:
    """K1's three entries byte-equal to the plain version at every edge
    shape, m = 0 and n = 0 runs included."""
    import numpy as np
    import torch

    from panvc3_tpu_torch.ops import realign_batch as trb
    from panvc3_tpu_torch.ops.realign_pallas_fused import (
        realign_fused,
        realign_fused_reference,
    )

    for B, Q, R in K1_EDGE_SHAPES:
        args = random_runs(rng, B, Q, R)
        qq = torch.from_numpy(rng.integers(0, 64, (B, Q)).astype(np.int32)).cuda()
        rq = torch.from_numpy(rng.integers(0, 42, (B, R)).astype(np.int32)).cuda()
        sub = trb._substitution_scores(args[0], args[1], rq, qq.clamp(max=41), True)
        for kw, go, ge in (
            ({}, -6.0, -1.0),
            ({"qual": (qq, *rows)}, -6 * MALDE_SCALE, -MALDE_SCALE),
            ({"sub": sub}, -6 * MALDE_SCALE, -MALDE_SCALE),
        ):
            ops, cnt = realign_fused(*args, go, ge, R, Q, **kw)
            want_ops, want_cnt = realign_fused_reference(*args, go, ge, R, Q, **kw)
            if not (torch.equal(ops, want_ops) and torch.equal(cnt, want_cnt)):
                mode = next(iter(kw), "int")
                raise AssertionError(f"K1 {mode} entry != plain version at B,Q,R={B, Q, R}")
    log(
        f"[kernel] K1 edge shapes: {len(K1_EDGE_SHAPES)} shapes x 3 entries "
        "(int, qual, sub) == plain version, byte-equal"
    )


# (B, Q, R) at the edges of K2's schedule: R+1 at each chunk boundary (31,
# 32, 33, 64, 65 and 129 columns) with Q on both sides of R, Q up to 300,
# one run, B not a multiple of the runs per block, and R > 2047, where a
# warp's rows leave shared memory for global scratch
K2_EDGE_SHAPES = [
    (77, q, r) for r in (30, 31, 32, 63, 64, 128) for q in (r + 11, r - 11)
] + [(1, 48, 48), (21, 300, 40), (9, 300, 5), (3, 5, 3100)]


def k2_edge_lengths(rng, B: int, Q: int, R: int):
    """(m, n) int32 numpy arrays for K2's edge shapes: random lengths, and in
    the first runs a full run, m = 0, n = 0, m > Q and n > R."""
    import numpy as np

    m = rng.integers(0, Q + 1, B).astype(np.int32)
    n = rng.integers(0, R + 1, B).astype(np.int32)
    k = min(B, 5)
    m[:k] = [Q, 0, Q, Q + 3, Q][:k]
    n[:k] = [R, R, 0, R, R + 9][:k]
    return m, n


# (B, Q, R, trace, lengths, offset) at the edges of the traceback kernel's
# plan (realign_traceback.cu): K2's trace ("fill", integer scores) or
# random bytes ("bytes": all four moves, both open bits, high bits set);
# lengths inside the run ("in", the first runs full, m = 0, n = 0 and
# both 0) or around it ("out": m in -5..Q+9, n in -5..R+9); ``offset``:
# views at an offset (trace[1:], ref[1:], ... of B+1 runs).  B = 1, B not
# a multiple of the runs per group (22 at 48x48), R+1 odd, two buffers of
# one run (300x300) and the global schedule (400x400: two buffers do not
# fit)
TB_EDGE_CASES = [
    (1, 48, 48, "fill", "in", False),
    (77, 48, 48, "fill", "in", False),
    (33, 7, 29, "fill", "in", False),
    (78, 48, 48, "fill", "in", True),
    (7, 300, 300, "fill", "in", False),
    (9, 400, 400, "fill", "in", False),
    (77, 48, 48, "bytes", "in", False),
    (77, 48, 48, "bytes", "out", True),
    (512, 16, 16, "bytes", "out", False),
    (40, 6, 7, "bytes", "out", False),
    (7, 300, 300, "bytes", "out", False),
    (9, 400, 400, "bytes", "out", True),
]


def tb_edge_case(rng, case, device):
    """(trace, ref, query, m, n) of one ``TB_EDGE_CASES`` entry on
    ``device`` (K2's fill on a card, the plain fill on the CPU)."""
    import numpy as np
    import torch

    from panvc3_tpu_torch.ops import realign_batch as trb
    from panvc3_tpu_torch.ops.realign_pallas import fill_batch

    B, Q, R, trace_kind, lengths, offset = case
    B += offset
    letters = np.frombuffer(b"ACGT", np.uint8)
    ref = rng.choice(letters, (B, R)).astype(np.uint8)
    qry = rng.choice(letters, (B, Q)).astype(np.uint8)
    if lengths == "in":
        m = rng.integers(0, Q + 1, B).astype(np.int32)
        n = rng.integers(0, R + 1, B).astype(np.int32)
        k = min(B, 4)
        m[:k] = [Q, 0, Q, 0][:k]
        n[:k] = [R, R, 0, 0][:k]
    else:
        m = rng.integers(-5, Q + 10, B).astype(np.int32)
        n = rng.integers(-5, R + 10, B).astype(np.int32)
    ref_t, qry_t, m_t, n_t = (torch.from_numpy(a).to(device) for a in (ref, qry, m, n))
    if trace_kind == "fill":
        sub = trb._substitution_scores(ref_t, qry_t).contiguous()
        trace = fill_batch(sub, m_t, n_t, -6.0, -1.0, R, Q)
    else:
        trace = torch.from_numpy(rng.integers(0, 256, (B, Q + 1, R + 1), dtype=np.uint8)).to(device)
    args = (trace, ref_t, qry_t, m_t, n_t)
    return tuple(a[1:] for a in args) if offset else args


def traceback_row(label, args, R: int, Q: int, card, flush, check=True, warm=None) -> None:
    """The traceback kernel on ``args`` (trace, ref, query, m, n on the
    card), byte-equal to the plain ``_traceback_batch`` (``check``; else
    the caller has just compared them), timed with L2 warm (20 launches
    back to back on one trace, which then stays in the L2 where it fits,
    as after K2 on the split route; ``warm`` where the caller timed it) and
    with it flushed (10 launches, ``flush`` written before each), beside
    its bound, its plan and the bytes it staged with their rate."""
    import torch

    from panvc3_tpu_torch.ops import realign_batch as trb
    from panvc3_tpu_torch.ops.realign_traceback import traceback_batch, traceback_plan

    trace, ref, qry, m, n = args

    def kernel():
        return traceback_batch(trace, ref, qry, m, n, R, Q)

    ops, cnt = kernel()
    if check:
        want_ops, want_cnt = trb._traceback_batch(trace, ref, qry, m, n, R, Q)
        if not (torch.equal(ops, want_ops) and torch.equal(cnt, want_cnt)):
            raise AssertionError(f"realign_traceback != plain version: {label}")
    n_ops, read, rate = tb_need(ops, cnt)
    moved = read + nbytes(ops, cnt)
    b_ms, b_by = bound_ms(n_ops, moved, rate)
    warm = time_ms(kernel, 20) if warm is None else warm
    cold = time_flushed_ms(kernel, 10, flush)
    plan = traceback_plan(trace.shape[0], R, Q)
    staged = tb_staged(m, n, Q, R, plan)
    if plan["shared"]:
        how = (
            f"plan: shared memory, {plan['runs']} runs per group, {plan['warps']} walking "
            f"warps with a buffer each, {plan['smem_bytes']} B per block, "
            f"{plan['blocks']} blocks; staged {staged} B, {staged / warm / 1e6:.1f} GB/s "
            f"warm, {staged / cold / 1e6:.1f} GB/s flushed"
        )
    else:
        how = f"plan: global schedule, {plan['blocks']} blocks of {plan['threads']}; nothing staged"
    log(
        f"[traceback] {label}: == plain (byte-equal); warm {warm:.4f} ms, L2 flushed "
        f"{cold:.4f} ms; bound {b_ms:.4f} ms ({b_by}: {n_ops} ops, {moved} bytes), "
        f"{b_ms / warm:.1%} of bound warm, {b_ms / cold:.1%} flushed; {how} ({card})"
    )


def check_tb_edges(rng, card, flush) -> None:
    """The traceback kernel byte-equal to the plain version on every
    ``TB_EDGE_CASES`` entry."""
    for case in TB_EDGE_CASES:
        B, Q, R, trace_kind, lengths, offset = case
        label = (
            f"edge B,Q,R={(B, Q, R)}, {'K2 trace' if trace_kind == 'fill' else 'random bytes'}, "
            f"lengths {'in the run' if lengths == 'in' else 'around the run'}"
            f"{', offset views' if offset else ''}"
        )
        traceback_row(label, tb_edge_case(rng, case, "cuda"), R, Q, card, flush)
    log(f"[kernel] traceback edge cases: {len(TB_EDGE_CASES)} cases == plain version, byte-equal")


def split_route_rows(shape, args, sub, go, ge, card, results, flush) -> None:
    """K2's fill on ``sub`` and the traceback kernel on its trace, each
    against its plain version, as the split route runs them."""
    from panvc3_tpu_torch.ops import realign_batch as trb
    from panvc3_tpu_torch.ops.realign_pallas import fill_batch
    from panvc3_tpu_torch.ops.realign_traceback import traceback_batch

    _, Q, R, _ = shape
    ref, qry, m, n = args
    compare(
        "realign_fill_sub", shape,
        lambda: (fill_batch(sub, m, n, go, ge, R, Q),),
        lambda: (trb._fill_batch(sub, m, n, go, ge, R, Q),),
        card, results, k2_need(m, n, Q, R),
    )
    trace = fill_batch(sub, m, n, go, ge, R, Q)
    ops, count = traceback_batch(trace, ref, qry, m, n, R, Q)
    compare(
        "realign_traceback", shape,
        lambda: traceback_batch(trace, ref, qry, m, n, R, Q),
        lambda: trb._traceback_batch(trace, ref, qry, m, n, R, Q),
        card, results, tb_need(ops, count),
    )
    traceback_row(
        f"B,Q,R={shape[:3]} {shape[3]} lengths, on K2's trace", (trace, ref, qry, m, n), R, Q,
        card, flush, check=False, warm=results["realign_traceback"]["timing"][shape][0],
    )


def check_k2_edges(rng, card, flush) -> None:
    """K2 byte-equal to the plain fill in every trace cell at every edge
    shape, with integer and Malde scores; then the traceback kernel on each
    of K2's traces byte-equal to the plain traceback, with the lengths
    clamped to the run (the traceback's contract; K2 fills the same trace
    for m > Q and n > R as for Q and R)."""
    import numpy as np
    import torch

    from panvc3_tpu_torch.ops import realign_batch as trb
    from panvc3_tpu_torch.ops.realign_pallas import fill_batch
    from panvc3_tpu_torch.ops.realign_traceback import traceback_batch

    for B, Q, R in K2_EDGE_SHAPES:
        ref, qry = random_runs(rng, B, Q, R, full=True)[:2]
        m, n = (torch.from_numpy(a).cuda() for a in k2_edge_lengths(rng, B, Q, R))
        qq = torch.from_numpy(rng.integers(0, 42, (B, Q)).astype(np.int32)).cuda()
        rq = torch.from_numpy(rng.integers(0, 42, (B, R)).astype(np.int32)).cuda()
        for scores, sub, go, ge in (
            ("integer", trb._substitution_scores(ref, qry), -6.0, -1.0),
            ("malde", trb._substitution_scores(ref, qry, rq, qq, True),
             -6 * MALDE_SCALE, -MALDE_SCALE),
        ):
            got = fill_batch(sub, m, n, go, ge, R, Q)
            if not torch.equal(got, trb._fill_batch(sub, m, n, go, ge, R, Q)):
                raise AssertionError(f"K2 != plain version at B,Q,R={B, Q, R}, {scores} scores")
            mc, nc = m.clamp(0, Q), n.clamp(0, R)
            ops, cnt = traceback_batch(got, ref, qry, mc, nc, R, Q)
            want_ops, want_cnt = trb._traceback_batch(got, ref, qry, mc, nc, R, Q)
            if not (torch.equal(ops, want_ops) and torch.equal(cnt, want_cnt)):
                raise AssertionError(
                    f"traceback kernel != plain version at B,Q,R={B, Q, R}, {scores} scores"
                )
            traceback_row(
                f"K2 edge B,Q,R={(B, Q, R)}, {scores} scores", (got, ref, qry, mc, nc), R, Q,
                card, flush, check=False,
            )
    log(
        f"[kernel] K2 edge shapes: {len(K2_EDGE_SHAPES)} shapes x 2 scorings "
        "(integer, Malde) == plain version in every trace cell; the traceback "
        "kernel on each trace == plain version in every op and count"
    )


def phase_kernels(card: str) -> dict:
    import numpy as np
    import torch

    from panvc3_tpu_torch.ops import realign_batch as trb
    from panvc3_tpu_torch.ops.realign_pallas import fill_batch
    from panvc3_tpu_torch.ops.realign_pallas_fused import (
        realign_fused,
        realign_fused_reference,
    )
    from panvc3_tpu_torch.ops.realign_traceback import traceback_batch

    rng = np.random.default_rng(1)
    results: dict = {}
    rows = trb.malde_rows("cuda")
    kgo, kge = 0.0, -1.0 * MALDE_SCALE  # the CLI's gap costs, -q units
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for B, Q, R, full in ((16384, 48, 48, True), (16384, 48, 48, False), (2048, 128, 128, False)):
        shape = (B, Q, R, "full" if full else "random")
        args = random_runs(rng, B, Q, R, full)
        ref, qry, m, n = args
        compare(
            "realign_fused_int", shape,
            lambda: realign_fused(*args, 0.0, -1.0, R, Q),
            lambda: realign_fused_reference(*args, 0.0, -1.0, R, Q),
            card, results, k1_need(m, n, Q, R, "int"),
        )
        qq = torch.from_numpy(rng.integers(0, 42, (B, Q)).astype(np.int32)).cuda()
        qual = (qq, *rows)
        compare(
            "realign_fused_qual", shape,
            lambda: realign_fused(*args, kgo, kge, R, Q, qual=qual),
            lambda: realign_fused_reference(*args, kgo, kge, R, Q, qual=qual),
            card, results, k1_need(m, n, Q, R, "qual"),
        )
        # K2 and the traceback on its trace, as the -q split route runs them
        sub = trb._qual_scores(ref, qry, *qual)
        split_route_rows(shape, args, sub, kgo, kge, card, results, flush)
        del sub
    # the fused engines' split route (phase 9 d): batches of 512 runs of
    # 16x16 with integer scores
    for full in (True, False):
        args = random_runs(rng, 512, 16, 16, full)
        sub = trb._substitution_scores(args[0], args[1]).contiguous()
        shape = (512, 16, 16, "full" if full else "random")
        split_route_rows(shape, args, sub, 0.0, -1.0, card, results, flush)
    # K1's integer entry where the fused engines launch it (their slot pool
    # of 16x16 runs for 8192-record batches) and where the object path and
    # the fused lane's host path launch it (48I48D runs padded to 64x64)
    for B, Q, R, full in ((4096, 16, 16, True), (8192, 64, 64, False)):
        args = random_runs(rng, B, Q, R, full)
        compare(
            "realign_fused_int", (B, Q, R, "full" if full else "random"),
            lambda: realign_fused(*args, 0.0, -1.0, R, Q),
            lambda: realign_fused_reference(*args, 0.0, -1.0, R, Q),
            card, results, k1_need(args[2], args[3], Q, R, "int"),
        )
    B, Q, R = 4096, 48, 48
    args = random_runs(rng, B, Q, R)
    qq = torch.from_numpy(rng.integers(0, 42, (B, Q)).astype(np.int32)).cuda()
    rq = torch.from_numpy(rng.integers(0, 42, (B, R)).astype(np.int32)).cuda()
    sub = trb._substitution_scores(args[0], args[1], rq, qq, True)
    compare(
        "realign_fused_sub", (B, Q, R, "random"),
        lambda: realign_fused(*args, kgo, kge, R, Q, sub=sub),
        lambda: realign_fused_reference(*args, kgo, kge, R, Q, sub=sub),
        card, results, k1_need(args[2], args[3], Q, R, "sub"),
    )
    check_k1_edges(rng, rows)
    check_k2_edges(rng, card, flush)
    check_tb_edges(rng, card, flush)

    n_fix = 0
    for go, ge, args, _, R, Q, cigars in fixture_runs(quality=False):
        ops, cnt = realign_fused(*args, go, ge, R, Q)
        ref_ops, ref_cnt = realign_fused_reference(*args, go, ge, R, Q)
        if not (torch.equal(ops, ref_ops) and torch.equal(cnt, ref_cnt)):
            raise AssertionError(f"realign_fused_int != plain version on fixtures go={go} ge={ge}")
        check_cigars(ops, cnt, cigars, f"realign_fused_int go={go} ge={ge}")
        n_fix += len(cigars)
    log(f"[kernel] {n_fix} integer tie-break fixtures: realign_fused_int == plain == locked CIGARs")
    n_fix = 0
    for go, ge, args, qq, R, Q, cigars in fixture_runs(quality=True):
        ref, qry, m, n = args
        qual = (qq, *rows)
        sgo, sge = go * MALDE_SCALE, ge * MALDE_SCALE
        ops, cnt = realign_fused(*args, sgo, sge, R, Q, qual=qual)
        ref_ops, ref_cnt = realign_fused_reference(*args, sgo, sge, R, Q, qual=qual)
        if not (torch.equal(ops, ref_ops) and torch.equal(cnt, ref_cnt)):
            raise AssertionError(f"realign_fused_qual != plain version on fixtures go={go} ge={ge}")
        check_cigars(ops, cnt, cigars, f"realign_fused_qual go={go} ge={ge}")
        sub = trb._qual_scores(ref, qry, *qual)
        trace = fill_batch(sub, m, n, sgo, sge, R, Q)
        if not torch.equal(trace, trb._fill_batch(sub, m, n, sgo, sge, R, Q)):
            raise AssertionError(f"realign_fill_sub != plain version on fixtures go={go} ge={ge}")
        ops, cnt = traceback_batch(trace, ref, qry, m, n, R, Q)
        want_ops, want_cnt = trb._traceback_batch(trace, ref, qry, m, n, R, Q)
        if not (torch.equal(ops, want_ops) and torch.equal(cnt, want_cnt)):
            raise AssertionError(f"realign_traceback != plain version on fixtures go={go} ge={ge}")
        check_cigars(ops, cnt, cigars, f"realign_fill_sub + realign_traceback go={go} ge={ge}")
        traceback_row(
            f"{len(cigars)} quality fixtures go={go} ge={ge}", (trace, ref, qry, m, n), R, Q,
            card, flush, check=False,
        )
        n_fix += len(cigars)
    log(
        f"[kernel] {n_fix} quality tie-break fixtures: realign_fused_qual == plain, "
        "realign_fill_sub == plain, realign_traceback == plain, K1 and K2 + "
        "the traceback kernel == locked CIGARs"
    )
    return results


def strip_pg(sam: bytes) -> bytes:
    return b"\n".join(ln for ln in sam.split(b"\n") if not ln.startswith(b"@PG"))


def records(sam: bytes) -> list[list[bytes]]:
    return [ln.split(b"\t") for ln in sam.split(b"\n") if ln and not ln.startswith(b"@")]


class Tool:
    """Runs the port's CLI entry, or its object path, in-process on the
    chr21-scale inputs."""

    ENV_KEYS = (
        "PANVC3_HOST_DP", "PANVC3_HOST_DP_CELLS", "PANVC3_PALLAS_FUSED",
        "PANVC3_EVENT_GEOMETRY", "PANVC3_ENGINE_LANE", "PANVC3_FUSED_EVENT",
    )

    def __init__(self, card: str, work: pathlib.Path, index_path, fasta_path,
                 device: str = "cuda"):
        self.card, self.work = card, work
        self.index_path, self.fasta_path = index_path, fasta_path
        # "cpu" only where a test rehearses the tool phases without a card
        self.device = device

    def run(self, tag: str, env: dict, sam: pathlib.Path, quality: bool = False,
            fastlane: bool = True, expect: int | None = N_READS, bam: bool = False,
            batch: int | None = None, extra: tuple = (), cfg_kw: dict | None = None,
            device=None):
        """(output, wall seconds, launches by entry, aggregate diag) of
        one call, which also prints its reads/s and peak device memory; the
        counts start at 0 here.  ``fastlane=False`` runs the object path
        through ``run_project_alignments`` with the CLI's settings, changed
        by ``cfg_kw``, on ``device`` (the tool's device by default; a list
        of devices for a mesh).  ``extra`` is added to the CLI's arguments.
        ``expect`` is the number of records it must write.  With ``bam``
        the input is read as BAM (-B) and BAM is written (-b): the output
        returned is then the file's records as SAM text lines."""
        import torch

        from panvc3_tpu_torch.cli.main import main as cli_main
        from panvc3_tpu_torch.ops import _kernels
        from panvc3_tpu_torch.pipeline import fastlane as fl
        from panvc3_tpu_torch.pipeline.project_alignments import (
            ProjectConfig,
            run_project_alignments,
        )

        for key in self.ENV_KEYS:
            os.environ.pop(key, None)
        os.environ.update(env)
        out_path = self.work / (f"{tag}.bam" if bam else f"{tag}.sam")
        argv = [
            "project_alignments", "--device", self.device,
            "-a", str(sam), "-m", str(self.index_path), "-r", str(self.fasta_path),
            "-d", "REF", "-s", "/", "--msa-index-chr-shard", "0/1",
            "-o", str(out_path), "--status-output-interval", "0",
        ] + (["-q"] if quality else []) + (["-B", "-b"] if bam else []) + (
            ["--device-batch-size", str(batch)] if batch else []
        ) + list(extra)
        cfg = ProjectConfig(
            msa_index_path=str(self.index_path), reference_path=str(self.fasta_path),
            reference_msa_id="REF", ref_id_separator="/", chr_shard=(0, 1),
            status_output_interval=0, engine="device", fastlane=False,
            use_read_base_qualities=quality, output_bam=bam, **(cfg_kw or {}),
        )
        on_card = self.device == "cuda"
        _kernels.reset_launches()
        for key in fl.AGG_DIAG:
            fl.AGG_DIAG[key] = 0
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        if fastlane:
            rc = cli_main(argv)
        else:
            run_project_alignments(str(sam), str(out_path), cfg, device=device or self.device)
            rc = 0
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = dict(_kernels.LAUNCHES)
        diag = dict(fl.AGG_DIAG)
        peak = torch.cuda.max_memory_allocated() / 2**20 if on_card else 0.0
        if rc != 0:
            raise RuntimeError(f"project_alignments ({tag}) exited {rc}")
        if bam:
            size = out_path.stat().st_size
            sam_out = bam_text(out_path)
            n_out = sam_out.count(b"\n")
            log(f"[tools] {tag}: BAM in {sam.stat().st_size} bytes, BAM out {size} bytes")
        else:
            sam_out = out_path.read_bytes()
            n_out = len(records(sam_out))
        if expect is not None and n_out != expect:
            raise AssertionError(f"{tag} wrote {n_out} records, expected {expect}")
        log(
            f"[slice] {tag}: {n_out / wall:.0f} reads/s ({wall:.2f} s, whole "
            f"tool call incl. index/FASTA load); peak device memory {peak:.1f} MiB; "
            f"launches {json.dumps({k: v for k, v in launches.items() if v})}; "
            f"aggregate diag {json.dumps(diag)} ({self.card})"
        )
        return sam_out, wall, launches, diag


def phase_slices(card: str, seed: int, work: pathlib.Path) -> dict:
    from panvc3_tpu_torch import synth
    from panvc3_tpu_torch.synth import every_other

    t0 = time.perf_counter()
    rows = synth.make_msa(CHR21_COLUMNS, seed)
    index_path, fasta_path, founders = synth.write_inputs(work, "chr21", rows)
    rows_tsv = write_msa_rows(work, "chr21", rows)
    del rows
    sam_path = work / "reads.sam"
    sam_path.write_bytes(synth.reads_sam("chr21", founders, N_READS, seed + 1))
    q_sam_path = work / "reads_q.sam"
    q_sam_path.write_bytes(synth.reads_sam("chr21", founders, N_READS, seed + 1, qualities=True))
    one_read = work / "one_read.sam"
    one_read.write_bytes(synth.reads_sam("chr21", founders, 1, seed + 1))
    log(
        f"[slice] inputs: {CHR21_COLUMNS} MSA columns x {len(synth.SEQ_IDS)} rows, "
        f"{N_READS} reads of 100 bp, with and without seeded phreds 2..41 "
        f"({time.perf_counter() - t0:.1f} s to make)"
    )
    tool = Tool(card, work, index_path, fasta_path)
    device = {"PANVC3_HOST_DP": "0"}
    host = {"PANVC3_HOST_DP_CELLS": str(10**18)}

    # warm-up: the first device-lane run in a process also pays one-time
    # costs (lazy loading of PyTorch's kernels, the first pinned buffers)
    tool.run("cold", device, sam_path)
    # setup probe: one read (no realignment); its wall time is the tool's
    # fixed cost per call (index load, event tables, FASTA parse, upload)
    tool.run("setup", device, one_read, expect=1)

    # phase 4: integer scoring
    dev_sam, _, launches, diag = tool.run("int-device", device, sam_path)
    used = {"realign_fused_int": launches["realign_fused_int"]}
    if used["realign_fused_int"] <= 0 or diag["refgather"] <= 0 or diag["wire2"] <= 0:
        raise AssertionError("the device lane did not go through K1 and the ref-gather wires")
    host_sam, *_ = tool.run("int-host", host, sam_path)
    if strip_pg(dev_sam) != strip_pg(host_sam):
        raise AssertionError("integer slice: device-lane SAM differs from host-lane SAM")
    log(f"[slice] integer: device-lane SAM == host-lane SAM ({N_READS} records, @PG stripped)")

    # phase 5: quality scoring (-q) on the same MSA and reads
    q_dev, _, launches, diag = tool.run("q-device", device, q_sam_path, quality=True)
    used["realign_fused_qual"] = launches["realign_fused_qual"]
    if used["realign_fused_qual"] <= 0 or diag["refgather"] <= 0 or diag["wire2"] <= 0:
        raise AssertionError("the -q device lane did not go through K1's quality entry and the wires")
    q_split = phase_split_route(tool, q_sam_path, used)
    q_host, *_ = tool.run("q-host", host, q_sam_path, quality=True)
    if not (strip_pg(q_dev) == strip_pg(q_split) == strip_pg(q_host)):
        raise AssertionError("-q slice: device lane, split route and host lane SAMs differ")
    changed = sum(
        a[5] != b[5] for a, b in zip(records(dev_sam), records(q_dev))
    )
    log(
        f"[slice] -q: device-lane SAM == split-route SAM == host-lane SAM "
        f"({N_READS} records, @PG stripped); {changed} records' CIGARs differ "
        "from the integer run's"
    )
    obj_sams = phase_geometry(tool, sam_path, q_sam_path, dev_sam, q_dev, used)
    phase_tools(tool, seed, rows_tsv, founders, sam_path, q_sam_path, dev_sam, q_dev, used)
    routes = phase_fused(tool, sam_path, dev_sam, used)
    phase_mesh(
        tool, (work / "reads_head.sam", work / "reads_q_head.sam"), obj_sams,
        work / "reads_fused_even.sam", every_other(strip_pg(dev_sam), N_OBJECT_READS),
        routes["fused-b-even"], used,
    )
    phase_installed(tool, sam_path, one_read, dev_sam, used)
    return used


def phase_split_route(tool, q_sam_path, used, n_reads: int = N_READS) -> bytes:
    """Phase 5 (b): the -q split route (PANVC3_PALLAS_FUSED=0), which must
    launch K2 and the traceback kernel once each per dispatch and nothing
    else.  Its launches join ``used``; returns its SAM."""
    env = {"PANVC3_HOST_DP": "0", "PANVC3_PALLAS_FUSED": "0"}
    q_split, _, launches, _ = tool.run("q-split", env, q_sam_path, quality=True, expect=n_reads)
    k2, tb = launches["realign_fill_sub"], launches["realign_traceback"]
    if tool.device == "cuda" and (k2 <= 0 or tb != k2 or launches["realign_fused_qual"]):
        raise AssertionError(
            f"the -q split route did not go through K2 and the traceback kernel alone: {launches}"
        )
    used["realign_fill_sub"], used["realign_traceback"] = k2, tb
    log(f"[slice] -q split route: K2 {k2} and traceback kernel {tb} launches ({tool.card})")
    return q_split


def phase_geometry(tool, sam_path, q_sam_path, dev_sam, q_dev, used):
    """Phase 7: the fast lane over the gap kernel (=0) and over the device
    event geometry (=device), then the object path, integer and -q, each
    against the device-lane SAM of phase 4 or 5.  The object path's K1
    launches join ``used``; returns the object path's SAMs (c), (d)."""
    import torch

    from panvc3_tpu_torch.ops.rank_select import DeviceGapIndex
    from panvc3_tpu_torch.synth import head_of

    device = {"PANVC3_HOST_DP": "0"}

    # (a) the gap kernel; its index is built on the first batch, timed here
    # (what is kept of it is numbers: the index itself dies with the call)
    builds = []
    build = DeviceGapIndex.__dict__["build"]

    def timed_build(cls, *args, **kw):
        t0 = time.perf_counter()
        index = build.__func__(cls, *args, **kw)
        torch.cuda.synchronize()
        tables = {
            key: getattr(index, key).numel() * getattr(index, key).element_size()
            for key in DeviceGapIndex.FIELDS if getattr(index, key) is not None
        }
        builds.append((time.perf_counter() - t0, index.device.type, tables))
        return index

    DeviceGapIndex.build = classmethod(timed_build)
    try:
        gap_sam, _, launches, diag = tool.run(
            "int-gap-kernel", {**device, "PANVC3_EVENT_GEOMETRY": "0"}, sam_path
        )
    finally:
        DeviceGapIndex.build = build
    if len(builds) != 1 or builds[0][1] != "cuda":
        raise AssertionError(f"the gap kernel row built {len(builds)} device gap indexes")
    secs, _, tables = builds[0]
    log(
        f"[geometry] gap index build {secs:.2f} s (host build + one copy to the "
        f"card); tables on the card {sum(tables.values()) / 2**20:.1f} MiB: "
        + ", ".join(f"{k} {v / 2**20:.1f} MiB" for k, v in tables.items() if v >= 2**20)
        + f"; {diag['geometry_overflow']} batches fetched their full deletion runs "
        f"({tool.card})"
    )
    if launches["realign_fused_int"] <= 0:
        raise AssertionError("the gap-kernel row did not launch K1")

    # (b) the device event geometry
    ev_sam, _, launches, diag = tool.run(
        "int-device-events", {**device, "PANVC3_EVENT_GEOMETRY": "device"}, sam_path
    )
    log(
        f"[geometry] device event geometry: {diag['geometry_overflow']} batches "
        f"overflowed to the host event path ({tool.card})"
    )
    if launches["realign_fused_int"] <= 0:
        raise AssertionError("the device-event row did not launch K1")

    # (c), (d) the object path, on the first N_OBJECT_READS reads
    head = head_sam(sam_path, tool.work / "reads_head.sam", N_OBJECT_READS)
    q_head = head_sam(q_sam_path, tool.work / "reads_q_head.sam", N_OBJECT_READS)
    obj_sam, _, launches, _ = tool.run(
        "int-object", device, head, fastlane=False, expect=N_OBJECT_READS
    )
    used["realign_fused_int"] += launches["realign_fused_int"]
    if launches["realign_fused_int"] <= 0:
        raise AssertionError("the object path did not launch K1's integer entry")
    q_obj, _, launches, _ = tool.run(
        "q-object", device, q_head, quality=True, fastlane=False, expect=N_OBJECT_READS
    )
    used["realign_fused_qual"] += launches["realign_fused_qual"]
    if launches["realign_fused_qual"] <= 0:
        raise AssertionError("the -q object path did not launch K1's quality entry")

    want = strip_pg(dev_sam)
    for tag, got in (("gap kernel", gap_sam), ("device events", ev_sam)):
        if strip_pg(got) != want:
            raise AssertionError(f"{tag}: SAM differs from the device lane's")
    if strip_pg(obj_sam) != head_of(strip_pg(dev_sam), N_OBJECT_READS):
        raise AssertionError("object path: SAM differs from the device lane's")
    if strip_pg(q_obj) != head_of(strip_pg(q_dev), N_OBJECT_READS):
        raise AssertionError("-q object path: SAM differs from the -q device lane's")
    log(
        f"[geometry] gap kernel and device events SAMs == integer device-lane "
        f"SAM ({N_READS} records, @PG stripped); object path SAM == its first "
        f"{N_OBJECT_READS} records, -q object path SAM == those of the -q device lane"
    )
    return obj_sam, q_obj


class TimedBuilds:
    """Seconds of each device-table build while in use: the host event
    tables (``EventGeometry``), the device event tables
    (``DeviceEventGeometry``) and the device gap index
    (``DeviceGapIndex.build``), each ended by a synchronise on a card."""

    def __init__(self, device: str):
        self.device = device

    def __enter__(self):
        from panvc3_tpu_torch.ops import event_geometry as eg
        from panvc3_tpu_torch.ops.rank_select import DeviceGapIndex

        self.seconds: dict[str, float] = {}
        self._undo = []

        def wrap(owner, attr, key, bound=False):
            orig = owner.__dict__[attr]
            fn = orig.__func__ if bound else orig

            def timed(*args, **kw):
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                if self.device == "cuda":
                    import torch

                    torch.cuda.synchronize()
                self.seconds[key] = self.seconds.get(key, 0.0) + time.perf_counter() - t0
                return out

            setattr(owner, attr, classmethod(timed) if bound else timed)
            self._undo.append((owner, attr, orig))

        wrap(eg.EventGeometry, "__init__", "host event tables")
        wrap(eg.DeviceEventGeometry, "__init__", "device event tables")
        wrap(DeviceGapIndex, "build", "gap index", bound=True)
        return self

    def __exit__(self, *exc):
        for owner, attr, orig in self._undo:
            setattr(owner, attr, orig)


def phase_fused(tool, sam_path, dev_sam, used, n_reads: int = N_OBJECT_READS,
                batch: int = 1024) -> dict:
    """Phase 9: the fused engines through the CLI (PANVC3_ENGINE_LANE=fused,
    the object path's fused lane), each row's SAM against the same records
    of phase 4's device-lane SAM.  (a) the first ``n_reads`` reads at the
    default batch; (b) ``n_reads`` even-numbered reads (the mixed kinds,
    whose runs fit 16x16) at ``batch``, where v4's own DP must answer; (c)
    (b) under PANVC3_FUSED_EVENT=0 (v3 throughout); (d) (b) under
    PANVC3_PALLAS_FUSED=0 (K2 and the traceback kernel).  The rows' K1,
    K2 and traceback launches join ``used``; returns each row's route
    counts."""
    from panvc3_tpu_torch.ops import engine
    from panvc3_tpu_torch.synth import every_other, head_of
    from panvc3_tpu_torch.utils import log_peak_memory

    work, card = tool.work, tool.card
    on_card = tool.device == "cuda"
    lane = {"PANVC3_HOST_DP": "0", "PANVC3_ENGINE_LANE": "fused"}
    head = head_sam(sam_path, work / "reads_fused_head.sam", n_reads)
    even = work / "reads_fused_even.sam"
    even.write_bytes(every_other(sam_path.read_bytes(), n_reads))
    want_head = head_of(strip_pg(dev_sam), n_reads)
    want_even = every_other(strip_pg(dev_sam), n_reads)
    rows = (
        ("fused-a-head", lane, head, None, want_head),
        ("fused-b-even", lane, even, batch, want_even),
        ("fused-c-v3", {**lane, "PANVC3_FUSED_EVENT": "0"}, even, batch, want_even),
        ("fused-d-split-route", {**lane, "PANVC3_PALLAS_FUSED": "0"}, even, batch, want_even),
    )
    routes = {}
    for tag, env, src, size, want in rows:
        with TimedBuilds(tool.device) as builds:
            got, _, launches, _ = tool.run(
                tag, env, src, fastlane=True, expect=n_reads, batch=size
            )
        routes[tag] = dict(engine.FUSED_ROUTES)
        if strip_pg(got) != want:
            raise AssertionError(f"{tag}: SAM differs from the same records of the device lane's")
        k1, k2 = launches["realign_fused_int"], launches["realign_fill_sub"]
        tb = launches["realign_traceback"]
        r = routes[tag]
        if sum(r.values()) == 0:
            raise AssertionError(f"{tag}: the fused lane answered no batch")
        if tag == "fused-b-even" and (r["v4_dp"] < 1 or (on_card and k1 < r["v4_dp"])):
            raise AssertionError(f"{tag}: v4 answered {r['v4_dp']} batches by its own DP, K1 {k1}")
        if tag == "fused-c-v3" and (r["v4_dp"] or r["v4_to_v3"] or r["v3"] < 1):
            raise AssertionError(f"{tag}: not v3 throughout: {r}")
        if tag == "fused-d-split-route" and on_card and (k2 < 1 or tb != k2 or k1):
            raise AssertionError(f"{tag}: K2 launched {k2} times, the traceback {tb}, K1 {k1}")
        if on_card and tag != "fused-d-split-route" and k1 < 1:
            raise AssertionError(f"{tag}: K1 was not launched")
        used["realign_fused_int"] += k1
        used["realign_fill_sub"] += k2
        used["realign_traceback"] += tb
        os.environ.pop("PANVC3_ENGINE_LANE")
        mbps = engine.probe_d2h_mbps(tool.device)
        unforced = engine.choose_engine_lane(tool.device)
        log(
            f"[fused] {tag}: routes {json.dumps(r)}; K1 {k1}, K2 {k2}, traceback {tb} launches; builds "
            + ", ".join(f"{k} {v:.2f} s" for k, v in builds.seconds.items())
            + f"; device-to-host {mbps:.0f} MB/s (probe_d2h_mbps); the arbiter picks "
            f"{unforced!r} unforced on this host ({len(os.sched_getaffinity(0))} cores) ({card})"
        )
    sys.stdout.write("[fused] host ")
    log_peak_memory(file=sys.stdout)
    log(
        f"[fused] rows a-d: SAM == the same records of the device-lane SAM "
        f"({n_reads} records each, @PG stripped)"
    )
    return routes


class TimedLaunches:
    """Device milliseconds of each kernel launch while in use: CUDA events
    recorded on the launching stream around every ``_kernels.launch``
    (which still counts it), summed by entry and read at exit."""

    def __enter__(self):
        import torch

        from panvc3_tpu_torch.ops import _kernels

        self._launch = _kernels.launch
        self._events: list = []

        def timed(name, *args):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            self._launch(name, *args)
            stop.record()
            self._events.append((name, start, stop))

        _kernels.launch = timed
        return self

    def __exit__(self, *exc):
        import torch

        from panvc3_tpu_torch.ops import _kernels

        _kernels.launch = self._launch
        torch.cuda.synchronize()
        self.ms: dict[str, list[float]] = {}
        for name, start, stop in self._events:
            self.ms.setdefault(name, []).append(start.elapsed_time(stop))


def projector_batch(tool, sam: bytes):
    """A single-device BatchProjector over the tool's MSA (chromosome shard
    0/1, as the CLI rows load it), the SAM's records and their output
    references, with the references loaded: what ``run_project_alignments``
    builds for the object path."""
    import io

    from panvc3_tpu_torch.io.fasta import FastaReader
    from panvc3_tpu_torch.io.sam import SamReader
    from panvc3_tpu_torch.msa_index import MsaIndex
    from panvc3_tpu_torch.ops.engine import BatchProjector
    from panvc3_tpu_torch.pipeline import project_alignments as pa

    reader = SamReader(io.BytesIO(sam))
    records = list(reader)
    out_header, mapping = pa.process_headers(reader.header, "/", "REF", None)
    src, dst = pa.fill_sequence_entries(
        MsaIndex.load(str(tool.index_path), shard=(0, 1)), reader.header.ref_names,
        len(out_header.ref_names), "/", "REF", mapping, allow_missing=True,
    )
    fasta = FastaReader(str(tool.fasta_path))
    ref_seqs = {r: fasta.read_sequence(out_header.ref_names[r]) for r in sorted(set(mapping))}
    bp = BatchProjector(src, dst, mapping, 0, -1, "cuda:0" if tool.device == "cuda" else tool.device)
    bp._ensure_refs(ref_seqs)
    return bp, records


def mesh_dry_run(tool, records, batch: int) -> None:
    """Phase 10 (a), the counterpart of ``dryrun_multichip``: v4 on the
    first batch of ``batch`` records on which its own DP answers (no run
    pool, length or event overflow), unsharded, then sharded over the tool's
    device twice, four times, and over every visible card when there is
    more than one: every output equal to the unsharded call's, byte for
    byte.  Prints K1's launches per shard and its device ms per launch."""
    import numpy as np
    import torch

    from panvc3_tpu_torch.ops import _kernels
    from panvc3_tpu_torch.ops.fetch import DeviceFetch
    from panvc3_tpu_torch.ops.fused_event import make_fused_event_kernel
    from panvc3_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch_arrays

    on_card = tool.device == "cuda"
    for key in Tool.ENV_KEYS:  # phase 9 (d) leaves the split route selected
        os.environ.pop(key, None)
    bp, records = projector_batch(tool, records)
    geo, ref_flat = bp.event_geometry, bp.ref_flat_dev
    costs = (np.float32(0), np.float32(-1))
    one = make_fused_event_kernel(geo)
    for start in range(0, len(records) - batch + 1, batch):
        chunk = records[start:start + batch]
        _, _, staged = bp.stage(chunk)
        arrays = bp.v4_inputs(chunk, staged)
        kw = dict(R=staged.pad_ref_units, run_r=bp.FUSED_RUN_PAD, run_q=bp.FUSED_RUN_PAD,
                  slot_pool=max(256, batch // 2))
        want = DeviceFetch(*one(ref_flat, *arrays.values(), *costs, **kw)).get()
        flags = want[7]
        if flags[0] == flags[1] == 0 and flags[2] > 0:
            break
    else:
        raise AssertionError(f"no batch of {batch} records on which v4's own DP answers")
    dev = f"{tool.device}:0" if on_card else tool.device
    meshes = [[dev] * 2, [dev] * 4]
    if on_card and torch.cuda.device_count() > 1:
        meshes.append(make_mesh(None, "cuda").devices)
    names = ("initial", "gapbits", "d_vals", "d_pos8", "d_n8", "realign_ops",
             "realign_counts", "flags")
    for devices in meshes:
        mesh = make_mesh(None, list(devices))
        kernel = make_fused_event_kernel(geo, mesh)
        args = (replicate(mesh, ref_flat), *shard_batch_arrays(mesh, arrays).values(), *costs)
        _kernels.reset_launches()
        t0 = time.perf_counter()
        if on_card:
            with TimedLaunches() as timed:
                out = kernel(*args, **kw)
                got = DeviceFetch(*out[:8]).get()
            k1_ms = timed.ms.get("realign_fused_int", [])
        else:
            out = kernel(*args, **kw)
            got = DeviceFetch(*out[:8]).get()
            k1_ms = []
        wall = time.perf_counter() - t0
        for name, g, w in zip(names, got, want):
            if g.dtype != w.dtype or not np.array_equal(g, w):
                raise AssertionError(f"mesh {[str(d) for d in devices]}: {name} != unsharded call")
        k1 = _kernels.LAUNCHES["realign_fused_int"]
        if on_card and k1 < 1:
            raise AssertionError(f"mesh {[str(d) for d in devices]}: K1 was not launched")
        per_launch = f"{sum(k1_ms) / len(k1_ms):.4f}" if k1_ms else "not measured"
        log(
            f"[mesh] dry run, v4 on {batch} records (records {start}..{start + batch - 1}) over "
            f"{[str(d) for d in devices]}: every output == the unsharded call, byte for byte; "
            f"flags {flags.tolist()}; slots per shard {out.slot_ranges}; K1 {k1} launches "
            f"({k1 / mesh.size:.2f} per shard), {per_launch} ms per launch; whole call "
            f"{wall * 1e3:.1f} ms incl. fetch ({tool.card})"
        )


def phase_mesh(tool, heads, obj_sams, even, want_even, fused_b_routes, used,
               batch: int = 1024) -> None:
    """Phase 10, the mesh (--data-parallel): (a) the dry run
    (``mesh_dry_run``) on phase 9 (b)'s even reads ``even``; (b) the CLI
    with --data-parallel -1 on ``heads`` (phase 7's reads, integer then
    -q), whose SAMs must equal phase 7 (c)'s and (d)'s ``obj_sams``; (c)
    the library with ``fused_kernel=True``, ``data_parallel=-1`` and the
    tool's device twice on ``even`` at ``batch`` per batch, whose SAM must
    equal phase 9 (b)'s (``want_even``, @PG stripped), with v4's own DP
    answering and the route counts equal to phase 9 (b)'s.  K1's launches
    on (b) and (c) join ``used``."""
    from panvc3_tpu_torch.ops import engine
    from panvc3_tpu_torch.parallel.mesh import make_mesh

    mesh_dry_run(tool, even.read_bytes(), batch)

    device = {"PANVC3_HOST_DP": "0"}
    dp = ("--data-parallel", "-1")
    obj_sam, q_obj = obj_sams
    n_obj = len(records(obj_sam))
    for tag, src, quality, want, entry in (
        ("mesh-int", heads[0], False, obj_sam, "realign_fused_int"),
        ("mesh-q", heads[1], True, q_obj, "realign_fused_qual"),
    ):
        got, _, launches, _ = tool.run(tag, device, src, quality=quality, expect=n_obj, extra=dp)
        if strip_pg(got) != strip_pg(want):
            raise AssertionError(f"{tag}: --data-parallel -1 SAM differs from phase 7's object path")
        if tool.device == "cuda" and launches[entry] < 1:
            raise AssertionError(f"{tag}: {entry} was not launched")
        used[entry] += launches[entry]

    dev = f"{tool.device}:0" if tool.device == "cuda" else tool.device
    n_even = len(records(want_even))
    got, _, launches, _ = tool.run(
        "mesh-fused", device, even, fastlane=False, expect=n_even, device=[dev, dev],
        cfg_kw={"fused_kernel": True, "data_parallel": -1, "device_batch_size": batch},
    )
    routes = dict(engine.FUSED_ROUTES)
    if strip_pg(got) != want_even:
        raise AssertionError("mesh-fused: SAM differs from phase 9 (b)'s")
    if routes["v4_dp"] < 1 or routes != fused_b_routes:
        raise AssertionError(f"mesh-fused: routes {routes}, phase 9 (b) {fused_b_routes}")
    if tool.device == "cuda" and launches["realign_fused_int"] < routes["v4_dp"]:
        raise AssertionError(f"mesh-fused: K1 {launches['realign_fused_int']} launches")
    used["realign_fused_int"] += launches["realign_fused_int"]
    cli_mesh = [str(d) for d in make_mesh(None, tool.device).devices]
    log(
        f"[mesh] --data-parallel -1 (mesh {cli_mesh}) SAMs == phase 7 (c), (d) "
        f"({n_obj} records each); "
        f"library mesh {[dev, dev]}, fused lane: SAM == phase 9 (b)'s ({n_even} records), "
        f"routes {json.dumps(routes)} "
        f"== phase 9 (b)'s; K1 {launches['realign_fused_int']} launches ({tool.card})"
    )


def head_sam(src: pathlib.Path, dst: pathlib.Path, n: int) -> pathlib.Path:
    from panvc3_tpu_torch.synth import head_of

    dst.write_bytes(head_of(src.read_bytes(), n))
    return dst


def body(sam: bytes) -> bytes:
    """The record lines of SAM text."""
    return b"".join(ln + b"\n" for ln in sam.split(b"\n") if ln and not ln.startswith(b"@"))


def bam_text(path) -> bytes:
    """A BAM file's records as SAM text lines (tags in the file's order)."""
    from panvc3_tpu_torch.io.sam import SamReader

    reader = SamReader(str(path))
    if not reader.is_bam:
        raise AssertionError(f"{path} is not BAM")
    text = b"".join(ln for block in reader.raw_record_line_blocks() for ln in block)
    reader.close()
    return text


def sam_to_bam(src: pathlib.Path, dst: pathlib.Path) -> pathlib.Path:
    """Convert SAM text to BAM with the port's SamWriter (the C encoder)."""
    from panvc3_tpu_torch.io.sam import SamReader, SamWriter

    reader = SamReader(str(src))
    writer = SamWriter(str(dst), reader.header, bam=True)
    for block in reader.raw_record_line_blocks():
        writer.write_raw(b"".join(block))
    writer.close()
    reader.close()
    return dst


def canonical(sam_or_path) -> list[str]:
    """Every record of a SAM or BAM file, parsed and printed again (tags
    sorted): what two files hold when their bytes may differ in tag order."""
    from panvc3_tpu_torch.io.sam import SamReader, format_sam_record

    reader = SamReader(str(sam_or_path))
    out = [format_sam_record(rec, reader.header) for rec in reader]
    reader.close()
    return out


def write_msa_rows(work: pathlib.Path, chr_id: str, rows: dict) -> pathlib.Path:
    """The MSA as index_msa reads it: one aligned row per file, and the
    TSV that lists them (chromosome, sequence id, path)."""
    lines = []
    for sid, row in rows.items():
        path = work / f"row_{sid}.txt"
        path.write_bytes(row + b"\n")
        lines.append(f"{chr_id}\t{sid}\t{path}")
    tsv = work / "rows.tsv"
    tsv.write_text("\n".join(lines) + "\n")
    return tsv


def run_cli(argv: list, env: dict | None = None, stdin: pathlib.Path | None = None):
    """One tool through the port's CLI: (standard output, seconds).  The
    tools' switches are cleared, then ``env`` is set.  Output is caught at
    the descriptor, where the tools' print calls end up."""
    from panvc3_tpu_torch.cli.main import main as cli_main

    for key in TOOL_SWITCHES:
        os.environ.pop(key, None)
    os.environ.update(env or {})
    sys.stdout.flush()
    keep_out, keep_in = os.dup(1), os.dup(0)
    with tempfile.TemporaryFile() as tmp:
        fd_in = os.open(str(stdin) if stdin else os.devnull, os.O_RDONLY)
        os.dup2(tmp.fileno(), 1)
        os.dup2(fd_in, 0)
        t0 = time.perf_counter()
        try:
            rc = cli_main([str(a) for a in argv])
            sys.stdout.flush()
        finally:
            wall = time.perf_counter() - t0
            os.dup2(keep_out, 1)
            os.dup2(keep_in, 0)
            for fd in (keep_out, keep_in, fd_in):
                os.close(fd)
        tmp.seek(0)
        out = tmp.read()
    for key in TOOL_SWITCHES:
        os.environ.pop(key, None)
    if rc != 0:
        raise RuntimeError(f"{argv[0]} exited {rc}: {' '.join(map(str, argv))}")
    return out, wall


def position_sorted(src: pathlib.Path, dst: pathlib.Path) -> pathlib.Path:
    """SAM text sorted by POS (one reference), as count_supporting_reads
    and the coverage sweep take it."""
    import numpy as np

    lines = src.read_bytes().split(b"\n")
    header = [ln for ln in lines if ln.startswith(b"@")]
    recs = [ln for ln in lines if ln and not ln.startswith(b"@")]
    order = np.argsort(np.array([int(ln.split(b"\t", 4)[3]) for ln in recs]), kind="stable")
    dst.write_bytes(b"\n".join(header + [recs[i] for i in order.tolist()]) + b"\n")
    return dst


def phase_tools(tool, seed, rows_tsv, founders, sam_path, q_sam_path, dev_sam, q_dev, used,
                n_pairs: int = N_PAIRS) -> None:
    """Phase 8: the nine tools through the port's CLI on the chr21-scale
    inputs.  K1's launches on the BAM rows join ``used``."""
    import multiprocessing
    import numpy as np
    import torch

    from panvc3_tpu_torch import synth
    from panvc3_tpu_torch.ops import _kernels
    from panvc3_tpu_torch.pipeline import recalculate_mapq as rm

    work, card = tool.work, tool.card
    on_card = tool.device == "cuda"
    device = {"PANVC3_HOST_DP": "0"}
    n_reads = len(records(dev_sam))

    # (a) index_msa
    built = work / "built-index.npz"
    _, secs = run_cli(["index_msa", "--build-index", "-i", rows_tsv, "-m", built])
    with np.load(tool.index_path) as want, np.load(built) as got:
        if sorted(want.files) != sorted(got.files):
            raise AssertionError("index_msa: the built index holds other arrays")
        for key in want.files:
            if not np.array_equal(want[key], got[key]):
                raise AssertionError(f"index_msa: array {key} differs from the phase 4 index")
        n_arrays = len(want.files)
    listing, _ = run_cli(["index_msa", "--list-contents", "-d", built])
    for sid in synth.SEQ_IDS:
        if f"\t{sid}\t".encode() not in listing:
            raise AssertionError(f"index_msa --list-contents does not name {sid}")
    log(
        f"[tools] index_msa --build-index: {secs:.2f} s for {len(synth.SEQ_IDS)} rows; "
        f"{n_arrays} arrays == the phase 4 index; --list-contents names all rows ({card})"
    )

    # (b) BAM in, BAM out on the device lane, integer and -q; the object
    # path's BAM row through the Python encoder
    bam_in = sam_to_bam(sam_path, work / "reads.bam")
    q_bam_in = sam_to_bam(q_sam_path, work / "reads_q.bam")
    got, _, launches, _ = tool.run("bam-int-device", device, bam_in, expect=n_reads, bam=True)
    if on_card and launches["realign_fused_int"] <= 0:
        raise AssertionError("the BAM run did not launch K1's integer entry")
    used["realign_fused_int"] += launches["realign_fused_int"]
    if got != body(dev_sam):
        raise AssertionError("BAM in/out: records differ from the device-lane SAM")
    got, _, launches, _ = tool.run(
        "bam-q-device", device, q_bam_in, quality=True, expect=n_reads, bam=True
    )
    if on_card and launches["realign_fused_qual"] <= 0:
        raise AssertionError("the -q BAM run did not launch K1's quality entry")
    used["realign_fused_qual"] += launches["realign_fused_qual"]
    if got != body(q_dev):
        raise AssertionError("-q BAM in/out: records differ from the -q device-lane SAM")
    n_obj = min(N_BAM_OBJECT_READS, n_reads)
    obj_in = sam_to_bam(head_sam(sam_path, work / "reads_obj.sam", n_obj), work / "reads_obj.bam")
    got, _, launches, _ = tool.run(
        "bam-int-object", device, obj_in, fastlane=False, expect=n_obj, bam=True
    )
    if on_card and launches["realign_fused_int"] <= 0:
        raise AssertionError("the object path's BAM run did not launch K1's integer entry")
    used["realign_fused_int"] += launches["realign_fused_int"]
    if got != body(synth.head_of(dev_sam, n_obj)):
        raise AssertionError("object path BAM: records differ from the device-lane SAM")
    log(
        f"[tools] project_alignments -B -b: device lane integer and -q == the SAM runs "
        f"({n_reads} records); object path (Python BAM encoder) == its first {n_obj}"
    )

    # (c) recalculate_mapq on pairs aligned to every founder, projected
    pairs = work / "pairs.sam"
    pairs.write_bytes(synth.pairs_sam("chr21", founders, n_pairs, seed + 2))
    n_rec = n_pairs * 2 * (len(synth.SEQ_IDS) - 1)
    pairs_bam = sam_to_bam(pairs, work / "pairs.bam")
    projected_text, _, launches, _ = tool.run(
        "pairs-project", device, pairs_bam, expect=n_rec, bam=True
    )
    projected_bam = work / "pairs-project.bam"
    header = canonical_header(projected_bam)
    projected = work / "pairs-projected.sam"
    projected.write_bytes(header + projected_text)
    sample = head_sam(projected, work / "pairs-sample.sam", n_rec // 16)
    if on_card:
        torch.zeros(1, device="cuda")
        if not torch.cuda.is_initialized():
            raise AssertionError("no CUDA context before recalculate_mapq")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        allocated = torch.cuda.memory_allocated()
    _kernels.reset_launches()
    methods = []
    get_context = multiprocessing.get_context

    def recording_get_context(method=None):
        methods.append(method)
        return get_context(method)

    mapq = ["recalculate_mapq", "--status-output-interval", "0"]
    outs = {}
    multiprocessing.get_context = recording_get_context
    try:
        for jobs in (1, 4):
            out = work / f"mapq-jobs{jobs}.bam"
            _, secs = run_cli(mapq + ["-a", projected_bam, "-B", "-b", "-o", out, "--jobs", jobs])
            outs[jobs] = bam_text(out)
            log(
                f"[tools] recalculate_mapq --jobs {jobs}: {n_rec / secs:.0f} records/s "
                f"({secs:.2f} s, {n_rec} records, BAM in and out) ({card})"
            )
    finally:
        multiprocessing.get_context = get_context
    want_method = "spawn" if on_card else rm.mp_start_method()
    if methods != [want_method]:
        raise AssertionError(f"recalculate_mapq --jobs 4 started its pool by {methods}, not {want_method}")
    if outs[1] != outs[4] or outs[1].count(b"\n") == 0:
        raise AssertionError("recalculate_mapq: --jobs 4 differs from --jobs 1")
    sam_out = work / "mapq-jobs1.sam"
    run_cli(mapq + ["-a", projected, "-o", sam_out])
    if canonical(sam_out) != canonical(work / "mapq-jobs1.bam"):
        raise AssertionError("recalculate_mapq: SAM output differs from BAM output")
    fast_out, slow_out = work / "mapq-sample-fast.sam", work / "mapq-sample-slow.sam"
    run_cli(mapq + ["-a", sample, "-o", fast_out])
    _, secs = run_cli(mapq + ["-a", sample, "-o", slow_out], {"PANVC3_MAPQ_FAST": "0"})
    if strip_pg(fast_out.read_bytes()) != strip_pg(slow_out.read_bytes()):
        raise AssertionError("recalculate_mapq: PANVC3_MAPQ_FAST=0 differs from the C engine")
    if any(_kernels.LAUNCHES.values()):
        raise AssertionError(f"recalculate_mapq launched kernels: {_kernels.LAUNCHES}")
    if on_card and (
        torch.cuda.memory_allocated() != allocated or torch.cuda.max_memory_allocated() != allocated
    ):
        raise AssertionError("recalculate_mapq allocated memory on the card")
    log(
        f"[tools] recalculate_mapq: --jobs 4 ({want_method}) == --jobs 1 == SAM output; "
        f"PANVC3_MAPQ_FAST=0 == C engine on {n_rec // 16} records "
        f"({n_rec // 16 / secs:.0f} records/s); nothing allocated or launched on the card"
    )

    # (d) the six auxiliary tools on the projected output
    phase_aux_tools(tool, seed, founders, work / "bam-int-device.bam", dev_sam, sam_out)


def canonical_header(bam_path) -> bytes:
    from panvc3_tpu_torch.io.sam import SamReader

    reader = SamReader(str(bam_path))
    text = reader.header.to_text().encode()
    reader.close()
    return text


def phase_aux_tools(tool, seed, founders, projected_bam, dev_sam, mapq_sam) -> None:
    """Phase 8 (d).  ``projected_bam`` is (b)'s integer output, ``dev_sam``
    the same records as SAM text, ``mapq_sam`` (c)'s QNAME-grouped output."""
    from panvc3_tpu_torch import synth

    work, card = tool.work, tool.card
    n_reads = len(records(dev_sam))
    n_sample = min(N_SAMPLE, n_reads)
    projected = work / "projected.sam"
    projected.write_bytes(dev_sam)
    sample = head_sam(projected, work / "projected-sample.sam", n_sample)
    sorted_sam = position_sorted(projected, work / "projected-sorted.sam")
    sorted_sample = position_sorted(sample, work / "projected-sorted-sample.sam")
    n_cov = min(N_COVERAGE, n_sample)
    coverage_sample = head_sam(sorted_sample, work / "projected-coverage-sample.sam", n_cov)

    def rate(name, n, secs, what=""):
        log(f"[tools] {name}: {n / secs:.0f} records/s ({secs:.2f} s, {n} records{what}) ({card})")

    def same_files(a: pathlib.Path, b: pathlib.Path, what: str) -> None:
        if strip_pg(a.read_bytes()) != strip_pg(b.read_bytes()):
            raise AssertionError(f"{what}: outputs differ")

    # split_alignments_by_reference: one reference, so one file holds all
    names = work / "split-names.txt"
    names.write_text("chr21\n")
    split = ["split_alignments_by_reference", "--split-alignments", "-r", names]
    for tag in ("bam", "sam", "fast", "slow"):
        (work / f"split-{tag}").mkdir()
    _, secs = run_cli(split + ["-a", projected_bam, "-B", "-b", f"{work}/split-bam/"])
    rate("split_alignments_by_reference", n_reads, secs, ", BAM in")
    run_cli(split + ["-a", projected, "-b", f"{work}/split-sam/"])
    run_cli(split + ["-a", sample, "-b", f"{work}/split-fast/"])
    _, secs = run_cli(split + ["-a", sample, "-b", f"{work}/split-slow/"], {"PANVC3_SPLIT_FAST": "0"})
    rate("split_alignments_by_reference PANVC3_SPLIT_FAST=0", n_sample, secs)
    if bam_text(work / "split-bam/chr21.bam") != body(dev_sam):
        raise AssertionError("split_alignments_by_reference: the one file does not hold every record")
    if bam_text(work / "split-sam/chr21.bam") != body(dev_sam):
        raise AssertionError("split_alignments_by_reference: SAM input differs from BAM input")
    if canonical(work / "split-fast/chr21.bam") != canonical(work / "split-slow/chr21.bam"):
        raise AssertionError("split_alignments_by_reference: PANVC3_SPLIT_FAST=0 differs")

    # subset_alignments: the best-MAPQ placement of each pair
    n_mapq = len(records(mapq_sam.read_bytes()))
    mapq_sample = head_sam(mapq_sam, work / "mapq-sample.sam", min(N_SAMPLE, n_mapq))
    subset = ["subset_alignments", "--chr", "chr21", "--best-mapq"]
    _, secs = run_cli(subset + ["-a", mapq_sam, "-o", work / "subset.sam"])
    rate("subset_alignments --best-mapq", n_mapq, secs)
    run_cli(subset + ["-a", mapq_sam, "-b", "-o", work / "subset.bam"])
    if canonical(work / "subset.sam") != canonical(work / "subset.bam"):
        raise AssertionError("subset_alignments: BAM output differs from SAM output")
    if not 0 < len(records((work / "subset.sam").read_bytes())) < n_mapq:
        raise AssertionError("subset_alignments --best-mapq kept none or all of the records")
    run_cli(subset + ["-a", mapq_sample, "-o", work / "subset-fast.sam"])
    _, secs = run_cli(subset + ["-a", mapq_sample, "-o", work / "subset-slow.sam"], {"PANVC3_SUBSET_FAST": "0"})
    rate("subset_alignments PANVC3_SUBSET_FAST=0", min(N_SAMPLE, n_mapq), secs)
    same_files(work / "subset-fast.sam", work / "subset-slow.sam", "subset_alignments PANVC3_SUBSET_FAST=0")

    # rewrite_cigar: =/X to M, then M back to =/X against the reference
    rewrite = ["rewrite_cigar", "--status-output-interval", "0"]
    _, secs = run_cli(rewrite + ["-M", "-a", projected, "-o", work / "rewrite-m.sam"])
    rate("rewrite_cigar -M", n_reads, secs)
    _, secs = run_cli(rewrite + ["-S", "-r", tool.fasta_path, "-a", work / "rewrite-m.sam", "-o", work / "rewrite-s.sam"])
    rate("rewrite_cigar -S", n_reads, secs)
    run_cli(rewrite + ["-S", "-r", tool.fasta_path, "-a", work / "rewrite-m.sam", "-b", "-o", work / "rewrite-s.bam"])
    if canonical(work / "rewrite-s.sam") != canonical(work / "rewrite-s.bam"):
        raise AssertionError("rewrite_cigar: BAM output differs from SAM output")
    m_ops = sum(b"M" in rec[5] for rec in records((work / "rewrite-m.sam").read_bytes()))
    s_ops = sum(b"M" in rec[5] for rec in records((work / "rewrite-s.sam").read_bytes()))
    if m_ops == 0 or s_ops != 0:
        raise AssertionError(f"rewrite_cigar: {m_ops} records with M after -M, {s_ops} after -S")
    for mode, extra, src in (("M", [], sample), ("S", ["-r", tool.fasta_path], work / "rewrite-m-sample.sam")):
        if mode == "S":
            head_sam(work / "rewrite-m.sam", src, n_sample)
        run_cli(rewrite + [f"-{mode}", *extra, "-a", src, "-o", work / f"rw-{mode}-fast.sam"])
        _, secs = run_cli(
            rewrite + [f"-{mode}", *extra, "-a", src, "-o", work / f"rw-{mode}-slow.sam"],
            {"PANVC3_REWRITE_TOOL_FAST": "0"},
        )
        rate(f"rewrite_cigar -{mode} PANVC3_REWRITE_TOOL_FAST=0", n_sample, secs)
        same_files(work / f"rw-{mode}-fast.sam", work / f"rw-{mode}-slow.sam", f"rewrite_cigar -{mode} =0")

    # alignment_statistics: four modes, the C engine against the Python loops
    for mode in ("--coverage", "--count-alignments", "--mapq-histogram", "--mapq-box-plot"):
        stats = ["alignment_statistics", mode]
        # coverage prints a line per covered position, and its Python sweep
        # walks the span between reads: it gets samples of its own
        n_full, src = (n_sample, sorted_sample) if mode == "--coverage" else (n_reads, sorted_sam)
        n_slow, slow_src = (n_cov, coverage_sample) if mode == "--coverage" else (n_sample, sorted_sample)
        full, secs = run_cli(stats + ["-a", src])
        rate(f"alignment_statistics {mode}", n_full, secs)
        if mode == "--count-alignments" and f"chr21\t{n_reads}".encode() not in full:
            raise AssertionError("alignment_statistics --count-alignments: wrong count")
        fast, _ = run_cli(stats + ["-a", slow_src])
        slow, secs = run_cli(stats + ["-a", slow_src], {"PANVC3_ALS_FAST": "0"})
        rate(f"alignment_statistics {mode} PANVC3_ALS_FAST=0", n_slow, secs)
        if fast != slow or not fast:
            raise AssertionError(f"alignment_statistics {mode}: PANVC3_ALS_FAST=0 differs")
    from_bam, _ = run_cli(["alignment_statistics", "--mapq-histogram", "-a", projected_bam, "-b"])
    from_sam, _ = run_cli(["alignment_statistics", "--mapq-histogram", "-a", projected])
    if from_bam != from_sam:
        raise AssertionError("alignment_statistics: BAM input differs from SAM input")

    # count_supporting_reads: a diploid single-sample VCF over REF
    vcf = work / "variants.vcf"
    vcf.write_bytes(synth.variants_vcf("chr21", founders["REF"], N_VARIANTS, seed + 3))
    csr = ["count_supporting_reads", "-i", vcf]
    full, secs = run_cli(csr + ["-a", sorted_sam])
    rate("count_supporting_reads", n_reads, secs, f", {N_VARIANTS} variants drawn")
    if full.count(b"\nR\t") == 0:
        raise AssertionError("count_supporting_reads: no variant was covered by a read")
    fast, _ = run_cli(csr + ["-a", sorted_sample])
    for env in ({"PANVC3_CSR_VCF_FAST": "0"}, {"PANVC3_CSR_FAST": "0"}):
        slow, secs = run_cli(csr + ["-a", sorted_sample], env)
        rate(f"count_supporting_reads {next(iter(env))}=0", n_sample, secs)
        if slow != fast:
            raise AssertionError(f"count_supporting_reads: {env} differs")

    # convert_bed_positions: REF to founder 1 and back
    bed = work / "intervals.bed"
    bed.write_bytes(synth.bed_intervals("chr21", len(founders["REF"]), N_BED, seed + 4))
    convert = ["convert_bed_positions", "-m", tool.index_path, "-c", "chr21"]
    there, secs = run_cli(convert + ["-b", bed, "-s", "REF", "-d", "1"])
    rate("convert_bed_positions", N_BED, secs)
    piped, _ = run_cli(convert + ["-s", "REF", "-d", "1"], stdin=bed)
    if piped != there or there.count(b"\n") != N_BED:
        raise AssertionError("convert_bed_positions: standard input differs from --bed")
    starts = [int(ln.split(b"\t")[1]) for ln in there.splitlines()]
    if starts != sorted(starts) or not all(0 <= s <= len(founders["1"]) for s in starts):
        raise AssertionError("convert_bed_positions: converted starts out of order or range")
    log(
        "[tools] split, subset, rewrite_cigar, alignment_statistics, count_supporting_reads: "
        "switch on == switch =0 on the sample; SAM == BAM where alignments are written; "
        f"convert_bed_positions: {N_BED} intervals, --bed == standard input"
    )


# -- phase 11: the installed port ------------------------------------------

def build_wheel(out: pathlib.Path) -> pathlib.Path:
    """The distribution's wheel, built by pip (no network, no build
    isolation, no dependencies) from a copy of the checkout's sources in
    ``out``, so that the build writes nothing into the checkout."""
    src, dist = out / "src", out / "dist"
    src.mkdir(parents=True)
    for name in ("pyproject.toml", "setup.py", "MANIFEST.in"):
        shutil.copy2(ROOT / name, src / name)
    skip = shutil.ignore_patterns("__pycache__", "build", "native_build", "_native_src", "*.so")
    for name in ("native", "panvc3_tpu", "panvc3_tpu_torch"):
        shutil.copytree(ROOT / name, src / name, ignore=skip)
    proc = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", "--no-deps", "--no-build-isolation",
         "--no-index", "--no-cache-dir", "-q", "-w", str(dist), str(src)],
        capture_output=True, text=True, timeout=600,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"pip wheel failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    (wheel,) = dist.glob("*.whl")
    return wheel


def unpack_wheel(wheel: pathlib.Path, target: pathlib.Path) -> dict[str, str]:
    """Unpack ``wheel`` into ``target`` and byte-compile it, as an install
    does; return its console scripts, name -> 'module:function'."""
    with zipfile.ZipFile(wheel) as zf:
        zf.extractall(target)
        ep = next(n for n in zf.namelist() if n.endswith(".dist-info/entry_points.txt"))
    if not compileall.compile_dir(str(target), quiet=1):
        raise RuntimeError(f"byte-compiling {target} failed")
    cp = configparser.ConfigParser()
    cp.optionxform = str
    cp.read_string((target / ep).read_text())
    return dict(cp["console_scripts"])


def console_script(scripts: dict[str, str], name: str) -> list[str]:
    """argv that runs the console script ``name``, as the wrapper that an
    install writes for it does."""
    module, func = scripts[name].split(":")
    return [sys.executable, "-c",
            f"import sys; from {module} import {func}; sys.argv[0] = {name!r}; sys.exit({func}())"]


def imported_modules(stderr: str) -> set[str]:
    """The modules a process run with ``-X importtime`` imported."""
    return set(re.findall(r"^import time:\s+\d+ \|\s+\d+ \| +(\S+)$", stderr, re.M))


def reference_modules(modules) -> list[str]:
    """Those of ``modules`` that belong to JAX or to the JAX package."""
    return sorted(m for m in modules if m.split(".")[0] in ("jax", "jaxlib", "panvc3_tpu"))


def installed_env(target: pathlib.Path, cache: pathlib.Path, **extra: str) -> dict:
    """The environment of an installed package: ``PYTHONPATH`` the target
    alone, ``XDG_CACHE_HOME`` ``cache``, no PANVC3_* switch but ``extra``."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("PANVC3_") and k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(target), XDG_CACHE_HOME=str(cache), **extra)
    return env


def write_shims(bin_dir: pathlib.Path, commands: dict[str, list[str]]) -> pathlib.Path:
    """A directory of commands, each name running its argv with the
    command's arguments, to put first on ``PATH``."""
    bin_dir.mkdir(parents=True, exist_ok=True)
    for name, argv in commands.items():
        shim = bin_dir / name
        shim.write_text(f'#!/bin/sh\nexec {shlex.join(argv)} "$@"\n')
        shim.chmod(0o755)
    return bin_dir


# probe run in an installed package's environment: where the package and
# its builds live, the seconds of the CLI's imports, the cold build of the C
# extension, and on a card the cold build of the kernels and the seconds
# to create the CUDA context
INSTALLED_BUILD = """
import json, sys, time
t0 = time.perf_counter()
import panvc3_tpu_torch
from panvc3_tpu_torch.cli import main
from panvc3_tpu_torch.pipeline import project_alignments
from panvc3_tpu_torch import native
out = {"package": panvc3_tpu_torch.__file__, "build_root": str(panvc3_tpu_torch.build_root()),
       "native_dir": str(native.NATIVE_DIR), "import_s": time.perf_counter() - t0}
t0 = time.perf_counter()
native.get_native()
out["native_s"] = time.perf_counter() - t0
if sys.argv[1] == "kernels":
    import torch
    from panvc3_tpu_torch.ops import _kernels
    t0 = time.perf_counter()
    _kernels.build_all()
    out["kernels_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    out["cuda_context_s"] = time.perf_counter() - t0
print(json.dumps(out))
"""


def installed_build(env: dict, cwd: pathlib.Path, kernels: bool) -> dict:
    """Run ``INSTALLED_BUILD`` in ``env`` from ``cwd``; its JSON line."""
    proc = subprocess.run(
        [sys.executable, "-c", INSTALLED_BUILD, "kernels" if kernels else "native"],
        env=env, cwd=cwd, capture_output=True, text=True, timeout=900,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"the installed package's build failed:\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def snapshot(root: pathlib.Path) -> dict[str, tuple[int, int]]:
    """Every file under ``root``: relative path -> (size, mtime in ns)."""
    if not root.exists():
        return {}
    return {
        str(p.relative_to(root)): (p.stat().st_size, p.stat().st_mtime_ns)
        for p in sorted(root.rglob("*")) if p.is_file()
    }


def fastlane_diag(stderr: str) -> dict:
    """The ``[fastlane diag]`` JSON of a run with PANVC3_FASTLANE_PROF=1."""
    m = re.search(r"\[fastlane diag\] (\{.*\})", stderr)
    if not m:
        raise AssertionError(f"no [fastlane diag] line in:\n{stderr[-4000:]}")
    return json.loads(m.group(1))


class _Named(list):
    """A rule's input, output or params: positional and named entries, as
    Snakemake formats them (``{input}`` all of them, ``{input.name}`` one)."""

    def __init__(self, *args, **kw):
        super().__init__([*args, *kw.values()])
        self.__dict__.update(kw)

    def __format__(self, spec: str) -> str:
        return " ".join(map(str, self))


_RULE_SECTIONS = ("message", "conda", "threads", "benchmark", "input", "output",
                  "shell", "params", "log", "resources")


def snakefile_rules(path: pathlib.Path) -> dict[str, dict[str, str]]:
    """{rule: {section: text}} of a Snakefile laid out as the repo's are:
    a section per indented ``name:`` line, continued on deeper lines."""
    rules: dict[str, dict[str, str]] = {}
    rule = key = None
    for line in pathlib.Path(path).read_text().splitlines():
        m = re.match(r"rule\s+(\w+)\s*:", line)
        if m:
            rule, key = rules.setdefault(m.group(1), {}), None
        elif line and not line[0].isspace():
            rule = key = None
        elif rule is not None:
            m = re.match(r"\s+(\w+)\s*:(.*)$", line)
            if m and m.group(1) in _RULE_SECTIONS:
                key = m.group(1)
                rule[key] = m.group(2)
            elif key is not None:
                rule[key] += "\n" + line
    return rules


def rule_entries(rule: dict[str, str], section: str, config: dict) -> _Named:
    """A parsed rule's input, output or params, evaluated with ``config``
    in scope, as Snakemake does."""
    return eval(f"_named({rule.get(section, '')})", {"config": config, "_named": _Named})


def rule_io(rule: dict[str, str], config: dict):
    """(input, output, params, shell command) of a parsed rule, the command
    formatted from its entries as Snakemake does."""
    inp, out, params = (rule_entries(rule, k, config) for k in ("input", "output", "params"))
    cmd = eval(f"({rule['shell']})", {}).format(input=inp, output=out, params=params, threads=1)
    return inp, out, params, cmd


def sort_alignments(src: pathlib.Path, dst: pathlib.Path, by_name: bool) -> None:
    """``samtools sort [-n]`` stand-in: the records of gzipped SAM ``src``
    sorted stably by reference and position (unmapped last) or by QNAME
    (as ``panvc3_tpu_torch.workflow`` sorts them), written as BAM."""
    from panvc3_tpu_torch.io.sam import SamReader, SamWriter

    reader = SamReader(io.BytesIO(gzip.decompress(src.read_bytes())))
    records = list(reader)
    records.sort(key=(lambda r: r.qname) if by_name else (lambda r: (r.ref_id < 0, r.ref_id, r.pos)))
    writer = SamWriter(str(dst), reader.header, bam=True)
    for rec in records:
        writer.write(rec)
    writer.close()


def run_test_workflow(snakefile: pathlib.Path, work: pathlib.Path, env: dict,
                      config: dict | None = None, data: pathlib.Path = WORKFLOW_DATA):
    """The test workflow of ``snakefile`` in ``work`` (a copy of ``data``):
    its three panvc3 rules (build_msa_index, project_alignments,
    recalculate_mapq) run by ``bash`` in ``env`` with their commands as
    Snakemake formats them; the aligner stage is
    ``synth.founder_alignments``, the two samtools sorts
    ``sort_alignments``.  Returns (the final SAM text, the stderr of
    project_alignments)."""
    from panvc3_tpu_torch import synth

    shutil.copytree(data, work)
    rules = snakefile_rules(snakefile)
    config = config or {}
    err = {}

    def run(name: str) -> None:
        _, out, _, cmd = rule_io(rules[name], config)
        for path in out:
            (work / path).parent.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run(["bash", "-c", f"set -euo pipefail; {cmd}"], cwd=work, env=env,
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"rule {name} exited {proc.returncode}: {cmd}\n{proc.stderr}")
        err[name] = proc.stderr

    def entry(name: str, section: str, key: str | int = 0) -> pathlib.Path:
        entries = rule_entries(rules[name], section, config)
        return work / (getattr(entries, key) if isinstance(key, str) else entries[key])

    run("build_msa_index")
    aligned = entry("bowtie_align_reads", "output")
    aligned.parent.mkdir(parents=True, exist_ok=True)
    aligned.write_bytes(gzip.compress(
        synth.founder_alignments(work, entry("build_msa_index", "output", "index"))
    ))
    sort_alignments(aligned, entry("project_alignments", "input", "alignments"), by_name=False)
    run("project_alignments")
    sort_alignments(entry("project_alignments", "output"), entry("recalculate_mapq", "input"),
                    by_name=True)
    run("recalculate_mapq")
    return gzip.decompress(entry("all", "input").read_bytes()), err["project_alignments"]


def phase_installed(tool, sam_path, one_read, dev_sam, used, n_reads: int = N_READS) -> None:
    """Phase 11: the installed port.  (a) the distribution's wheel, built
    from the checkout and unpacked into a temporary target, runs
    ``panvc3_torch_project_alignments`` on the device lane from outside the
    checkout, with ``PYTHONPATH`` the target alone and a temporary
    ``XDG_CACHE_HOME``: its SAM must equal phase 4's device-lane SAM
    (``dev_sam``) and K1 must launch; the C extension and the kernels are
    built cold into the cache, and nothing is written under the target or
    the checkout's ``build/``.  (b) the port's test workflow, from the
    target, through the installed commands on the bundled reads, on the
    tool's device and on the CPU: equal final SAMs, K1 launched on the
    card.  K1's launches in both join ``used``."""
    work, card = (tool.work / "installed").resolve(), tool.card
    on_card = tool.device == "cuda"
    t0 = time.perf_counter()
    wheel = build_wheel(work / "wheel")
    wheel_s = time.perf_counter() - t0
    target, cache, run_dir = work / "site", work / "cache", work / "run"
    scripts = unpack_wheel(wheel, target)
    run_dir.mkdir()
    missing = [c for c in PORT_COMMANDS if not scripts.get(c, "").startswith("panvc3_tpu_torch.cli.main:cmd_")]
    if missing:
        raise AssertionError(f"the wheel lacks the port's commands {missing}")
    in_target, in_build = snapshot(target), snapshot(ROOT / "build")

    env = installed_env(target, cache)
    info = installed_build(env, run_dir, kernels=on_card)
    package = pathlib.Path(info["package"]).resolve()
    if not package.is_relative_to(target.resolve()):
        raise AssertionError(f"the installed run imported {package}, not the target's package")
    if pathlib.Path(info["build_root"]) != cache / "panvc3_tpu_torch":
        raise AssertionError(f"the installed build root is {info['build_root']}, not the cache")
    if not pathlib.Path(info["native_dir"]).resolve().is_relative_to(target.resolve()):
        raise AssertionError(f"the installed package compiled the C sources of {info['native_dir']}")
    built = sorted(str(p.relative_to(cache)) for p in cache.rglob("*.so"))

    # -X importtime: the process lists every module it imports
    python, *entry = console_script(scripts, "panvc3_torch_project_alignments")
    argv = [python, "-X", "importtime", *entry] + [
        "--device", tool.device, "-m", str(tool.index_path.resolve()),
        "-r", str(tool.fasta_path.resolve()),
        "-d", "REF", "-s", "/", "--msa-index-chr-shard", "0/1", "--status-output-interval", "0",
    ]
    lane = installed_env(target, cache, PANVC3_HOST_DP="0", PANVC3_FASTLANE_PROF="1")
    rows = {}
    for tag, src in (("one-read", one_read), ("reads", sam_path)):
        out = run_dir / f"{tag}.sam"
        t0 = time.perf_counter()
        proc = subprocess.run(argv + ["-a", str(src.resolve()), "-o", str(out)], env=lane, cwd=run_dir,
                              capture_output=True, text=True, timeout=900)
        rows[tag] = (time.perf_counter() - t0, out, proc)
        if proc.returncode != 0:
            raise RuntimeError(f"panvc3_torch_project_alignments ({tag}) exited {proc.returncode}:\n{proc.stderr}")
    wall, out, proc = rows["reads"]
    modules = imported_modules(proc.stderr)
    if "panvc3_tpu_torch.ops._kernels" not in modules or reference_modules(modules):
        raise AssertionError(f"the installed command imported {reference_modules(modules)}")
    diag = fastlane_diag(proc.stderr)
    k1 = diag["kernel_launches"]["realign_fused_int"]
    if strip_pg(out.read_bytes()) != strip_pg(dev_sam):
        raise AssertionError("the installed command's SAM differs from phase 4's device-lane SAM")
    if diag["device"].split(":")[0] != tool.device or (on_card and k1 < 1):
        raise AssertionError(f"the installed command ran on {diag['device']} with K1 {k1} launches")
    used["realign_fused_int"] += k1
    setup = rows["one-read"][0]
    prof = re.search(r"\[fastlane prof\] (.*)", proc.stderr)
    log(
        f"[installed] wheel {wheel.name} built in {wheel_s:.1f} s; cold builds in "
        f"XDG_CACHE_HOME: C extension {info['native_s']:.1f} s"
        + (f", CUDA kernels {info['kernels_s']:.1f} s" if on_card else "")
        + f" ({', '.join(built)}); the CLI's imports {info['import_s']:.2f} s"
        + (f", a CUDA context {info['cuda_context_s']:.2f} s" if on_card else "")
        + f" (a process of their own); panvc3_torch_project_alignments --device {tool.device} on "
        f"{n_reads} reads: {n_reads / wall:.0f} reads/s ({wall:.2f} s, the whole process), "
        f"one read {setup:.2f} s (start, imports, index and FASTA load), "
        f"{n_reads / max(wall - setup, 1e-9):.0f} reads/s past it; SAM == phase 4's device lane "
        f"(@PG stripped); K1 {k1} launches; aggregate diag dispatches {diag['dispatches']}, "
        f"refgather {diag['refgather']}, wire2 {diag['wire2']}; {len(modules)} modules "
        f"imported, none of JAX or panvc3_tpu; its [fastlane prof]: {prof.group(1) if prof else '-'} "
        f"({card})"
    )

    # (b) the port's test workflow through the installed commands
    shims = write_shims(work / "bin", {c: console_script(scripts, c) for c in PORT_COMMANDS})
    finals = {}
    for device in dict.fromkeys((tool.device, "cpu")):
        wf_env = installed_env(target, cache, PANVC3_HOST_DP="0", PANVC3_FASTLANE_PROF="1")
        wf_env["PATH"] = f"{shims}{os.pathsep}{wf_env.get('PATH', '')}"
        t0 = time.perf_counter()
        final, err = run_test_workflow(target / TEST_SNAKEFILE, work / f"workflow-{device}", wf_env,
                                       {"device": device})
        secs = time.perf_counter() - t0
        diag = fastlane_diag(err)
        k1 = diag["kernel_launches"]["realign_fused_int"]
        if diag["device"].split(":")[0] != device or diag["dispatches"] < 1 or (device == "cuda" and k1 < 1):
            raise AssertionError(f"workflow on {device}: ran on {diag['device']}, "
                                 f"{diag['dispatches']} dispatches, K1 {k1}")
        if device == "cuda":
            used["realign_fused_int"] += k1
        finals[device] = final
        log(
            f"[installed] test workflow, device {device}: index_msa -> project_alignments -> "
            f"recalculate_mapq through the installed commands in {secs:.1f} s; "
            f"{len(records(final))} records; aggregate dispatches {diag['dispatches']}, "
            f"K1 {k1} launches ({card})"
        )
    if len(set(map(strip_pg, finals.values()))) != 1:
        raise AssertionError("the test workflow's final SAMs differ between the devices")
    if snapshot(target) != in_target:
        raise AssertionError("the installed runs wrote under the target")
    if snapshot(ROOT / "build") != in_build:
        raise AssertionError("the installed runs wrote under the checkout's build/")
    log(
        f"[installed] final SAM on {' == '.join(finals)} ({len(records(finals['cpu']))} records, "
        f"@PG stripped); nothing written under the target ({len(in_target)} files) or the "
        f"checkout's build/ ({len(in_build)} files) ({card})"
    )


def phase_batch(card: str, seed: int) -> int:
    """realign_batch with explicit reference qualities on the card, against
    the host C DP; returns the substitution entry's launches."""
    import numpy as np

    from panvc3_tpu_torch.ops import _kernels
    from panvc3_tpu_torch.ops import realign_batch as trb

    for key in ("PANVC3_HOST_DP", "PANVC3_HOST_DP_CELLS", "PANVC3_PALLAS_FUSED"):
        os.environ.pop(key, None)
    rng = np.random.default_rng(seed + 7)
    letters = np.frombuffer(b"ACGT", np.uint8)
    refs, queries, rqs, qqs = [], [], [], []
    for _ in range(4096):
        r = rng.choice(letters, int(rng.integers(1, 49))).tobytes()
        q = rng.choice(letters, int(rng.integers(1, 49))).tobytes()
        refs.append(r)
        queries.append(q)
        rqs.append(rng.integers(2, 42, len(r)).astype(np.int32))
        qqs.append(rng.integers(2, 42, len(q)).astype(np.int32))
    os.environ["PANVC3_HOST_DP"] = "0"
    _kernels.reset_launches()
    t0 = time.perf_counter()
    got = trb.realign_batch(refs, queries, 0, -1, rqs, qqs, device="cuda")
    wall = time.perf_counter() - t0
    launches = _kernels.LAUNCHES["realign_fused_sub"]
    os.environ["PANVC3_HOST_DP"] = "1"
    os.environ["PANVC3_HOST_DP_CELLS"] = str(10**18)
    want = trb.realign_batch(refs, queries, 0, -1, rqs, qqs, device="cpu")
    for key in ("PANVC3_HOST_DP", "PANVC3_HOST_DP_CELLS"):
        os.environ.pop(key, None)
    if launches <= 0:
        raise AssertionError("realign_batch with explicit qualities did not launch realign_fused_sub")
    if got != want:
        raise AssertionError("realign_batch on the card differs from the host C DP")
    log(
        f"[batch] realign_batch, {len(refs)} runs <= 48x48 with explicit reference "
        f"qualities: {launches} launches of realign_fused_sub, CIGARs == host "
        f"C DP; {wall * 1e3:.1f} ms incl. packing and decode ({card})"
    )
    return launches


def build(card: str) -> None:
    from panvc3_tpu_torch import native
    from panvc3_tpu_torch.ops import _kernels

    times = {}

    def timed(key, fn):
        t0 = time.perf_counter()
        fn()
        times[key] = time.perf_counter() - t0

    err: list[BaseException] = []

    def host_ext():
        try:
            timed("native", native.get_native)
        except BaseException as exc:  # noqa: BLE001 — re-raised below
            err.append(exc)

    th = threading.Thread(target=host_ext)
    th.start()
    timed("cuda", _kernels.build_all)
    th.join()
    if err:
        raise err[0]
    log(
        f"[build] CUDA kernels {times['cuda']:.1f} s (nvcc sm_90a, every source "
        f"in parallel), C host extension {times['native']:.1f} s"
    )
    for source, text in sorted(_kernels.BUILD_LOG.items()):
        log(f"[build] ptxas, {source}:\n{text.strip()}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    started = time.perf_counter()
    # per-stage timings of the fast lane, printed to stderr by each run
    os.environ["PANVC3_FASTLANE_PROF"] = "1"

    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"[env] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    build(card)
    kern = phase_kernels(card)
    work = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke-"))
    try:
        launches = phase_slices(card, args.seed, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    launches["realign_fused_sub"] = phase_batch(card, args.seed)

    # each entry at the main path's shape: the window of 48x48 runs (K1's
    # and the split route's), the substitution entry's realign_batch call;
    # phase 3's log lines give K1's fused-engine and object-path shapes
    entries = []
    for entry, source, replaces, shape in (
        ("realign_fused_int", FUSED_SOURCE, K1_REPLACES, (16384, 48, 48, "full")),
        ("realign_fused_qual", FUSED_SOURCE, K1_REPLACES, (16384, 48, 48, "full")),
        ("realign_fused_sub", FUSED_SOURCE, K1_REPLACES, (4096, 48, 48, "random")),
        ("realign_fill_sub", FILL_SOURCE, K2_REPLACES, (16384, 48, 48, "full")),
        ("realign_traceback", TRACEBACK_SOURCE, TRACEBACK_REPLACES, (16384, 48, 48, "full")),
    ):
        k_ms, p_ms, b_ms, b_by = kern[entry]["timing"][shape]
        entries.append({
            "name": entry,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[entry],
            "max_abs_err": kern[entry]["max_abs_err"],
            "ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            # no single PyTorch call computes an affine-gap DP with traceback
            "library_ms": None,
        })
        log(
            f"[kernel] {entry}: {launches[entry]} launches per call on its path; "
            f"{k_ms:.4f} ms at {shape}, bound {b_ms:.4f} ms ({b_by}), "
            f"{b_ms / k_ms:.1%} of bound ({card})"
        )
    log(f"[env] all phases passed in {time.perf_counter() - started:.0f} s ({card})")
    log(json.dumps({"kernels": entries}))
    log(card_line())
    if "jax" in sys.modules:
        raise AssertionError("JAX was imported")
    ref_pkg = [m for m in sys.modules if m == "panvc3_tpu" or m.startswith("panvc3_tpu.")]
    if ref_pkg:
        raise AssertionError(f"the port loaded modules of panvc3_tpu: {ref_pkg}")
    # every phase ran on cuda:0, the one card this run uses
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
