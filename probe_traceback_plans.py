#!/usr/bin/env python3
"""Time the traceback kernel (panvc3_tpu_torch/ops/csrc/realign_traceback.cu)
under other plans on one NVIDIA GPU.

    python3 probe_traceback_plans.py [--walkers 2 4 6 8]

Each plan builds the kernel's source with another number of walking warps
per block (``MAX_WALKERS``: each warp walks its own buffer, which takes
the most runs that fit; four is the committed plan), by nvcc with the
port's flags into build/probe_traceback_plans/.  On the split route's
shapes (16384 runs of 48x48, full and random lengths; 2048 of 128x128;
512 of 16x16), on K2's trace of integer scores, each plan's output must
equal the plain ``_traceback_batch``; its time per launch is printed with
L2 warm (20 launches back to back) and flushed (``chip_smoke``'s timing),
beside its plan, the card's name and its power limit.  The last line is a
JSON object of the times.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parent
SOURCE = ROOT / "panvc3_tpu_torch/ops/csrc/realign_traceback.cu"
SHAPES = ((16384, 48, 48, True), (16384, 48, 48, False), (2048, 128, 128, False), (512, 16, 16, True))


def build(walkers: int, out: pathlib.Path):
    """The kernel's entry and plan helper, built with ``walkers`` walking warps."""
    from panvc3_tpu_torch._build import run_compiler
    from panvc3_tpu_torch.ops import _kernels

    text = SOURCE.read_text()
    key = "constexpr int MAX_WALKERS = 4;"
    if text.count(key) != 1:
        raise RuntimeError(f"{SOURCE.name} has no line {key!r}")
    cu = out / f"realign_traceback_w{walkers}.cu"
    cu.write_text(text.replace(key, f"constexpr int MAX_WALKERS = {walkers};"))
    so = out / f"librealign_traceback_w{walkers}.so"
    run_compiler([_kernels.nvcc_path(), *_kernels.NVCC_FLAGS, "-o", str(so), str(cu)],
                 f"probe plan of {walkers} walking warps")
    lib = ctypes.CDLL(str(so))
    entry = lib.realign_traceback
    entry.argtypes = _kernels._SIGNATURES["realign_traceback"][1]
    plan = lib.realign_traceback_plan
    plan.argtypes = _kernels._HELPERS["realign_traceback_plan"][1]
    entry.restype = plan.restype = ctypes.c_int
    return entry, plan


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--walkers", type=int, nargs="+", default=[2, 4, 6, 8])
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("probe_traceback_plans: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from panvc3_tpu_torch import build_root
    from panvc3_tpu_torch.ops import realign_batch as trb
    from panvc3_tpu_torch.ops.realign_pallas import fill_batch
    from panvc3_tpu_torch.ops.realign_traceback import PLAN_FIELDS

    out = build_root() / "probe_traceback_plans"
    out.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(args.walkers)) as pool:
        libs = dict(zip(args.walkers, pool.map(lambda w: build(w, out), args.walkers)))
    card = cs.card_line()
    rng = np.random.default_rng(1)
    flush = torch.empty(cs.L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    times = {}
    for B, Q, R, full in SHAPES:
        shape = f"{B}x{Q}x{R} {'full' if full else 'random'}"
        ref, qry, m, n = cs.random_runs(rng, B, Q, R, full)
        sub = trb._substitution_scores(ref, qry).contiguous()
        trace = fill_batch(sub, m, n, 0.0, -1.0, R, Q)
        del sub
        want_ops, want_cnt = trb._traceback_batch(trace, ref, qry, m, n, R, Q)
        for walkers, (entry, plan_fn) in libs.items():
            ops = torch.empty((B, R + Q), dtype=torch.int8, device="cuda")
            cnt = torch.empty(B, dtype=torch.int32, device="cuda")

            def launch():
                rc = entry(trace.data_ptr(), ref.data_ptr(), qry.data_ptr(), m.data_ptr(),
                           n.data_ptr(), B, R, Q, ops.data_ptr(), cnt.data_ptr(), stream)
                if rc != 0:
                    raise RuntimeError(f"launch failed: cudaError {rc}")

            launch()
            torch.cuda.synchronize()
            if not (torch.equal(ops, want_ops) and torch.equal(cnt, want_cnt)):
                raise AssertionError(f"{walkers} walking warps != plain version at {shape}")
            warm = cs.time_ms(launch, 20)
            cold = cs.time_flushed_ms(launch, 10, flush)
            raw = (ctypes.c_int * len(PLAN_FIELDS))()
            if plan_fn(B, R, Q, ctypes.addressof(raw)) != 0:
                raise RuntimeError("realign_traceback_plan failed")
            plan = dict(zip(PLAN_FIELDS, raw))
            times.setdefault(shape, {})[walkers] = (warm, cold)
            print(
                f"[probe] {shape}, {walkers} walking warps: == plain; warm {warm:.4f} ms, "
                f"L2 flushed {cold:.4f} ms; plan {plan} ({card})",
                flush=True,
            )
    print(json.dumps({"card": card, "ms_warm_flushed": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
