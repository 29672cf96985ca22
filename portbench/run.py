"""The benchmark of ``panvc3_tpu_torch`` on one NVIDIA card.

    python3 portbench/run.py --workload CELL --seed N --seconds S --trace 0|1

run from the root of a checkout.  ``CELL`` is a workload of
``BENCHMARK.json``; its configuration, traffic mix, metrics and plain
reference are found by name under ``portbench/`` (``harness/spec.py``).

Set-up (``setup_s``) makes the cell's inputs from the seed
(``harness/inputs.py``: the MSA index by the port's ``index_msa``, the
reference FASTA, the alignments as BAM), starts the consumer process that
drains the tool's output FIFO, and runs one warm-up call on one pass of
the record pool.  The window then runs whole calls of the port's
``project_alignments`` CLI entry back to back until ``--seconds`` have
passed; the call running then finishes.  With ``--trace 1`` the window
runs under ``torch.profiler`` and its calls print the fast lane's
per-stage seconds, and after it five calls on one record time a call's
fixed cost; the run reports the per-layer metrics.  Without it, the
end-to-end ones.

Once the window has closed, the plain reference
(``reference/<name>.py``, in a process of its own that loads nothing of
the program) judges the lines the consumer kept at sampled positions of
every call, and the consumer's own count and order of every line.  The
numbers compared are printed, each beside its limit, as the last lines of
standard error and under ``checks``, the last key of the result: one JSON
line, the last of standard output.

Exits 3, printing no result, without as many CUDA devices as the cell
asks for, or where a process of the run has loaded ``jax``, ``jaxlib``,
``flax`` or ``panvc3_tpu`` (top-level names compared whole).
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))

from harness import profile  # noqa: E402
from harness.inputs import CellInputs  # noqa: E402
from harness.modules import forbidden_loaded  # noqa: E402
from harness.spec import Spec  # noqa: E402
from harness.tool import Consumer, Tool  # noqa: E402

FIXED_CALLS = 5
REFERENCE_SECONDS = 300


class Run:
    """What the metric readers read of one run."""

    def __init__(self):
        self.setup_s = 0.0
        self.window_s = 0.0
        self.records = 0
        self.calls: list[dict] = []       # the window's calls
        self.profile: dict | None = None  # the traced window (--trace 1)
        self.fixed_call_s: list[float] = []

    def prof_us_per_record(self, stages) -> float | None:
        """Microseconds per record in ``stages`` of the window's
        ``[fastlane prof]`` lines; None where no call printed one."""
        calls = [c for c in self.calls if c["prof"] is not None]
        if not calls:
            return None
        seconds = sum(c["prof"].get(s, 0.0) for c in calls for s in stages)
        return seconds / sum(c["records"] for c in calls) * 1e6


def log(message: str) -> None:
    print(f"portbench: {message}", file=sys.stderr, flush=True)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def judge(spec: Spec, config: dict, mix: dict, seed: int, kept: pathlib.Path, work: pathlib.Path) -> dict:
    """The plain reference's verdict on the kept lines, from its own
    process."""
    job = work / "reference-job.json"
    job.write_text(json.dumps({"seed": seed, "config": config, "traffic": mix, "kept": str(kept),
                               "bench": str(spec.bench)}))
    done = subprocess.run(
        [sys.executable, str(spec.reference(config["reference"])), str(job)],
        capture_output=True, text=True, timeout=REFERENCE_SECONDS,
    )
    sys.stderr.write(done.stderr)
    if done.returncode != 0 or not done.stdout.strip():
        return {"compared": 0, "wrong": 0, "first_wrong": None, "forbidden_modules": [],
                "header_problems": [f"the reference exited {done.returncode}"]}
    return json.loads(done.stdout.strip().splitlines()[-1])


def measure(args, config: dict, mix: dict, bench: pathlib.Path, work: pathlib.Path, cli_main,
            device: str, sync, counters, t0: float):
    """Set-up, the window and, with ``--trace 1``, the traced extras:
    (the run, the calls outside the window, the device's peak memory, the
    forbidden modules the consumer loaded, the consumer's kept lines)."""
    import torch

    run = Run()
    extra: list[dict] = []
    consumer = None
    try:
        cell_inputs = CellInputs(work, args.seed, config, mix, cli_main, bench,
                                 one_record=bool(args.trace))
        log(f"inputs made by {time.perf_counter() - t0:.3f} s ({cell_inputs.bytes_written} bytes "
            "of BAM; " + ", ".join(f"{k} {v:.3f} s" for k, v in cell_inputs.seconds.items()) + ")")
        consumer = Consumer(work, cell_inputs.line_starts, cell_inputs.sample)
        fill = {"device": device, "msa_index": cell_inputs.index, "reference": cell_inputs.fasta,
                "order": cell_inputs.order}
        tool = Tool(cli_main, config["tool_argv"], fill, consumer, work, sync, counters)
        extra.append(tool.call(cell_inputs.one_pass, cell_inputs.pool_records))
        run.setup_s = time.perf_counter() - t0
        log(f"warm-up call {extra[0]['seconds']:.3f} s; set-up {run.setup_s:.3f} s")

        traced: dict = {}
        tracing = (lambda: profile.traced(work / "trace.json", traced)) if args.trace \
            else contextlib.nullcontext
        with tracing():
            start = time.perf_counter()
            while True:
                span = (lambda n=len(run.calls): profile.call_span(n)) if args.trace \
                    else contextlib.nullcontext
                run.calls.append(tool.call(cell_inputs.alignments, cell_inputs.records_per_call, span))
                if time.perf_counter() - start >= args.seconds:
                    break
            run.window_s = time.perf_counter() - start
        run.records = sum(c["records"] for c in run.calls)
        log(f"window {run.window_s:.3f} s, calls " + ", ".join(f"{c['seconds']:.3f}" for c in run.calls))
        peak = torch.cuda.max_memory_allocated() if device.startswith("cuda") else 0
        if traced:
            run.profile = {**traced, "records": run.records}

        if args.trace:
            for _ in range(FIXED_CALLS):
                call = tool.call(cell_inputs.one_record, 1)
                extra.append(call)
                run.fixed_call_s.append(call["seconds"])
        consumer_loaded = consumer.stop()
    finally:
        if consumer is not None:
            consumer.kill()
    return run, extra, peak, consumer_loaded, consumer.kept


def main(argv=None, *, root: pathlib.Path = ROOT, bench: pathlib.Path = HERE,
         device: str = "cuda", look_for_chip: bool = True, t0: float = T0) -> int:
    args = parse(argv)
    args.seed %= 1 << 63  # the generators take seeds of 0 and up
    spec = Spec(root, bench)
    cell = spec.cell(args.workload)
    config = spec.config(cell["config"])
    mix = spec.traffic(cell["traffic"])
    # the program's switches cleared: the run takes its default path
    for key in [k for k in os.environ if k.startswith("PANVC3_")]:
        del os.environ[key]
    if args.trace:
        os.environ["PANVC3_FASTLANE_PROF"] = "1"
    for key, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[key] = str(ROOT / "build" / "portbench" / sub)

    import torch

    if look_for_chip and (not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]):
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); found {found}",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT))
    from panvc3_tpu_torch.cli.main import main as cli_main
    from panvc3_tpu_torch.ops import _kernels
    from panvc3_tpu_torch.pipeline import fastlane

    on_card = device.startswith("cuda")
    log(f"imports and checks {time.perf_counter() - t0:.3f} s")
    work = pathlib.Path(tempfile.mkdtemp(prefix="portbench-"))
    try:
        run, extra, peak, consumer_loaded, kept = measure(
            args, config, mix, bench, work, cli_main, device,
            torch.cuda.synchronize if on_card else (lambda: None),
            lambda: {**_kernels.LAUNCHES, **fastlane.AGG_DIAG}, t0,
        )
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        verdict = judge(spec, config, mix, args.seed, kept, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    calls = run.calls + extra
    window_failed = sum(
        c["expected"] if c["rc"] else abs(c["expected"] - c["records"]) + c["out_of_order"]
        for c in run.calls
    )
    checks = {
        "calls_failed": (sum(1 for c in calls if c["rc"]), "== 0"),
        "records_missing_or_extra": (sum(abs(c["expected"] - c["records"]) for c in calls), "== 0"),
        "lines_out_of_place": (sum(c["out_of_order"] for c in calls), "== 0"),
        "sampled_lines_compared": (verdict["compared"], ">= 1"),
        "sampled_lines_wrong": (verdict["wrong"], "== 0"),
        "header_problems": (len(verdict["header_problems"]), "== 0"),
    }
    correct = all(
        (value >= 1) if limit == ">= 1" else (value == 0) for value, limit in checks.values()
    )
    metrics = {}
    for m in spec.metrics(args.workload, bool(args.trace)):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": cell["chips"],
        "memory_peak_bytes": peak,
    }
    result = {"correct": correct, "attempted": sum(c["expected"] for c in run.calls),
              "failed": window_failed, "metrics": metrics, "device": dev}
    if args.trace and run.profile:
        dev["busy_s"] = run.profile["busy_s"]
        dev["window_s"] = run.profile["window_s"]
        result["breakdown"] = run.profile["breakdown"]
    if verdict.get("first_wrong"):
        print(f"portbench: first wrong line {json.dumps(verdict['first_wrong'])}", file=sys.stderr)
    for problem in verdict["header_problems"]:
        print(f"portbench: {problem}", file=sys.stderr)
    result["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in checks.items()}
    for name, (value, limit) in checks.items():
        print(f"portbench check: {name} {value} (limit {limit})", file=sys.stderr)
    # every reader has run: whatever the run loads, it has loaded
    bad = {"this process": forbidden_loaded(), "the consumer": consumer_loaded,
           "the reference": verdict["forbidden_modules"]}
    if any(bad.values()):
        for where, names in bad.items():
            if names:
                print(f"portbench: {where} loaded {', '.join(names)}", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
