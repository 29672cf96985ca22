"""The port's postprocess copies and its workflow driver against panvc3_tpu.

Each case of ``tests/test_postprocess.py`` runs through
``panvc3_tpu_torch.postprocess`` and ``panvc3_tpu.postprocess`` with equal
output.  The port's coverage tools run the shared C TSV codec from the
port's build and, under ``PANVC3_COVTOOLS_FAST=0``, the Python loops;
``panvc3_tpu`` has no native build here, so its side is the Python loops:
both of the port's paths must equal it.  ``python -m
panvc3_tpu_torch.workflow --device cpu`` on the bundled toy data must give
``workflows/run_test_workflow.py``'s final SAM (``@PG`` stripped).
"""

from __future__ import annotations

import io
import os
import pathlib
import random
import subprocess
import sys

import pytest

from panvc3_tpu.postprocess import count_diff as jax_cd
from panvc3_tpu.postprocess import coverage_tools as jax_ct
from panvc3_tpu.postprocess import reference_bias as jax_rb
from panvc3_tpu_torch.postprocess import count_diff, coverage_tools, reference_bias

from .test_postprocess import COUNTS

REPO = pathlib.Path(__file__).resolve().parent.parent


def _both(fn_name, mods, *args, **kw):
    """(port output, JAX output) of one function writing to ``out``: the
    text written and the value returned."""
    res = []
    for mod in mods:
        out = io.StringIO()
        streams = [io.StringIO(a) if isinstance(a, str) else a for a in args]
        value = getattr(mod, fn_name)(*streams, out, **kw)
        res.append((out.getvalue(), value))
    return res


@pytest.mark.parametrize("min_coverage", [1, 2, 7])
def test_reference_bias_matches_jax(min_coverage):
    got, want = [], []
    for mod, dst in ((reference_bias, got), (jax_rb, want)):
        out, err = io.StringIO(), io.StringIO()
        res = mod.calculate_reference_bias(io.StringIO(COUNTS), out, err, min_coverage=min_coverage)
        dst.append((out.getvalue(), err.getvalue(), res.variants_counted, res.variants_skipped))
    assert got == want


@pytest.mark.parametrize("same", [False, True])
def test_count_diff_matches_jax(same):
    lhs = "V\tt\t2\tid1\tC\tT\n" + "R\t6\tC\n" + "V\tt\t5\tid2\tA\tG\n" + "R\t2\tG\n"
    rhs = lhs if same else "V\tt\t2\tid1\tC\tT\n" + "R\t5\tC\n" + "V\tt\t5\tid2\tA\tG\n" + "R\t2\tG\n"
    got, want = _both("diff_streams", (count_diff, jax_cd), lhs, rhs)
    assert got == want
    assert got[1] == (0 if same else 1)


def _stream(rng, n, start=0, step_max=3, cov_lo=0, shuffle=False):
    pos = []
    p = start
    for _ in range(n):
        pos.append(p)
        p += rng.randint(1, step_max)
    if shuffle:
        rng.shuffle(pos)
    rows = [f"{p}\t{rng.randint(cov_lo, 9)}" for p in pos]
    return "POSITION\tCOVERAGE\n" + "\n".join(rows) + "\n"


_RNG = random.Random(3)
HIST_CASES = [
    ("POSITION\tCOVERAGE\n0\t2\n1\t2\n3\t1\n", dict(count_missing=True, max_length=5)),
    (_stream(_RNG, 200), dict()),
    (_stream(_RNG, 200), dict(count_missing=True)),
    (_stream(_RNG, 200), dict(count_missing=True, max_length=1500)),
    ("POSITION\tCOVERAGE\n", dict()),
    ("POSITION\tCOVERAGE\n", dict(count_missing=True, max_length=7)),
    (_stream(_RNG, 100, cov_lo=-2), dict()),  # negative coverage: the streaming loop
]
MERGE_CASES = [
    ("POSITION\tCOVERAGE\n0\t1\n2\t3\n", "POSITION\tCOVERAGE\n1\t2\n2\t4\n"),
    (_stream(_RNG, 150), _stream(_RNG, 180, start=37)),
    (_stream(_RNG, 10), "POSITION\tCOVERAGE\n"),
    ("POSITION\tCOVERAGE\n", "POSITION\tCOVERAGE\n"),
    (_stream(_RNG, 60, shuffle=True), _stream(_RNG, 60)),  # unsorted: streaming merge
]


@pytest.mark.parametrize("fast", ["1", "0"])
@pytest.mark.parametrize("case", range(len(HIST_CASES)))
def test_coverage_histogram_matches_jax(monkeypatch, case, fast):
    text, kw = HIST_CASES[case]
    monkeypatch.setenv("PANVC3_COVTOOLS_FAST", fast)
    got, want = _both("coverage_histogram", (coverage_tools, jax_ct), text, **kw)
    assert got == want


@pytest.mark.parametrize("fast", ["1", "0"])
@pytest.mark.parametrize("case", range(len(MERGE_CASES)))
def test_merge_coverages_matches_jax(monkeypatch, case, fast):
    a, b = MERGE_CASES[case]
    monkeypatch.setenv("PANVC3_COVTOOLS_FAST", fast)
    got, want = _both("merge_coverages", (coverage_tools, jax_ct), a, b)
    assert got == want


def test_coverage_fast_path_is_the_c_codec(monkeypatch):
    """With the switch on, the port's histogram and merge parse and format
    through its C build (the differential above then compares C with
    Python)."""
    from panvc3_tpu_torch import native

    calls = []
    real = native.get_native()

    class Spy:
        def __getattr__(self, name):
            calls.append(name)
            return getattr(real, name)

    monkeypatch.setattr(coverage_tools, "get_native", lambda: Spy())
    text, kw = HIST_CASES[1]
    coverage_tools.coverage_histogram(io.StringIO(text), io.StringIO(), **kw)
    coverage_tools.merge_coverages(*(io.StringIO(t) for t in MERGE_CASES[1]), io.StringIO())
    assert calls == ["parse_pos_cov", "parse_pos_cov", "parse_pos_cov", "format_pos_cov"]


@pytest.mark.parametrize("with_bed", [False, True])
def test_filter_with_vcf_matches_jax(tmp_path, with_bed):
    vcf = tmp_path / "x.vcf"
    vcf.write_text(
        "##fileformat=VCFv4.2\n"
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
        "t\t3\t.\tAC\tA\t.\t.\t.\n"
        "u\t4\t.\tG\tC\t.\t.\t.\n"
        "t\t9\t.\tGAT\tG\t.\t.\t.\n"
    )
    cov = "POSITION\tCOVERAGE\n1\t5\n2\t6\n3\t7\n4\t8\n9\t2\n"
    bed = "t\t0\t4\nu\t0\t9\n" if with_bed else None
    res = []
    for mod in (coverage_tools, jax_ct):
        out = io.StringIO()
        mod.filter_with_vcf(
            io.StringIO(cov), str(vcf), out, chr_id="t",
            bed_fp=io.StringIO(bed) if bed else None,
        )
        res.append(out.getvalue())
    assert res[0] == res[1]
    assert res[0].startswith("POSITION\tCOVERAGE\n2\t6\n3\t7\n")


@pytest.mark.parametrize("description", [None, "chosen"])
def test_filter_reference_matches_jax(description):
    fasta = ">a desc\nACGT\nACGT\n>b\nTTTT\n>c x\nGG\n"
    res = []
    for mod in (coverage_tools, jax_ct):
        out, ids = io.StringIO(), io.StringIO()
        mod.filter_reference(
            io.StringIO(fasta), out, remove_contigs=frozenset({"a"}),
            description=description, contig_id_out=ids,
        )
        res.append((out.getvalue(), ids.getvalue()))
    assert res[0] == res[1]
    assert res[0][1] == "a\nb\nc\n"


def _strip_pg(path: pathlib.Path) -> bytes:
    return b"\n".join(ln for ln in path.read_bytes().split(b"\n") if not ln.startswith(b"@PG"))


def test_workflow_driver_matches_jax_driver(tmp_path):
    """The port's workflow driver (device engine on the CPU) and
    workflows/run_test_workflow.py (device engine) on the bundled toy data:
    the same final SAM."""
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    runs = {
        "port": [sys.executable, "-m", "panvc3_tpu_torch.workflow", "--device", "cpu"],
        "jax": [sys.executable, str(REPO / "workflows/run_test_workflow.py")],
    }
    for name, cmd in runs.items():
        proc = subprocess.run(
            cmd + ["--workdir", str(tmp_path / name), "--engine", "device", "--n-reads", "300"],
            env=env, capture_output=True, timeout=300, cwd=str(REPO),
        )
        assert proc.returncode == 0, proc.stderr.decode()[-3000:]
    final = "alignments.mapq-recalculated.sam"
    port_sam = _strip_pg(tmp_path / "port" / final)
    assert port_sam == _strip_pg(tmp_path / "jax" / final)
    assert port_sam.count(b"\n") > 300


def test_workflow_driver_defaults_to_the_device_engine_on_the_card(tmp_path, monkeypatch):
    """With no flags the driver projects on the device engine on ``cuda``:
    without a card it raises before any stage runs, and ``--device``
    takes only ``cuda`` or ``cpu``."""
    import torch

    from panvc3_tpu_torch import workflow
    from panvc3_tpu_torch.pipeline import project_alignments

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        workflow.main(["--workdir", str(tmp_path / "bare")])
    assert not (tmp_path / "bare").exists()
    with pytest.raises(SystemExit):
        workflow.main(["--workdir", str(tmp_path / "tpu"), "--device", "tpu"])

    class Projected(Exception):
        pass

    seen = {}

    def stub(src, dst, cfg, device):
        seen.update(engine=cfg.engine, device=device)
        raise Projected

    monkeypatch.setattr(project_alignments, "run_project_alignments", stub)
    with pytest.raises(Projected):
        workflow.main(["--workdir", str(tmp_path / "cpu"), "--device", "cpu", "--n-reads", "10"])
    assert seen == {"engine": "device", "device": torch.device("cpu")}
