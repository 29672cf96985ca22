"""recalculate_mapq of the port against panvc3_tpu, and the workflow chain.

The CLI cases run as in ``test_torch_tools.py``: both packages' ``main``
in child processes, the port with ``PANVC3_MAPQ_FAST`` on (the C group
engine) and ``=0`` (the object path), everything written compared byte for
byte less ``@PG``.  ``--jobs`` 1, 2 and 4 must give one output.  The pool's
start method follows the CUDA context: ``spawn`` when one is live, else
``fork`` on Linux; a spawned pool is driven from a script with a guarded
``__main__``.  The chain index_msa -> project_alignments -> QNAME sort ->
recalculate_mapq runs on the bundled workflow data through both packages
and meets the committed goldens.
"""

from __future__ import annotations

import gzip
import io
import os
import subprocess
import sys

import numpy as np
import pytest

from panvc3_tpu.io import sam as ref_sam
from panvc3_tpu.pipeline import index_msa as ref_index_msa
from panvc3_tpu.pipeline import project_alignments as ref_pa
from panvc3_tpu.pipeline import recalculate_mapq as ref_mapq
from panvc3_tpu_torch.io import sam as port_sam
from panvc3_tpu_torch.pipeline import index_msa as port_index_msa
from panvc3_tpu_torch.pipeline import project_alignments as port_pa
from panvc3_tpu_torch.pipeline import recalculate_mapq as port_mapq

from . import golden_workflow
from .test_mapq_adversarial import _load as load_adversarial
from .test_torch_tools import REPO, check_case, run_jobs, sam_to_bam

MAPQ_OFF = [{"PANVC3_MAPQ_FAST": "0"}]


def _random_groups() -> bytes:
    """QNAME groups of 1-4 candidates: paired and unpaired, groups mixing
    both, missing AS/XR/XP/YR/YP, float AS, XN bitmasks, soft clips and
    insertions, ``*`` QUAL, extra tags, a float-typed XR (which the C
    engine hands back to the object path) and unmapped records."""
    rng = np.random.default_rng(7)
    names = ["chr1", "chr2"]
    lines = ["@HD\tVN:1.6"] + [f"@SQ\tSN:{n}\tLN:100000" for n in names]
    bases = np.frombuffer(b"ACGTN", dtype=np.uint8)
    for qid in range(1, 401):
        n_cand = int(rng.integers(1, 5))
        paired_group = bool(rng.integers(0, 2))
        mixed = rng.integers(0, 20) == 0
        seq = rng.choice(bases, int(rng.integers(20, 80))).tobytes().decode()
        for c in range(n_cand):
            ref = names[int(rng.integers(0, 2))]
            pos = int(rng.integers(1, 90000))
            L = len(seq)
            n_x = int(rng.integers(0, 4))
            cigar = f"{L - n_x}={n_x}X" if n_x else f"{L}="
            if rng.integers(0, 10) == 0:
                cigar = f"2S{L - 2 - n_x}={n_x}X" if L - 2 - n_x > 0 else f"{L}="
            if rng.integers(0, 12) == 0:
                cigar = f"{L - 5}=2I3S" if L > 8 else f"{L}="
            paired = paired_group if not mixed else bool(c % 2)
            flag = (99 if c % 2 == 0 else 147) if paired else 0
            if paired:
                rnext = "=" if rng.integers(0, 2) else names[int(rng.integers(0, 2))]
                pnext = int(rng.integers(1, 90000))
            else:
                rnext, pnext = "*", 0
            qual = "".join(chr(33 + int(q)) for q in rng.integers(0, 42, L)) if rng.integers(0, 8) else "*"
            tags = []
            if rng.integers(0, 10):
                if rng.integers(0, 6) == 0:
                    tags.append(f"AS:f:{float(-int(rng.integers(0, 30))) + 0.5}")
                else:
                    tags.append(f"AS:i:{-int(rng.integers(0, 30))}")
            if rng.integers(0, 10):
                tags.append(f"XR:i:{int(rng.integers(0, 2))}")
                tags.append(f"XP:i:{int(rng.integers(0, 90000))}")
            if paired and rng.integers(0, 10):
                tags.append(f"YR:i:{int(rng.integers(0, 2))}")
                tags.append(f"YP:i:{pnext - 1}")
            if rng.integers(0, 4) == 0:
                nb = (L + 7) // 8 + int(rng.integers(0, 3))
                tags.append("XN:B:C," + ",".join(str(int(v)) for v in rng.integers(0, 256, nb)))
            if rng.integers(0, 3) == 0:
                tags.append(f"ZZ:Z:extra{c}")
            if rng.integers(0, 5) == 0:
                tags.append(f"XS:i:{-int(rng.integers(0, 50))}")
            if rng.integers(0, 60) == 0:
                tags.append("XR:f:1")
                tags.append(f"XP:i:{int(rng.integers(0, 90000))}")
            lines.append(
                f"r{qid}\t{flag}\t{ref}\t{pos}\t60\t{cigar}\t{rnext}\t"
                f"{pnext}\t0\t{seq}\t{qual}" + ("\t" + "\t".join(tags) if tags else "")
            )
        if rng.integers(0, 15) == 0:
            lines.append(f"u{qid}\t4\t*\t0\t0\t*\t*\t0\t0\tACGT\tIIII")
    return ("\n".join(lines) + "\n").encode()


def _pairs(n_pairs: int = 24000, seed: int = 3) -> bytes:
    """Pairs with one or two candidate placements, past the 16384-line
    chunk of the worker pool, so that ``--jobs`` has several tasks."""
    rng = np.random.default_rng(seed)
    lines = ["@HD\tVN:1.6\tSO:queryname", "@SQ\tSN:chr1\tLN:100000"]
    for i in range(n_pairs):
        p1, p2 = int(rng.integers(0, 90000)), int(rng.integers(0, 90000))
        for c in range(1 + (i % 3 == 0)):
            off = c * 7
            for pos, mpos, flag in ((p1 + off, p2, 99), (p2, p1 + off, 147)):
                lines.append(
                    f"pair{i}\t{flag}\tchr1\t{pos + 1}\t60\t50=\t=\t{mpos + 1}"
                    f"\t200\t" + "ACGTA" * 10 + "\t" + "I" * 50
                    + f"\tAS:i:-{int(rng.integers(0, 12))}\tXR:i:0"
                    f"\tXP:i:{pos}\tYR:i:0\tYP:i:{mpos}"
                )
        if i % 500 == 0:
            lines.append(f"pair{i}x\t4\t*\t0\t0\t*\t*\t0\t0\tACGT\tIIII")
    return ("\n".join(lines) + "\n").encode()


_HEAD = "@HD\tVN:1.6\n@SQ\tSN:c\tLN:1000\n"
_OVERRUN = _HEAD + "a\t0\tc\t5\t40\t100=\t*\t0\t0\t" + "A" * 30 + "\t" + "I" * 30 + "\tAS:i:-3\tXR:i:0\tXP:i:5\n"
_LOW_QUAL = _HEAD + "b\t0\tc\t5\t40\t30X\t*\t0\t0\t" + "A" * 30 + "\t" + chr(30) * 30 + "\tAS:i:-3\tXR:i:0\tXP:i:5\n"
_M_OPS = _HEAD + "m\t0\tc\t5\t40\t30M\t*\t0\t0\t" + "A" * 30 + "\t" + "I" * 30 + "\tAS:i:-3\tXR:i:0\tXP:i:5\n"


def _cases(root) -> dict:
    def put(name, data):
        if root is None:
            return ""
        path = root / name
        path.write_bytes(data.encode() if isinstance(data, str) else data)
        return str(path)

    groups = put("groups.sam", _random_groups() if root else b"")
    groups_bam = put("groups.bam", sam_to_bam(_random_groups()) if root else b"")
    pairs = put("pairs.sam", _pairs() if root else b"")
    pairs_bam = put("pairs.bam", sam_to_bam(_pairs(9000, 9)) if root else b"")
    adversarial = put("adversarial.sam", load_adversarial()[0] if root else b"")
    tool = ["recalculate_mapq", "--status-output-interval", "0"]
    c: dict = {}
    for mode, extra in (("astag", []), ("rescore", ["--rescore-alignments"])):
        c[f"groups-{mode}"] = dict(steps=[tool + ["-a", groups, "-o", "{out}/o.sam", *extra]], off=MAPQ_OFF, codes=[0])
        c[f"groups-{mode}-bam-bam"] = dict(
            steps=[tool + ["-a", groups_bam, "-B", "-b", "-o", "{out}/o.bam", *extra]], off=MAPQ_OFF, codes=[0])
        c[f"adversarial-{mode}"] = dict(steps=[tool + ["-a", adversarial, "-o", "{out}/o.sam", *extra]],
                                        off=MAPQ_OFF, codes=[0])
    c["groups-rescore-sam-bam"] = dict(
        steps=[tool + ["-a", groups, "--output-bam", "-o", "{out}/o.bam", "--rescore-alignments"]],
        off=MAPQ_OFF, codes=[0])
    c["groups-rescore-penalties"] = dict(steps=[tool + [
        "-a", groups, "-o", "{out}/o.sam", "--rescore-alignments", "--min-mismatch-penalty", "1",
        "--max-mismatch-penalty", "9", "--n-penalty", "2", "--gap-opening-penalty", "7",
        "--gap-extension-penalty", "2",
    ]], off=MAPQ_OFF, codes=[0])
    c["groups-rescore-tag-names"] = dict(steps=[tool + [
        "-a", groups, "-o", "{out}/o.sam", "--rescore-alignments", "--ref-n-positions-tag", "XN",
        "--original-alignment-score-tag", "ZO", "--new-alignment-score-tag", "ZN",
    ]], off=MAPQ_OFF, codes=[0])
    c["groups-other-position-tags"] = dict(steps=[tool + [
        "-a", groups, "-o", "{out}/o.sam", "--original-rname-tag", "QR", "--original-pos-tag", "QP",
        "--original-rnext-tag", "QS", "--original-pnext-tag", "QT",
    ]], off=MAPQ_OFF, codes=[0])
    c["groups-verbose"] = dict(steps=[tool + ["-a", groups, "-o", "{out}/o.sam", "--verbose",
                                              "--print-reference-names", "--print-invocation"]],
                               off=MAPQ_OFF, codes=[0])
    c["groups-stdin-stdout"] = dict(steps=[tool], stdin=groups, off=MAPQ_OFF, codes=[0])
    for jobs in (1, 2, 4, 0):
        c[f"pairs-jobs{jobs}"] = dict(steps=[tool + ["-a", pairs, "-o", "{out}/o.sam", "--jobs", str(jobs)]],
                                      off=MAPQ_OFF, codes=[0])
    c["pairs-jobs2-bam-bam"] = dict(steps=[tool + ["-a", pairs_bam, "-b", "-o", "{out}/o.bam", "--jobs", "2"]],
                                    off=MAPQ_OFF, codes=[0])
    c["groups-jobs2-rescore"] = dict(steps=[tool + ["-a", groups, "-o", "{out}/o.sam", "--jobs", "2",
                                                    "--rescore-alignments"]], off=MAPQ_OFF, codes=[0])
    c["rescore-overrun"] = dict(steps=[tool + ["-a", put("overrun.sam", _OVERRUN), "-o", "{out}/o.sam",
                                               "--rescore-alignments"]], off=MAPQ_OFF, codes=[1],
                                stderr_has="ERROR: CIGAR overruns the sequence")
    c["rescore-low-qual"] = dict(steps=[tool + ["-a", put("lowq.sam", _LOW_QUAL), "-o", "{out}/o.sam",
                                                "--rescore-alignments"]], off=MAPQ_OFF, codes=[0])
    c["rescore-m-ops"] = dict(steps=[tool + ["-a", put("mops.sam", _M_OPS), "-o", "{out}/o.sam",
                                             "--rescore-alignments"]], off=MAPQ_OFF, codes=[1], stderr_has="ERROR:")
    c["mapq-version"] = dict(steps=[["recalculate_mapq", "--version"]], codes=[0])
    return c


CASE_NAMES = sorted(_cases(None))


@pytest.fixture(scope="module")
def mapq_results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mapq")
    inputs = tmp / "inputs"
    inputs.mkdir()
    cases = _cases(inputs)
    return cases, run_jobs(tmp, cases)


@pytest.mark.parametrize("name", CASE_NAMES)
def test_recalculate_mapq_matches_reference(mapq_results, name):
    cases, results = mapq_results
    check_case(results, cases, name)


@pytest.mark.parametrize("jobs", [2, 4, 0])
def test_jobs_give_the_sequential_output(mapq_results, jobs):
    _, results = mapq_results
    for variant in ("ref", "port", "off0"):
        want = results[variant, "pairs-jobs1"][1]
        got = results[variant, f"pairs-jobs{jobs}"][1]
        assert got["o.sam"] == want["o.sam"] and len(want["o.sam"]) > 5_000_000
        assert got[".stderr"] == want[".stderr"]
        assert b"Total alignments: 64000" in want[".stderr"]


@pytest.mark.parametrize("mode", ["astag", "rescore"])
def test_adversarial_goldens(mapq_results, mode):
    """The locked table of 146 adversarial groups, through the port's CLI
    with the C engine and with the object path."""
    _, results = mapq_results
    want = load_adversarial()[1][mode]
    for variant in ("port", "off0"):
        out = results[variant, f"adversarial-{mode}"][1]["o.sam"]
        got = [ln for ln in out.decode().splitlines() if not ln.startswith("@")]
        assert got == want and len(want) > 100


@pytest.mark.parametrize("seed", [0, 1])
def test_cigar_scorer_matches(seed):
    """``CigarScorer.calculate`` (C only in the port) against panvc3_tpu's
    scorer, the XN bitmask and ``*`` QUAL included."""
    rng = np.random.default_rng(seed)
    scoring = dict(min_mismatch_penalty=2, max_mismatch_penalty=6, n_penalty=1,
                   gap_opening_penalty=5, gap_extension_penalty=3)
    want_scorer = ref_mapq.CigarScorer(ref_mapq.AlignmentScoring(**scoring))
    got_scorer = port_mapq.CigarScorer(port_mapq.AlignmentScoring(**scoring))
    letters = np.frombuffer(b"ACGTNn", np.uint8)
    for _ in range(200):
        n = int(rng.integers(70, 140)) if rng.integers(0, 2) else int(rng.integers(8, 40))
        a, b, c = int(rng.integers(1, n - 5)), int(rng.integers(1, 3)), int(rng.integers(1, 3))
        cigar = [(2, "S"), (a, "="), (b, "X"), (c, "I"), (3, "D"), (n - 2 - a - b - c, "=")]
        seq = rng.choice(letters, n).tobytes().decode()
        qual = "".join(chr(33 + int(q)) for q in rng.integers(0, 60, n)) if rng.integers(0, 5) else "*"
        xn = [int(v) for v in rng.integers(0, 256, (n + 12) // 8)] if rng.integers(0, 2) else []
        args = dict(qname="q", flag=0, ref_id=0, pos=0, cigar=cigar, seq=seq, qual=qual)
        assert got_scorer.calculate(port_sam.SamRecord(**args), xn) == \
            want_scorer.calculate(ref_sam.SamRecord(**args), xn)


# -- the pool's start method ------------------------------------------------------

def test_start_method_follows_the_cuda_context(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert port_mapq.mp_start_method() == "spawn"
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    assert port_mapq.mp_start_method() == ("fork" if sys.platform.startswith("linux") else "spawn")
    monkeypatch.setattr(sys, "platform", "darwin")
    assert port_mapq.mp_start_method() == "spawn"


_SPAWN_SCRIPT = r"""
import io, sys

def run():
    import torch
    from panvc3_tpu_torch.pipeline import recalculate_mapq as rm

    torch.cuda.is_initialized = lambda: True   # as after a launch on the card
    assert rm.mp_start_method() == "spawn"
    sam = open(sys.argv[1], "rb").read()
    outs = []
    for jobs in (1, 3):
        out = io.BytesIO()
        stats = rm.run_recalculate_mapq(io.BytesIO(sam), out, jobs=jobs, status_output_interval=0)
        outs.append((out.getvalue(), stats))
    assert outs[0] == outs[1] and outs[0][1].total_alignments > 30000
    assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules)
    print("SPAWN_OK", outs[0][1].total_alignments)

if __name__ == "__main__":
    run()
"""


def test_spawned_pool_gives_the_sequential_output(mapq_results, tmp_path):
    """With a CUDA context live the pool spawns: the workers import the
    port afresh (never the card) and the output stays that of --jobs 1."""
    cases, _ = mapq_results
    pairs = cases["pairs-jobs1"]["steps"][0][4]
    script = tmp_path / "spawn_mapq.py"
    script.write_text(_SPAWN_SCRIPT)
    proc = subprocess.run(
        [sys.executable, str(script), pairs],
        env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True, timeout=600, cwd=str(tmp_path),
    )
    assert proc.returncode == 0, proc.stderr.decode()[-3000:]
    assert b"SPAWN_OK 64000" in proc.stdout


def test_recalculate_mapq_never_imports_jax():
    import pathlib
    import re

    text = (pathlib.Path(port_mapq.__file__)).read_text()
    assert not re.search(r"\bjax\b", text)
    assert "is_initialized" in text


# -- the workflow chain -------------------------------------------------------------

def _chain(pkg: str, tmp) -> dict[str, bytes]:
    """index_msa -> project_alignments -> QNAME sort -> recalculate_mapq on
    the bundled workflow data, as ``tests/golden_workflow.run_all`` and
    ``workflows/run_test_workflow.py`` drive it, through one package."""
    index_msa, pa, mapq, sam_mod, kw = {
        "ref": (ref_index_msa, ref_pa, ref_mapq, ref_sam, {}),
        "port": (port_index_msa, port_pa, port_mapq, port_sam, {"device": "cpu"}),
    }[pkg]
    data = golden_workflow.DATA
    tsv = tmp / f"{pkg}_input.tsv"
    rows = []
    for line in (data / "index-input/input.tsv").read_text().splitlines():
        chr_id, seq_id, rel = line.split("\t")
        rows.append(f"{chr_id}\t{seq_id}\t{data / rel}")
    tsv.write_text("\n".join(rows) + "\n")
    fasta = io.BytesIO()
    index = index_msa.build_index_from_tsv(str(tsv), pipe_command="bzip2 -d -c", fasta_out=fasta)
    index_path = tmp / f"{pkg}_msa.npz"
    index.save(str(index_path))
    founders = golden_workflow._founders()

    def project(sam: bytes, use_q: bool) -> bytes:
        cfg = pa.ProjectConfig(
            msa_index_path=str(index_path),
            reference_path=str(data / "genome/genome.fa.gz"),
            reference_msa_id="REF",
            ref_id_separator="/",
            tags=pa.TagSpec(rec_idx="XI"),
            preserve_tags=("XS", "YS"),
            use_read_base_qualities=use_q,
            status_output_interval=0,
        )
        out = io.BytesIO()
        pa.run_project_alignments(io.BytesIO(sam), out, cfg, **kw)
        return out.getvalue()

    outputs = {"fasta": fasta.getvalue()}
    projected = project(golden_workflow._match_sam(founders), False)
    outputs["match_projected"] = golden_workflow._strip_pg(projected)
    reader = sam_mod.SamReader(io.BytesIO(projected))
    recs = sorted(reader, key=lambda r: r.qname)
    qsorted = io.BytesIO()
    w = sam_mod.SamWriter(qsorted, reader.header)
    for r in recs:
        w.write(r)
    w.close()
    mq = io.BytesIO()
    mapq.run_recalculate_mapq(io.BytesIO(qsorted.getvalue()), mq, status_output_interval=0)
    outputs["match_mapq"] = golden_workflow._strip_pg(mq.getvalue())
    indel = golden_workflow._indel_sam(founders)
    outputs["indel_projected"] = golden_workflow._strip_pg(project(indel, False))
    outputs["indel_projected_q"] = golden_workflow._strip_pg(project(indel, True))
    return outputs


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("chain")
    return {pkg: _chain(pkg, tmp) for pkg in ("ref", "port")}


@pytest.mark.parametrize("stream", ["fasta", *golden_workflow.GOLDENS])
def test_workflow_chain_matches_reference_and_goldens(chains, stream):
    assert chains["port"][stream] == chains["ref"][stream]
    assert len(chains["port"][stream]) > 10000
    if stream in golden_workflow.GOLDENS:
        golden = gzip.decompress((golden_workflow.GOLDEN_DIR / golden_workflow.GOLDENS[stream]).read_bytes())
        assert chains["port"][stream] == golden
