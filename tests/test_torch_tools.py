"""The eight host tools of the port against panvc3_tpu, through both CLIs.

Every case is one or more command lines.  They run through
``panvc3_tpu.cli.main.main`` in one child process and through
``panvc3_tpu_torch.cli.main.main`` in another (so neither package sees
the other), with standard input, output and error redirected at the
descriptor level.  The port runs each case with its tool's
``PANVC3_*_FAST`` switch on (the C chunk engines) and again with it ``=0``
(the Python paths); panvc3_tpu runs whichever of the two its own loader
finds a build for.  Exit codes, standard output, standard error (less
timestamped log lines) and every file written must be equal: text files
byte for byte less ``@PG`` lines (which carry the command line), BAM
files as header plus the records of the inflated payload, decoded field by
field and printed as text (the C encoder keeps the tags' order, the
Python one sorts them, so the bytes differ wherever the lanes do), index
archives array by array.

The port's copies of the small helpers that the tools and their tests call
(``cigar``, ``bitvec``, ``msa_index``, ``seqbuf``, ``alphabet``,
``io.fasta``, ``io.bed``, ``io.vcf``, ``utils``) meet their originals at
the end of the file.
"""

from __future__ import annotations

import gzip
import io
import json
import os
import pathlib
import random
import struct
import subprocess
import sys

import numpy as np
import pytest

from panvc3_tpu import alphabet as ref_alphabet
from panvc3_tpu import bitvec as ref_bitvec
from panvc3_tpu import cigar as ref_cigar
from panvc3_tpu import msa_index as ref_msa
from panvc3_tpu import seqbuf as ref_seqbuf
from panvc3_tpu import utils as ref_utils
from panvc3_tpu.io import bed as ref_bed
from panvc3_tpu.io import fasta as ref_fasta
from panvc3_tpu.io import sam as ref_sam
from panvc3_tpu.io import vcf as ref_vcf
from panvc3_tpu_torch import alphabet as port_alphabet
from panvc3_tpu_torch import bitvec as port_bitvec
from panvc3_tpu_torch import cigar as port_cigar
from panvc3_tpu_torch import msa_index as port_msa
from panvc3_tpu_torch import seqbuf as port_seqbuf
from panvc3_tpu_torch import utils as port_utils
from panvc3_tpu_torch.io import bed as port_bed
from panvc3_tpu_torch.io import fasta as port_fasta
from panvc3_tpu_torch.io import vcf as port_vcf

from .test_count_supporting_reads import _random_workload
from .test_workflow_data import WORKFLOW

REPO = pathlib.Path(__file__).resolve().parent.parent

# Runs jobs [{id, steps: [argv...], env, stdin}] through <package>.cli.main;
# each job's descriptors 0/1/2 are files under <out>/<id>/, and {out} in an
# argument names that directory.
_RUNNER = r"""
import importlib, json, os, sys
package, jobs_path, out_root = sys.argv[1:4]
main = importlib.import_module(package + ".cli.main").main
jobs = json.load(open(jobs_path))
keep = [os.dup(0), os.dup(1), os.dup(2)]
stdout, stderr = sys.stdout, sys.stderr
codes = {}
for job in jobs:
    out_dir = os.path.join(out_root, job["id"])
    os.makedirs(out_dir, exist_ok=True)
    saved_env = dict(os.environ)
    os.environ.update(job["env"])
    fds = [
        os.open(job["stdin"] or os.devnull, os.O_RDONLY),
        os.open(out_dir + "/.stdout", os.O_WRONLY | os.O_CREAT | os.O_TRUNC),
        os.open(out_dir + "/.stderr", os.O_WRONLY | os.O_CREAT | os.O_TRUNC),
    ]
    for fd in (0, 1, 2):
        os.dup2(fds[fd], fd)
    sys.stdin = open(0, "r", closefd=False)
    codes[job["id"]] = []
    for step in job["steps"]:
        argv = [a.replace("{out}", out_dir) for a in step]
        sys.argv = ["panvc3"] + argv
        try:
            rc = main(argv)
        except SystemExit as exc:
            rc = exc.code
        except BaseException as exc:
            rc = "raised " + type(exc).__name__ + ": " + str(exc)
        stdout.flush()
        stderr.flush()
        codes[job["id"]].append(rc)
    for fd in (0, 1, 2):
        os.dup2(keep[fd], fd)
        os.close(fds[fd])
    os.environ.clear()
    os.environ.update(saved_env)
# the port's process must end with no JAX and no panvc3_tpu module loaded
leaked = sorted(
    m for m in sys.modules
    if package != "panvc3_tpu" and (
        m in ("jax", "panvc3_tpu") or m.startswith(("jax.", "jaxlib", "panvc3_tpu."))
    )
)
json.dump({"codes": codes, "leaked": leaked}, open(out_root + "/result.json", "w"))
"""


def _strip_pg(data: bytes) -> bytes:
    return b"\n".join(ln for ln in data.split(b"\n") if not ln.startswith(b"@PG"))


def _strip_log(data: bytes) -> bytes:
    """Standard error less the timestamped log lines and the PID."""
    return b"\n".join(
        ln for ln in data.split(b"\n")
        if not (ln.startswith(b"[20") or ln.startswith(b"PID: "))
    )


def _bam_view(data: bytes):
    """A BAM file as (header lines less @PG, reference table, records as
    canonical text, the fields of each record of the inflated payload)."""
    reader = ref_sam.SamReader(io.BytesIO(data))
    recs = [ref_sam.format_sam_record(r, reader.header) for r in reader]
    payload = gzip.decompress(data)
    assert payload[:4] == b"BAM\x01"
    (l_text,) = struct.unpack_from("<i", payload, 4)
    off = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", payload, off)
    off += 4
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", payload, off)
        off += 8 + l_name
    fields = []
    while off < len(payload):
        (size,) = struct.unpack_from("<I", payload, off)
        rec = ref_sam._decode_bam_record(payload[off + 4:off + 4 + size], reader.header)
        fields.append(tuple(getattr(rec, k) for k in rec.__slots__))
        off += 4 + size
    assert off == len(payload) and len(fields) == len(recs)
    return (
        [ln for ln in reader.header.lines if not ln.startswith("@PG")],
        list(zip(reader.header.ref_names, reader.header.ref_lengths)),
        recs,
        fields,
    )


def _view(name: str, data: bytes, out_dir: str):
    if name in (".stdout", ".stderr"):
        # the one difference allowed: the package's own name, and the
        # directory the case wrote to
        data = data.replace(out_dir.encode(), b"{out}").replace(b"panvc3_tpu_torch", b"panvc3_tpu")
    if name.endswith(".npz"):
        with np.load(io.BytesIO(data)) as z:
            return {k: z[k].tolist() for k in z.files}
    if data[:2] == b"\x1f\x8b":
        return _bam_view(data)
    if name == ".stderr":
        return _strip_log(data)
    return _strip_pg(data)


def run_jobs(tmp: pathlib.Path, cases: dict) -> dict:
    """Run every case through both packages; ``{(variant, case): (exit
    codes, {file: view})}`` with variants ``ref``, ``port`` and ``off<i>``
    (the port with the case's i-th switch setting)."""
    jobs = {"panvc3_tpu": [], "panvc3_tpu_torch": []}
    for name, case in cases.items():
        stdin = case.get("stdin")  # bytes, or the path of a file
        if isinstance(stdin, bytes):
            stdin = str(tmp / f"{name}.stdin")
            pathlib.Path(stdin).write_bytes(case["stdin"])
        base = {"steps": case["steps"], "stdin": stdin}
        env = case.get("env", {})
        jobs["panvc3_tpu"].append({**base, "id": f"ref.{name}", "env": env})
        jobs["panvc3_tpu_torch"].append({**base, "id": f"port.{name}", "env": env})
        for i, off in enumerate(case.get("off", [])):
            jobs["panvc3_tpu_torch"].append(
                {**base, "id": f"off{i}.{name}", "env": {**env, **off}}
            )
    results = {}
    for package, pjobs in jobs.items():
        root = tmp / package
        root.mkdir()
        (root / "jobs.json").write_text(json.dumps(pjobs))
        env = {k: v for k, v in os.environ.items() if not k.startswith("PANVC3_")}
        proc = subprocess.run(
            [sys.executable, "-c", _RUNNER, package, str(root / "jobs.json"), str(root)],
            env=dict(env, PYTHONPATH=str(REPO)), capture_output=True, timeout=900,
            cwd=str(tmp),
        )
        assert proc.returncode == 0, proc.stderr.decode()[-4000:]
        res = json.loads((root / "result.json").read_text())
        assert res["leaked"] == [], res["leaked"]
        for job in pjobs:
            variant, name = job["id"].split(".", 1)
            files = {
                str(p.relative_to(root / job["id"])): _view(p.name, p.read_bytes(), str(root / job["id"]))
                for p in sorted((root / job["id"]).rglob("*")) if p.is_file()
            }
            results[variant, name] = (res["codes"][job["id"]], files)
    return results


def check_case(results: dict, cases: dict, name: str) -> None:
    want_codes, want_files = results["ref", name]
    expect = cases[name].get("codes")
    if expect is not None:
        assert want_codes == expect, (want_codes, want_files.get(".stderr"))
    variants = ["port"] + [f"off{i}" for i in range(len(cases[name].get("off", [])))]
    for variant in variants:
        codes, files = results[variant, name]
        assert codes == want_codes, (variant, codes, files.get(".stderr"))
        assert sorted(files) == sorted(want_files), variant
        for fname, view in want_files.items():
            assert files[fname] == view, (variant, fname)
    for must in cases[name].get("files", []):
        assert must in want_files, sorted(want_files)
    needle = cases[name].get("stderr_has")
    if needle:
        assert needle.encode() in want_files[".stderr"]


def sam_to_bam(sam: bytes) -> bytes:
    reader = ref_sam.SamReader(io.BytesIO(sam))
    out = io.BytesIO()
    w = ref_sam.SamWriter(out, reader.header, bam=True)
    for rec in reader:
        w.write(rec)
    w.close()
    return out.getvalue()


# -- inputs -------------------------------------------------------------------

def _subset_sam() -> bytes:
    """QNAME groups of 1-4 candidates over two references: MAPQ 255
    groups, mates, canonicalised float and array tags."""
    rng = np.random.default_rng(11)
    names = ["chr1", "chr2"]
    lines = ["@HD\tVN:1.6"] + [f"@SQ\tSN:{n}\tLN:100000" for n in names]
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    for g in range(300):
        for _ in range(int(rng.integers(1, 5))):
            ref = names[int(rng.integers(0, 2))]
            pos = int(rng.integers(1, 90000))
            seq = rng.choice(bases, 30).tobytes().decode()
            mapq = int(rng.choice([0, 10, 37, 60, 255]))
            paired = bool(rng.integers(0, 2))
            rnext = ("=" if rng.integers(0, 2) else names[int(rng.integers(0, 2))]) if paired else "*"
            pnext = int(rng.integers(1, 90000)) if paired else 0
            tags = []
            if rng.integers(0, 2):
                tags.append(f"AS:i:{-int(rng.integers(0, 30))}")
            if rng.integers(0, 4) == 0:
                tags.append("ZF:f:2.50")
            if rng.integers(0, 4) == 0:
                tags.append(f"ZB:B:c,{-int(rng.integers(0, 5))},07")
            lines.append(
                f"r{g}\t{0 if not paired else 99}\t{ref}\t{pos}\t{mapq}\t"
                f"30=\t{rnext}\t{pnext}\t0\t{seq}\t{'I' * 30}"
                + ("\t" + "\t".join(tags) if tags else "")
            )
    return ("\n".join(lines) + "\n").encode()


def _rewrite_inputs() -> tuple[bytes, bytes]:
    """(SAM, FASTA): M/=/X/I/D/S/H/P CIGARs over six contigs with N bases,
    unmapped records, existing XN tags."""
    rng = np.random.default_rng(13)
    refs = {}
    fasta = []
    for nm in ("c1", "c2", "c3", "c4", "c5", "c6"):
        seq = rng.choice(
            np.frombuffer(b"ACGTN", dtype=np.uint8), 5000,
            p=[0.23, 0.23, 0.23, 0.23, 0.08],
        )
        refs[nm] = seq
        fasta.append(f">{nm}\n{seq.tobytes().decode()}")
    names = list(refs)
    lines = ["@HD\tVN:1.6"] + [f"@SQ\tSN:{n}\tLN:5000" for n in names]

    def ref_str(nm, a, b):
        return refs[nm][a:b].tobytes().decode().replace("N", "A")

    for i in range(600):
        nm = names[int(rng.integers(0, len(names)))]
        pos = int(rng.integers(0, 4500))
        kind = int(rng.integers(0, 6))
        L = 50
        seq = ref_str(nm, pos, pos + L)
        if kind == 1:
            cigar = f"10M2I{L - 17}M5S"
            seq = seq[:10] + "GG" + seq[10:L - 7] + "TTTTT"
        elif kind == 2:
            cigar = f"5S10M3D{L - 15}M"
            seq = seq[:5] + ref_str(nm, pos + 5, pos + 15) + ref_str(nm, pos + 18, pos + 18 + L - 15)
        elif kind == 3:
            cigar = f"2H{L}M3P"
        elif kind == 4:
            cigar = f"20=5X{L - 25}="
        else:
            cigar = f"{L}M"
        if rng.integers(0, 2):
            s = list(seq)
            for _ in range(int(rng.integers(1, 4))):
                j = int(rng.integers(0, len(s)))
                s[j] = "T" if s[j] != "T" else "C"
            seq = "".join(s)
        tags = []
        if rng.integers(0, 4) == 0:
            tags.append("XN:B:C,1,2")
        if rng.integers(0, 3) == 0:
            tags.append(f"AS:i:{-int(rng.integers(0, 20))}")
        lines.append(
            f"q{i}\t0\t{nm}\t{pos + 1}\t60\t{cigar}\t*\t0\t0\t{seq}\t"
            + "I" * len(seq) + (("\t" + "\t".join(tags)) if tags else "")
        )
        if i % 40 == 0:
            lines.append(f"u{i}\t4\t*\t0\t0\t*\t*\t0\t0\tACGT\tIIII")
    return ("\n".join(lines) + "\n").encode(), ("\n".join(fasta) + "\n").encode()


def _als_sam(seed: int) -> bytes:
    """Position-sorted records over three references with every flag the
    statistics filter on, clipping, indels and the MAPQ extremes."""
    rng = random.Random(seed)
    chroms = ["chrA", "chrB", "other1"]
    ref_len = 2000
    lines = ["@HD\tVN:1.6\tSO:coordinate"] + [f"@SQ\tSN:{c}\tLN:{ref_len}" for c in chroms]
    for i, p in enumerate(sorted(rng.randrange(0, ref_len - 60) for _ in range(800))):
        flag = 0
        r = rng.random()
        if r < 0.05:
            flag |= 0x4
        elif r < 0.10:
            flag |= 0x200
        elif r < 0.18:
            flag |= 0x100
        ops = []
        if rng.random() < 0.3:
            ops.append((rng.randint(1, 6), "S"))
        ops.append((rng.randint(5, 40), rng.choice("M=X")))
        if rng.random() < 0.3:
            ops.append((rng.randint(1, 5), rng.choice("ID")))
            ops.append((rng.randint(3, 20), "M"))
        qlen = sum(c for c, o in ops if o in "M=XIS")
        cig = "".join(f"{c}{o}" for c, o in ops)
        chrom = rng.choice(chroms)
        rnext = rng.choice(["*", "=", rng.choice(chroms)])
        mapq = rng.choice([0, 1, 20, 42, 60, 254, 255])
        lines.append(
            f"r{i}\t{flag}\t{chrom}\t{p + 1}\t{mapq}\t{cig}\t{rnext}"
            f"\t{rng.randint(1, ref_len)}\t0\t{'A' * qlen}\t{'I' * qlen}"
        )
    return ("\n".join(lines) + "\n").encode()


def _fp_contract_sam() -> bytes:
    """The MAPQ stream whose P-square marker adjustment flips under FMA
    contraction (the C build keeps -ffp-contract=off)."""
    vals = [3, 3, 42, 254, 0, 254, 42, 0, 3, 42, 42, 42, 254, 3,
            254, 254, 42, 3, 254, 254, 42, 3, 0, 3, 3, 254, 254, 3]
    lines = ["@HD\tVN:1.6\tSO:coordinate", "@SQ\tSN:c\tLN:5000"]
    for i, v in enumerate(vals):
        lines.append(f"r{i}\t0\tc\t{10 + i}\t{v}\t10M\t*\t0\t0\t{'A' * 10}\t{'I' * 10}")
    return ("\n".join(lines) + "\n").encode()


def _split_sam() -> bytes:
    rng = random.Random(11)
    refs = ["chrA", "chrB", "scaf1", "scaf2"]
    lines = ["@HD\tVN:1.6"] + [f"@SQ\tSN:{r}\tLN:5000" for r in refs]
    for i in range(500):
        r = rng.choice(refs + ["*"])
        if r == "*":
            lines.append(f"u{i}\t4\t*\t0\t0\t*\t*\t0\t0\t{'A' * 10}\t{'I' * 10}")
            continue
        p = rng.randrange(1, 4800)
        tags = "" if rng.random() < 0.5 else "\tNM:i:2\tAS:i:-5"
        rnext = rng.choice(["*", "=", rng.choice(refs)])
        lines.append(
            f"r{i}\t0\t{r}\t{p}\t{rng.randrange(0, 61)}\t20M\t{rnext}\t"
            f"{0 if rnext == '*' else rng.randrange(1, 4800)}\t0\t"
            f"{'ACGT' * 5}\t{'I' * 20}{tags}"
        )
    return ("\n".join(lines) + "\n").encode()


_VCF_HEAD = (
    "##fileformat=VCFv4.2\n"
    '##FORMAT=<ID=GT,Number=1,Type=String,Description="g">\n'
    "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1\n"
)


class Inputs:
    """Every input file of the cases, written once under ``root``."""

    def __init__(self, root: pathlib.Path):
        self.root = root

        def put(name: str, data) -> str:
            path = root / name
            if isinstance(data, str):
                data = data.encode()
            path.write_bytes(data)
            return str(path)

        # index_msa: the bundled founder MSA as TSV + bzip2 rows and as A2M
        import bz2

        rows, a2m = [], []
        for line in (WORKFLOW / "index-input/input.tsv").read_text().splitlines():
            chr_id, seq_id, rel = line.split("\t")
            rows.append(f"{chr_id}\t{seq_id}\t{WORKFLOW / rel}")
            a2m.append(f">{chr_id}/{seq_id}\n" + bz2.open(WORKFLOW / rel, "rb").read().decode())
        self.tsv = put("input.tsv", "\n".join(rows) + "\n")
        self.a2m = put("input.a2m", "\n".join(a2m) + "\n")
        self.row_a = put("a.txt", "AC-GT\n")
        self.row_b = put("b.txt", "TT-AA-\n")
        self.tsv_a = put("in1.tsv", f"chrA\tREF\t{self.row_a}\nchrA\ts1\t{self.row_a}\n")
        self.tsv_b = put("in2.tsv", f"chrB\tREF\t{self.row_b}\n")
        index = ref_msa.MsaIndex()
        for chr_id, seqs in (
            ("chrA", {"s1": "GAT-ACA--TT", "s2": "GATTACAGG-T"}),
            ("chrB", {"s1": "--ACGTAC-GT", "s2": "A-CGTTAC-GT", "s3": "TTAC-TACGGT"}),
        ):
            chrom = ref_msa.ChrEntry(chr_id)
            for sid, row in seqs.items():
                chrom.sequence_entries.append(
                    ref_msa.SequenceEntry(sid, ref_bitvec.GapBitVector.from_gap_string(row))
                )
            index.chr_entries.append(chrom)
        index.sort()
        self.toy_index = str(root / "toy.npz")
        index.save(self.toy_index)
        self.bed = put("in.bed", "chrA\t0\t3\textra\nother\t1\t2\nchrA\t2\t7\nchrA\t8\t9\n")

        self.subset = put("subset.sam", _subset_sam())
        self.subset_bam = put("subset.bam", sam_to_bam(_subset_sam()))
        self.read_ids = put("read_ids.txt", "".join(f"r{g}\n" for g in range(0, 300, 3)))

        rw_sam, rw_fa = _rewrite_inputs()
        self.rewrite = put("rewrite.sam", rw_sam)
        self.rewrite_bam = put("rewrite.bam", sam_to_bam(rw_sam))
        self.rewrite_fa = put("refs.fa", rw_fa)
        head = "@HD\tVN:1.6\n@SQ\tSN:c\tLN:1000\n"
        self.overrun_fa = put("r.fa", b">c\n" + b"A" * 1000 + b"\n")
        self.overrun_seq = put(
            "over_seq.sam", head + "a\t0\tc\t5\t40\t100M\t*\t0\t0\t" + "A" * 30 + "\t" + "I" * 30 + "\n"
        )
        self.overrun_ref = put(
            "over_ref.sam", head + "b\t0\tc\t995\t40\t30M\t*\t0\t0\t" + "A" * 30 + "\t" + "I" * 30 + "\n"
        )

        self.als = [put(f"als{seed}.sam", _als_sam(seed)) for seed in range(2)]
        self.als_bam = put("als0.bam", sam_to_bam(_als_sam(0)))
        self.fp = put("fp.sam", _fp_contract_sam())

        self.split = put("split.sam", _split_sam())
        self.split_bam = put("split.bam", sam_to_bam(_split_sam()))
        self.names_exact = put("names_exact.txt", "chrA\nchrB\nscaf1\nscaf2\n")
        self.names_prefix = put("names_prefix.txt", "chr\nscaf\n")
        self.names_some = put("names_some.txt", "chrA\nscaf2\n")
        self.names_rewrite = put(
            "names_rewrite.txt", "chrA\tnewA\nchrB\tnewB\nscaf1\tnews1\nscaf2\tnews2\n"
        )
        self.names_rewrite_short = put("names_rewrite_short.txt", "chrA\tnewA\n")
        self.names_clash = put("names_clash.txt", "chr\nchrA\n")

        self.csr = []
        for seed in range(2):
            sam_text, vcf_text = _random_workload(seed)
            self.csr.append((put(f"csr{seed}.sam", sam_text), put(f"csr{seed}.vcf", vcf_text)))
        self.csr_bam = put("csr0.bam", sam_to_bam(_random_workload(0)[0].encode()))
        self.csr_vcf_gz = put("csr0.vcf.gz", gzip.compress(_random_workload(0)[1].encode()))
        self.regions = put("regions.bed", "chr1\t50\t250\nchr1\t400\t520\n")
        self.one_read = put(
            "one.sam",
            "@HD\tVN:1.6\n@SQ\tSN:c\tLN:50\na\t0\tc\t1\t60\t20M\t*\t0\t0\t" + "A" * 20 + "\t" + "I" * 20 + "\n",
        )
        self.multi_alt = put("multalt.vcf", _VCF_HEAD + "c\t5\tv0\tA\tG,T\t.\tPASS\t.\tGT\t0|1\n")
        self.two_chr = put(
            "two.sam",
            "@HD\tVN:1.6\n@SQ\tSN:chrA\tLN:100\n@SQ\tSN:chrB\tLN:100\n" + "".join(
                f"r{i}\t0\tchrA\t{10 + i}\t60\t20M\t*\t0\t0\t{'A' * 20}\t{'I' * 20}\n" for i in range(5)
            ),
        )
        self.vcf_good = put("good.vcf", _VCF_HEAD + (
            "chrA\t15\tv0\tA\tG\t.\tPASS\t.\tGT\t0|1\nchrA\t20\tv1\tA\tG\t.\tPASS\t.\tGT\t0|1\n"
            "chrB\t5\tv2\tA\tG\t.\tPASS\t.\tGT\t0|1\n"
        ))
        self.vcf_bad = put("bad.vcf", _VCF_HEAD + (
            "chrA\t15\tv0\tA\tG\t.\tPASS\t.\tGT\t0|1\nchrB\t5\tv2\tA\tG\t.\tPASS\t.\tGT\t0|1\n"
            "chrA\t20\tv1\tA\tG\t.\tPASS\t.\tGT\t0|1\n"
        ))
        self.clamp = put(
            "clamp.sam",
            "@HD\tVN:1.6\n@SQ\tSN:c\tLN:200\n"
            "bad1\t0\tc\t1\t60\t100M\t*\t0\t0\t" + "A" * 30 + "\t" + "I" * 30 + "\n"
            "bad2\t0\tc\t2\t60\t50M20I50M\t*\t0\t0\t" + "C" * 30 + "\t" + "I" * 30 + "\n"
            "ok\t0\tc\t3\t60\t120M\t*\t0\t0\t" + "G" * 120 + "\t" + "I" * 120 + "\n",
        )
        self.clamp_vcf = put("clamp.vcf", _VCF_HEAD + (
            "c\t40\tv0\tA\tG\t.\tPASS\t.\tGT\t0|1\nc\t60\tv1\tAAA\tA\t.\tPASS\t.\tGT\t0|1\n"
        ))


SUBSET_OFF = [{"PANVC3_SUBSET_FAST": "0"}]
REWRITE_OFF = [{"PANVC3_REWRITE_TOOL_FAST": "0"}]
SPLIT_OFF = [{"PANVC3_SPLIT_FAST": "0"}]
ALS_OFF = [{"PANVC3_ALS_FAST": "0"}]
CSR_OFF = [{"PANVC3_CSR_FAST": "0"}, {"PANVC3_CSR_VCF_FAST": "0"}]


def _cases(x: Inputs) -> dict:
    c: dict = {}
    # -- index_msa
    build = ["index_msa", "--build-index", "--msa-index-output={out}/i.npz"]
    c["index-tsv"] = dict(steps=[build + [f"--sequence-inputs={x.tsv}", "--output-fasta", "--pipe-input=bzip2 -d -c"]],
                          codes=[0], files=["i.npz"])
    c["index-tsv-width"] = dict(steps=[build + ["-i", x.tsv, "-f", "-w", "60", "-p", "bzip2 -d -c"]], codes=[0])
    c["index-a2m"] = dict(steps=[build + ["-a", x.a2m, "-f"]], codes=[0], files=["i.npz"])
    c["index-a2m-quiet"] = dict(steps=[build + ["-a", x.a2m]], codes=[0])
    c["index-incremental"] = dict(steps=[
        ["index_msa", "-B", "-i", x.tsv_a, "-m", "{out}/i1.npz"],
        ["index_msa", "-B", "-i", x.tsv_b, "-d", "{out}/i1.npz", "-m", "{out}/i2.npz", "-f"],
        ["index_msa", "-L", "-d", "{out}/i2.npz"],
    ], codes=[0, 0, 0])
    c["index-list"] = dict(steps=[["index_msa", "--list-contents", f"--msa-index-input={x.toy_index}"]], codes=[0])
    c["index-query"] = dict(
        steps=[["index_msa", "--query", "-d", x.toy_index, "--chr-id=chrA"]],
        stdin=b"s1\n0\n3\ns\nnope\ns2\n3\nbogus\n999999999\nd\ns1\n5\n", codes=[0],
    )
    c["index-query-no-chr"] = dict(steps=[["index_msa", "-Q", "-d", x.toy_index, "--chr-id=nope"]], stdin=b"s1\n")
    c["index-pipe-fails"] = dict(steps=[build + ["-i", x.tsv, "--pipe-input=false"]], codes=[1], stderr_has="ERROR:")
    c["index-no-output"] = dict(steps=[["index_msa", "-B", "-i", x.tsv]], codes=[2])
    c["index-version"] = dict(steps=[["index_msa", "--version"]], codes=[0])
    # -- subset_alignments
    sub = ["subset_alignments", "-o", "{out}/o.sam"]
    c["subset-best"] = dict(steps=[sub + ["-a", x.subset, "-q"]], off=SUBSET_OFF, codes=[0])
    c["subset-chr-best"] = dict(steps=[sub + ["-a", x.subset, "-c", "chr1", "--best-mapq"]], off=SUBSET_OFF, codes=[0])
    c["subset-chr"] = dict(steps=[sub + ["-a", x.subset, "--chr", "chr2"]], off=SUBSET_OFF, codes=[0])
    c["subset-ids-best"] = dict(steps=[sub + ["-a", x.subset, "-r", "-q"]], stdin=x.read_ids, off=SUBSET_OFF, codes=[0])
    c["subset-chr-ids"] = dict(steps=[sub + ["-a", x.subset, "-c", "chr1", "--read-id"]], stdin=x.read_ids,
                               off=SUBSET_OFF, codes=[0])
    c["subset-bam-bam"] = dict(steps=[["subset_alignments", "-a", x.subset_bam, "-B", "-b", "-o", "{out}/o.bam", "-q",
                                       "--print-invocation"]], off=SUBSET_OFF, codes=[0])
    c["subset-sam-bam"] = dict(steps=[["subset_alignments", "-a", x.subset, "-b", "-o", "{out}/o.bam", "-c", "chr1"]],
                               off=SUBSET_OFF, codes=[0])
    c["subset-stdin-stdout"] = dict(steps=[["subset_alignments", "-q"]], stdin=x.subset, off=SUBSET_OFF, codes=[0])
    c["subset-missing-file"] = dict(steps=[sub + ["-a", str(x.root / "absent.sam")]], off=SUBSET_OFF, codes=[1],
                                    stderr_has="ERROR:")
    # -- rewrite_cigar
    rw = ["rewrite_cigar", "--status-output-interval", "0"]
    c["rewrite-seq"] = dict(steps=[rw + ["-a", x.rewrite, "-S", "-r", x.rewrite_fa, "-o", "{out}/o.sam"]],
                            off=REWRITE_OFF, codes=[0])
    c["rewrite-aln"] = dict(steps=[rw + ["-a", x.rewrite, "-M", "-o", "{out}/o.sam"]], off=REWRITE_OFF, codes=[0])
    c["rewrite-seq-tag"] = dict(steps=[rw + ["-a", x.rewrite, "--output-sequence-match-ops", "-r", x.rewrite_fa,
                                             "--ref-n-positions-tag", "ZN", "-o", "{out}/o.sam"]],
                                off=REWRITE_OFF, codes=[0])
    c["rewrite-seq-bam-bam"] = dict(steps=[rw + ["-a", x.rewrite_bam, "-B", "-b", "-S", "-r", x.rewrite_fa,
                                                 "-o", "{out}/o.bam"]], off=REWRITE_OFF, codes=[0])
    c["rewrite-aln-sam-bam"] = dict(steps=[rw + ["-a", x.rewrite, "-b", "--alignment-match", "-o", "{out}/o.bam"]],
                                    off=REWRITE_OFF, codes=[0])
    c["rewrite-overruns-seq"] = dict(steps=[rw + ["-a", x.overrun_seq, "-S", "-r", x.overrun_fa, "-o", "{out}/o.sam"]],
                                     off=REWRITE_OFF, codes=[1], stderr_has="ERROR: CIGAR overruns SEQ")
    c["rewrite-overruns-ref"] = dict(steps=[rw + ["-a", x.overrun_ref, "-S", "-r", x.overrun_fa, "-o", "{out}/o.sam"]],
                                     off=REWRITE_OFF, codes=[1], stderr_has="ERROR: CIGAR overruns the reference")
    c["rewrite-seq-no-reference"] = dict(steps=[rw + ["-a", x.rewrite, "-S", "-o", "{out}/o.sam"]], off=REWRITE_OFF,
                                         codes=[1], stderr_has="ERROR:")
    c["rewrite-no-mode"] = dict(steps=[rw + ["-a", x.rewrite]], codes=[2])
    # -- split_alignments_by_reference
    sp = ["split_alignments_by_reference", "-S", "-b", "{out}/"]
    c["split-exact"] = dict(steps=[sp + ["-a", x.split, "-r", x.names_exact]], off=SPLIT_OFF, codes=[0],
                            files=["chrA.bam", "scaf2.bam"])
    c["split-prefixes"] = dict(steps=[sp + ["-a", x.split, "-r", x.names_prefix, "-p"]], off=SPLIT_OFF, codes=[0],
                               files=["chr.bam", "scaf.bam"])
    c["split-rewrite"] = dict(steps=[sp + ["-a", x.split, "-r", x.names_rewrite, "-w"]], off=SPLIT_OFF, codes=[0])
    c["split-unmatched"] = dict(steps=[sp + ["-a", x.split, "-r", x.names_some, "--report-unmatched"]],
                                off=SPLIT_OFF, codes=[0])
    c["split-bam-in"] = dict(steps=[sp + ["-a", x.split_bam, "-B", "-r", x.names_rewrite, "--rewrite-reference-names"]],
                             off=SPLIT_OFF, codes=[0])
    c["split-rewrite-missing-name"] = dict(steps=[sp + ["-a", x.split, "-r", x.names_rewrite_short, "-w"]],
                                           off=SPLIT_OFF, codes=[1], stderr_has="ERROR:")
    c["split-prefix-clash"] = dict(steps=[sp + ["-a", x.split, "-r", x.names_clash, "-p"]], off=SPLIT_OFF,
                                   codes=[1], stderr_has="ERROR:")
    c["split-no-names"] = dict(steps=[sp + ["-a", x.split]], codes=[2])
    c["split-list"] = dict(steps=[["split_alignments_by_reference", "-R", "-a", x.split]], codes=[0])
    c["split-list-used"] = dict(steps=[["split_alignments_by_reference", "--read-reference-names", "--only-used",
                                        "-a", x.split_bam]], codes=[0])
    # -- alignment_statistics
    modes = {
        "cov": ["-C"], "cov-clip": ["--coverage", "-l"], "count": ["-O"], "hist": ["-M"],
        "box": ["-B", "--bin-width", "257"], "box-wide": ["--mapq-box-plot"],
    }
    filters = {
        "all": [], "rname": ["-r", "chrA"], "prefix-same": ["-r", "chr", "-p", "-s"],
        "two-same-primary": ["-r", "chrA", "-r", "chrB", "-s", "-m"], "nomatch": ["--rname", "nomatch"],
    }
    for mname, margs in modes.items():
        for fname, fargs in filters.items():
            seed = (len(mname) + len(fname)) % 2
            c[f"als-{mname}-{fname}"] = dict(
                steps=[["alignment_statistics", "-a", x.als[seed], *margs, *fargs]], off=ALS_OFF, codes=[0]
            )
    c["als-cov-bam"] = dict(steps=[["alignment_statistics", "-a", x.als_bam, "-b", "-C"]], off=ALS_OFF, codes=[0])
    c["als-box-bam-stdin"] = dict(steps=[["alignment_statistics", "-B", "--bin-width", "300"]],
                                  stdin=x.als_bam, off=ALS_OFF, codes=[0])
    c["als-box-fp-contract"] = dict(steps=[["alignment_statistics", "-a", x.fp, "-B"]], off=ALS_OFF, codes=[0])
    c["als-no-mode"] = dict(steps=[["alignment_statistics", "-a", x.fp]], codes=[2])
    # -- count_supporting_reads
    csr_cfgs = {
        "default": [], "zygosity": ["-z", "1"], "clipping": ["-l"], "anchor-left": ["--anchor-left"],
        "contig-same-ref": ["-o", "chr1", "-m", "-s"], "contig-prefix": ["--contig", "chr", "--contig-prefix"],
        "regions": ["-r", x.regions], "chr": ["-c", "chr1"],
        "field-ids": ["--end-field-id", "STOP", "--co-field-id", "XO"],
    }
    for name, args in csr_cfgs.items():
        sam, vcf = x.csr[len(name) % 2]
        c[f"csr-{name}"] = dict(steps=[["count_supporting_reads", "-i", vcf, "-a", sam, *args]], off=CSR_OFF, codes=[0])
    c["csr-bam-gz-vcf"] = dict(steps=[["count_supporting_reads", "--vcf", x.csr_vcf_gz, "--alignments", x.csr_bam]],
                               off=CSR_OFF, codes=[0])
    c["csr-stdin"] = dict(steps=[["count_supporting_reads", "-i", x.csr[0][1]]],
                          stdin=x.csr[0][0], off=CSR_OFF, codes=[0])
    c["csr-multi-alt"] = dict(steps=[["count_supporting_reads", "-i", x.multi_alt, "-a", x.one_read]], off=CSR_OFF,
                              codes=[1], stderr_has="ERROR:")
    c["csr-same-ref-needs-contig"] = dict(steps=[["count_supporting_reads", "-i", x.multi_alt, "-a", x.one_read, "-s"]],
                                          off=CSR_OFF, codes=[1], stderr_has="ERROR: --same-ref")
    c["csr-two-chr-good"] = dict(steps=[["count_supporting_reads", "-i", x.vcf_good, "-a", x.two_chr, "-c", "chrA"]],
                                 off=CSR_OFF, codes=[0])
    c["csr-two-chr-bad"] = dict(steps=[["count_supporting_reads", "-i", x.vcf_bad, "-a", x.two_chr, "-c", "chrA"]],
                                off=CSR_OFF, codes=[1], stderr_has="ERROR:")
    c["csr-cigar-longer-than-seq"] = dict(steps=[["count_supporting_reads", "-i", x.clamp_vcf, "-a", x.clamp]],
                                          off=CSR_OFF, codes=[0])
    # -- convert_bed_positions
    cb = ["convert_bed_positions", "-m", x.toy_index]
    c["bed-file"] = dict(steps=[cb + ["-b", x.bed, "-c", "chrA", "-s", "s1", "-d", "s2"]], codes=[0])
    c["bed-reverse"] = dict(steps=[cb + ["--bed", x.bed, "--chr", "chrA", "--src-seq", "s2", "--dst-seq", "s1"]], codes=[0])
    c["bed-stdin-dst-chr"] = dict(steps=[cb + ["-c", "chrA", "-s", "s1", "-d", "s2", "--dst-chr", "chrB"]],
                                  stdin=b"chrA\t1\t4\nchrA\t5\t6\n", codes=[0])
    c["bed-unknown-seq"] = dict(steps=[cb + ["-b", x.bed, "-c", "chrA", "-s", "s1", "-d", "s9"]], codes=[1],
                                stderr_has="ERROR:")
    c["bed-unknown-chr"] = dict(steps=[cb + ["-b", x.bed, "-c", "chrZ", "-s", "s1", "-d", "s2"]], codes=[1],
                                stderr_has="ERROR:")
    # -- the dispatcher
    c["main-help"] = dict(steps=[["--help"]], codes=[0])
    c["main-unknown-tool"] = dict(steps=[["no_such_tool"]], codes=[2])
    return c


class _NoInputs:
    """Stands in for ``Inputs`` where only the cases' names are wanted (at
    collection time: no file is written)."""

    als = ["", ""]
    csr = [("", ""), ("", "")]
    root = pathlib.Path(".")

    def __getattr__(self, name):
        return ""


CASE_NAMES = sorted(_cases(_NoInputs()))


@pytest.fixture(scope="module")
def tool_results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tools")
    inputs_dir = tmp / "inputs"
    inputs_dir.mkdir()
    cases = _cases(Inputs(inputs_dir))
    return cases, run_jobs(tmp, cases)


@pytest.mark.parametrize("name", CASE_NAMES)
def test_tool_matches_reference(tool_results, name):
    cases, results = tool_results
    check_case(results, cases, name)


def test_help_lists_all_nine_tools(capsys):
    from panvc3_tpu.cli.main import TOOLS as ref_tools
    from panvc3_tpu_torch.cli.main import TOOLS as port_tools, main as port_main

    assert list(port_tools) == list(ref_tools) and len(port_tools) == 9
    assert port_main(["--help"]) == 0
    text = capsys.readouterr().out
    for tool in ref_tools:
        assert f"  {tool}\n" in text
    assert "python -m panvc3_tpu_torch <tool>" in text


def _options(module: str, tool: str) -> set[str]:
    import re

    proc = subprocess.run(
        [sys.executable, "-m", module, tool, "--help"],
        env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True, timeout=120, cwd=str(REPO),
    )
    assert proc.returncode == 0, proc.stderr.decode()
    return set(re.findall(r"(?<![\w-])(--?[A-Za-z][A-Za-z0-9-]*)", proc.stdout.decode()))


@pytest.mark.parametrize("tool", [
    "index_msa", "recalculate_mapq", "subset_alignments", "count_supporting_reads",
    "rewrite_cigar", "split_alignments_by_reference", "alignment_statistics", "convert_bed_positions",
])
def test_cli_options_equal_reference(tool):
    """Option for option, short names included; the host tools take no
    ``--device``."""
    want = _options("panvc3_tpu", tool)
    got = _options("panvc3_tpu_torch", tool)
    assert got == want and "--device" not in got and len(want) > 4


# -- the helper copies ----------------------------------------------------------

_CIGARS = [
    "10M", "3=2X5=", "2S3=1I2X1H", "5M2I3D4M", "5M3D2I4M", "5M1I1D1I4M", "5M2I1P3D4M",
    "5M3D1P2I4M", "*", "4M2D", "2I4M", "1M1I1M1D1M",
]


@pytest.mark.parametrize("padding", [False, True])
def test_cigar_eq_matches(padding):
    for a in _CIGARS:
        for b in _CIGARS:
            la, lb = ref_cigar.parse_cigar(a), ref_cigar.parse_cigar(b)
            assert port_cigar.cigar_eq(la, lb, padding) == ref_cigar.cigar_eq(la, lb, padding), (a, b)
    assert port_cigar.cigar_eq(ref_cigar.parse_cigar("5M2I3D4M"), ref_cigar.parse_cigar("5M3D2I4M"))


@pytest.mark.parametrize("text", _CIGARS)
def test_cigar_lengths_and_arrays_match(text):
    cig = ref_cigar.parse_cigar(text)
    assert port_cigar.parse_cigar(text) == cig
    assert port_cigar.cigar_ref_length(cig) == ref_cigar.cigar_ref_length(cig)
    assert port_cigar.cigar_query_length(cig) == ref_cigar.cigar_query_length(cig)
    assert port_cigar.CONSUMES_REF == ref_cigar.CONSUMES_REF
    for pad in (None, 16):
        got, want = port_cigar.cigar_to_arrays(cig, pad), ref_cigar.cigar_to_arrays(cig, pad)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        assert port_cigar.arrays_to_cigar(*got) == ref_cigar.arrays_to_cigar(*want)
    if cig:
        with pytest.raises(ValueError):
            port_cigar.cigar_to_arrays(cig, len(cig) - 1)


@pytest.mark.parametrize("n,rate", [(1, 0.5), (33, 0.2), (5000, 0.05)])
def test_bitvec_from_bits_bit_at_nbytes_match(n, rate):
    rng = np.random.default_rng(n)
    bits = (rng.random(n) < rate).astype(np.uint8)
    want = ref_bitvec.GapBitVector.from_bits(bits)
    got = port_bitvec.GapBitVector.from_bits(bits)
    for key, val in want.state().items():
        assert np.array_equal(got.state()[key], val), key
    pos = rng.integers(0, n, 200)
    assert np.array_equal(got.bit_at(pos), want.bit_at(pos))
    assert np.array_equal(got.bit_at(pos), bits[pos])
    assert got.nbytes == want.nbytes > 0


def test_msa_index_helpers_match(tmp_path):
    pairs = {}
    for mod in (ref_msa, port_msa):
        src, dst = mod.make_sequence_entry_pair("GAT-ACA--T", "GATTACAGG-")
        pairs[mod] = (src, dst)
        assert (src.aligned_length, src.unaligned_length) == (10, 7)
        with pytest.raises(ValueError):
            mod.make_sequence_entry_pair("A-", "A")
    for pos in range(7):
        assert pairs[port_msa][0].project_position(pos, pairs[port_msa][1]) == \
            pairs[ref_msa][0].project_position(pos, pairs[ref_msa][1])
    indexes = {}
    for mod, bv in ((ref_msa, ref_bitvec), (port_msa, port_bitvec)):
        index = mod.MsaIndex()
        for chr_id in ("chrB", "chrA", "chrB"):
            chrom = index.get_or_add_chr(chr_id)
            if not chrom.sequence_entries:
                chrom.sequence_entries.append(mod.SequenceEntry("s", bv.GapBitVector.from_gap_string("A-C")))
        indexes[mod] = index
        assert [c.chr_id for c in index.chr_entries] == ["chrA", "chrB"]
        assert index.find("chrA", "s").aligned_length == 3
        assert index.find("chrA", "t") is None and index.find("chrZ", "s") is None


def test_seqbuf_mapping_protocol_matches():
    for mod in (ref_seqbuf, port_seqbuf):
        loads = []
        store = mod.SequenceBufferStore(lambda k: loads.append(k) or bytes([k]), max_size=2)
        assert len(store) == 0 and 1 not in store
        for key in (1, 2, 1, 3):
            assert store[key] == bytes([key])
        assert loads == [1, 2, 3]
        assert list(store) == [1, 3] and len(store) == 2 and 2 not in store and 3 in store


def test_dna11_complement_matches():
    assert port_alphabet.DNA11_CHARS == ref_alphabet.DNA11_CHARS
    for ch in ref_alphabet.DNA11_CHARS:
        assert port_alphabet.dna11_complement(ch) == ref_alphabet.dna11_complement(ch)


@pytest.mark.parametrize("width", [0, 1, 7, 60])
def test_write_fasta_matches(width):
    outs = []
    for mod in (ref_fasta, port_fasta):
        fh = io.BytesIO()
        mod.write_fasta(fh, "chr/seq", b"ACGTACGTACGTAC", width)
        mod.write_fasta(fh, "empty", "", width)
        outs.append(fh.getvalue())
    assert outs[0] == outs[1] and outs[0].startswith(b">chr/seq\n")


def test_bed_and_region_set_match(tmp_path):
    path = tmp_path / "r.bed"
    path.write_text("#c\nchr1\t5\t9\tname\nchr2\t0\t4\n\nchr1\t20\t30\nchr1\t7\t12\n")
    want = list(ref_bed.read_bed(str(path)))
    got = list(port_bed.read_bed(str(path)))
    assert [(r.chrom, r.start, r.end) for r in got] == [(r.chrom, r.start, r.end) for r in want]
    rs = {}
    for mod in (ref_bed, port_bed):
        rs[mod] = mod.RegionSet()
        rs[mod].load_bed(str(path))
    for chrom in ("chr1", "chr2", "chr3"):
        for pos in range(0, 35):
            assert rs[port_bed].contains(chrom, pos) == rs[ref_bed].contains(chrom, pos), (chrom, pos)


def test_vcf_reader_matches(tmp_path):
    _, vcf_text = _random_workload(3)
    paths = [tmp_path / "v.vcf", tmp_path / "v.vcf.gz"]
    paths[0].write_text(vcf_text)
    paths[1].write_bytes(gzip.compress(vcf_text.encode()))
    for path in paths:
        want = list(ref_vcf.VcfReader(str(path)))
        got = list(port_vcf.VcfReader(str(path)))
        assert len(got) == len(want) == 120

        def fields(v):
            return {k: getattr(v, k) for k in v.__dataclass_fields__}

        assert [fields(v) for v in got] == [fields(v) for v in want]


def test_status_reporter_final_matches(monkeypatch):
    lines = []
    for mod in (ref_utils, port_utils):
        monkeypatch.setattr(mod, "log_time", lines.append)
        reporter = mod.StatusReporter(0, "records")
        reporter.start -= 2.0
        reporter.final(1000)
        mod.StatusReporter(0, "reads").final(0)
    assert len(lines) == 4 and lines[0].startswith("Done; processed 1000 records in 2 s (")
    assert lines[0].split("(")[0] == lines[2].split("(")[0]
    assert lines[1] == lines[3] == "Done; processed 0 reads in 0 s."


# -- chip_smoke.py's tool phase, rehearsed on the CPU ----------------------------

_REHEARSAL = r"""
import pathlib, sys

def run(work):
    import chip_smoke
    from panvc3_tpu_torch import synth

    chip_smoke.N_VARIANTS, chip_smoke.N_BED = 600, 1500
    chip_smoke.N_SAMPLE, chip_smoke.N_BAM_OBJECT_READS = 512, 256
    n_reads = 2048
    rows = synth.make_msa(200_000, seed=5)
    index_path, fasta_path, founders = synth.write_inputs(work, "chr21", rows)
    rows_tsv = chip_smoke.write_msa_rows(work, "chr21", rows)
    sam_path = work / "reads.sam"
    sam_path.write_bytes(synth.reads_sam("chr21", founders, n_reads, 6))
    q_sam_path = work / "reads_q.sam"
    q_sam_path.write_bytes(synth.reads_sam("chr21", founders, n_reads, 6, qualities=True))
    tool = chip_smoke.Tool("cpu rehearsal", work, index_path, fasta_path, device="cpu")
    device = {"PANVC3_HOST_DP": "0"}
    dev_sam, *_ = tool.run("int-device", device, sam_path, expect=n_reads)
    q_dev, *_ = tool.run("q-device", device, q_sam_path, quality=True, expect=n_reads)
    used = {"realign_fused_int": 0, "realign_fused_qual": 0}
    chip_smoke.phase_tools(
        tool, 0, rows_tsv, founders, sam_path, q_sam_path, dev_sam, q_dev, used, n_pairs=300
    )
    assert used == {"realign_fused_int": 0, "realign_fused_qual": 0}  # no card: no launch
    assert (work / "mapq-jobs4.bam").exists() and (work / "split-bam/chr21.bam").exists()
    assert not any(m == "jax" or m.startswith(("jax.", "panvc3_tpu.")) for m in sys.modules)
    print("REHEARSAL_OK")

if __name__ == "__main__":
    run(pathlib.Path(sys.argv[1]))
"""


def test_chip_smoke_tool_phase_on_cpu(tmp_path):
    """Phase 8 of ``chip_smoke.py`` (the nine tools through the port's CLI:
    the index build, BAM in and out, recalculate_mapq with 1 and 4 jobs,
    each auxiliary tool with its switch on and ``=0``) at a small size with
    ``--device cpu``, in a process of its own as on the card; every
    comparison it makes there is made here."""
    script = tmp_path / "rehearse_phase8.py"
    script.write_text(_REHEARSAL)
    work = tmp_path / "work"
    work.mkdir()
    env = {k: v for k, v in os.environ.items() if not k.startswith("PANVC3_")}
    proc = subprocess.run(
        [sys.executable, str(script), str(work)],
        env=dict(env, PYTHONPATH=str(REPO)), capture_output=True, timeout=600, cwd=str(tmp_path),
    )
    assert proc.returncode == 0, (proc.stdout.decode()[-3000:], proc.stderr.decode()[-3000:])
    assert b"REHEARSAL_OK" in proc.stdout
