"""The port as an installed program.

The distribution's wheel (built once per module by ``chip_smoke.build_wheel``
from a copy of the checkout's sources) carries the port's CUDA sources, a
copy of the shared C sources, its Snakemake workflows and its nine
``panvc3_torch_*`` commands.  Unpacked into a target and run from outside
the checkout, with ``PYTHONPATH`` the target alone and a temporary
``XDG_CACHE_HOME``, the port compiles its C extension into that cache,
writes nothing into the target, and projects what the checkout projects.
``tests/test_packaging.py`` holds the JAX package's half of the same wheel.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys
import zipfile

import pytest

from chip_smoke import (
    PORT_COMMANDS,
    build_wheel,
    console_script,
    fastlane_diag,
    imported_modules,
    installed_build,
    installed_env,
    reference_modules,
    snapshot,
    strip_pg,
    unpack_wheel,
)
from panvc3_tpu_torch import native

from .test_fastpath import _rich_sam
from .test_torch_fastlane import GENOME
from .test_workflow_data import founder_seqs, msa_files  # noqa: F401 (fixtures)

REPO = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = "panvc3_tpu_torch"
# the cmd_* function behind each command, where its name is not the tool's
COMMAND_FUNCTION = {"panvc3_torch_split_alignments_by_reference": "cmd_split_alignments"}


@pytest.fixture(scope="module")
def wheel(tmp_path_factory):
    return build_wheel(tmp_path_factory.mktemp("wheel"))


@pytest.fixture(scope="module")
def installed(wheel, tmp_path_factory):
    """(target, console scripts, cache, a working directory outside the
    checkout) of the unpacked wheel."""
    root = tmp_path_factory.mktemp("installed")
    target = root / "site"
    scripts = unpack_wheel(wheel, target)
    run = root / "run"
    run.mkdir()
    return target, scripts, root / "cache", run


def test_wheel_carries_the_port_sources(wheel):
    with zipfile.ZipFile(wheel) as zf:
        names = set(zf.namelist())
        for cu in sorted((REPO / PACKAGE / "ops/csrc").glob("*.cu")):
            assert f"{PACKAGE}/ops/csrc/{cu.name}" in names, cu.name
        for name in native.SOURCES + native.HEADERS:
            staged = f"{PACKAGE}/{native.STAGED_DIR.name}/{name}"
            assert zf.read(staged) == (REPO / "native" / name).read_bytes(), name
    for path in ("README.md", "test-workflow/Snakefile", "test-workflow/example-config.yaml",
                 "test-workflow/environment.yaml", "test-workflow/run-snakemake.sh",
                 "bowtie2-workflow/Snakefile", "bowtie2-workflow/example-config.yaml",
                 "bowtie2-workflow/environment.yaml"):
        assert f"{PACKAGE}/workflows/{path}" in names, path
    # the port compiles at first use: no prebuilt library of its own
    assert not [n for n in names if n.startswith(f"{PACKAGE}/") and n.endswith(".so")]


@pytest.mark.parametrize("command", PORT_COMMANDS)
def test_wheel_declares_the_port_command(installed, command):
    _, scripts, _, _ = installed
    func = COMMAND_FUNCTION.get(command, "cmd_" + command.removeprefix("panvc3_torch_"))
    assert scripts[command] == f"{PACKAGE}.cli.main:{func}"
    # the panvc3_<tool> names stay the JAX package's
    assert scripts[command.replace("panvc3_torch_", "panvc3_")] == f"panvc3_tpu.cli.main:{func}"


def test_installed_port_builds_into_the_cache(installed):
    target, _, cache, run = installed
    before = snapshot(target)
    info = installed_build(installed_env(target, cache), run, kernels=False)
    assert pathlib.Path(info["package"]).parent == target / PACKAGE
    assert pathlib.Path(info["build_root"]) == cache / PACKAGE
    assert pathlib.Path(info["native_dir"]) == target / PACKAGE / native.STAGED_DIR.name
    assert len(list((cache / PACKAGE / "native").glob("*/_panvc3_native*.so"))) == 1
    assert snapshot(target) == before


def test_installed_command_projects_as_the_checkout(installed, msa_files, founder_seqs, tmp_path):  # noqa: F811
    """``panvc3_torch_project_alignments --device cpu`` through the wheel's
    entry point gives the checkout's SAM, on the device lane, imports
    nothing of JAX or ``panvc3_tpu`` and writes nothing under the target."""
    target, scripts, cache, run = installed
    index_path, _, _ = msa_files
    sam = tmp_path / "in.sam"
    sam.write_bytes(_rich_sam(founder_seqs, n_reads=240, seed=12))
    args = ["--device", "cpu", "-a", str(sam), "-m", str(index_path), "-r", GENOME,
            "-d", "REF", "-s", "/", "--device-batch-size", "64", "--status-output-interval", "0"]
    before = snapshot(target)
    outs = {}
    python, *entry = console_script(scripts, "panvc3_torch_project_alignments")
    for tag, argv, env, cwd in (
        ("installed", [python, "-X", "importtime", *entry], installed_env(target, cache), run),
        ("checkout", [sys.executable, "-m", PACKAGE, "project_alignments"],
         installed_env(REPO, cache), REPO),
    ):
        out = tmp_path / f"{tag}.sam"
        env.update(PANVC3_HOST_DP="0", PANVC3_FASTLANE_PROF="1")
        proc = subprocess.run(argv + args + ["-o", str(out)], env=env, cwd=cwd,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        diag = fastlane_diag(proc.stderr)
        assert diag["device"] == "cpu" and diag["dispatches"] > 0, diag
        outs[tag] = out.read_bytes()
        if tag == "installed":
            # the target holds panvc3_tpu too: the port must load none of it
            modules = imported_modules(proc.stderr)
            assert "panvc3_tpu_torch.pipeline.fastlane" in modules
            assert not reference_modules(modules)
    assert strip_pg(outs["installed"]) == strip_pg(outs["checkout"])
    assert outs["installed"].count(b"\n") > 240
    assert snapshot(target) == before


def test_installed_command_raises_without_a_card(installed, msa_files, tmp_path):  # noqa: F811
    """A bare run (no ``--device``) asks for the card; with none visible it
    fails before it writes anything."""
    target, scripts, cache, run = installed
    index_path, _, _ = msa_files
    sam = tmp_path / "in.sam"
    sam.write_text("@HD\tVN:1.6\n@SQ\tSN:test/1\tLN:100\n")
    out = tmp_path / "out.sam"
    env = dict(installed_env(target, cache), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        console_script(scripts, "panvc3_torch_project_alignments")
        + ["-a", str(sam), "-m", str(index_path), "-r", GENOME, "-d", "REF", "-s", "/",
           "-o", str(out)],
        env=env, cwd=run, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr, proc.stderr
    assert not out.exists()


def test_installed_workflow_module_asks_for_data(installed, tmp_path):
    """An install carries no workflow data: ``panvc3_tpu_torch.workflow``'s
    ``--data`` has no default there, and a run without it fails naming
    ``--data``."""
    target, _, cache, run = installed
    proc = subprocess.run(
        [sys.executable, "-m", f"{PACKAGE}.workflow", "--workdir", str(tmp_path / "wf"),
         "--device", "cpu"],
        env=installed_env(target, cache), cwd=run, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 2
    assert "--data is required" in proc.stderr, proc.stderr
    assert not (tmp_path / "wf").exists()


_REHEARSAL = r"""
import pathlib, sys

def run(work):
    import chip_smoke
    from panvc3_tpu_torch import synth

    n_reads = 2048
    rows = synth.make_msa(200_000, seed=5)
    index_path, fasta_path, founders = synth.write_inputs(work, "chr21", rows)
    sam_path = work / "reads.sam"
    sam_path.write_bytes(synth.reads_sam("chr21", founders, n_reads, 6))
    one_read = work / "one_read.sam"
    one_read.write_bytes(synth.reads_sam("chr21", founders, 1, 6))
    tool = chip_smoke.Tool("cpu rehearsal", work, index_path, fasta_path, device="cpu")
    dev_sam, *_ = tool.run("int-device", {"PANVC3_HOST_DP": "0"}, sam_path, expect=n_reads)
    used = {"realign_fused_int": 0}
    chip_smoke.phase_installed(tool, sam_path, one_read, dev_sam, used, n_reads=n_reads)
    assert used == {"realign_fused_int": 0}  # no card: no launch
    assert not any(m == "jax" or m.startswith(("jax.", "panvc3_tpu.")) for m in sys.modules)
    print("REHEARSAL_OK")

if __name__ == "__main__":
    run(pathlib.Path(sys.argv[1]))
"""


def test_chip_smoke_installed_phase_on_cpu(tmp_path):
    """Phase 11 of ``chip_smoke.py`` (the wheel built and unpacked, the
    installed command against the device lane's SAM, the port's test
    workflow through the installed commands, nothing written under the
    target or the checkout's ``build/``) at a small size with ``--device
    cpu``, in a process of its own as on the card."""
    script = tmp_path / "rehearse_phase11.py"
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
