"""The port's Snakemake workflows (``panvc3_tpu_torch/workflows/``).

Structure: the same checks as ``tests/test_workflows.py`` against the
reference's rule structure (``tests/data/ref_snakefile_structure.json``),
with the port's commands ``panvc3_torch_<tool>`` read as the reference's
``panvc3_<tool>`` and ``--device`` the one flag the port adds.

Runs: the test workflow's three panvc3 rules (build_msa_index,
project_alignments, recalculate_mapq), their commands formatted from the
Snakefile as Snakemake formats them and run by ``bash`` in order, with
shims on ``PATH`` for the commands (``python -m <package> <tool>``), on the
bundled reads (``chip_smoke.run_test_workflow``: the aligner's stand-in is
``synth.founder_alignments``, the samtools sorts are done in Python).  The
port's final SAM, with ``--device cpu``, must equal that of the port's
workflow module (``python -m panvc3_tpu_torch.workflow``) on the same
input and that of ``panvc3_tpu``'s Snakefile run the same way.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys

import pytest

from chip_smoke import (
    rule_entries,
    rule_io,
    run_test_workflow,
    snakefile_rules,
    strip_pg,
    write_shims,
)

from .test_workflows import (
    _EXTRA_FLAG_ALLOWLIST,
    _PIPELINE_RULES,
    derive_structure,
    parse_snakefile,
    ref_structure,
    shell_text,
)

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_WORKFLOWS = REPO / "panvc3_tpu_torch/workflows"
TOOLS = ("index_msa", "project_alignments", "recalculate_mapq")


def port_structure(path: pathlib.Path) -> dict[str, dict]:
    """The port's rule structure with its commands read as the reference's
    and its one added flag, ``--device``, set apart in ``device``."""
    ours = derive_structure(parse_snakefile(path))
    for rule in ours.values():
        if rule["tool"] and rule["tool"].startswith("panvc3_torch_"):
            rule["tool"] = "panvc3_" + rule["tool"].removeprefix("panvc3_torch_")
        rule["device"] = "--device" in rule["flags"]
        rule["flags"] = [f for f in rule["flags"] if f != "--device"]
    return ours


def test_test_workflow_rule_parity():
    ref = ref_structure("test-workflow")
    ours = port_structure(PORT_WORKFLOWS / "test-workflow/Snakefile")
    assert set(ref) == set(ours)
    for name, ref_rule in ref.items():
        our_rule = ours[name]
        assert ref_rule["io"] == our_rule["io"], name
        assert our_rule["tool"] == ref_rule["tool"], name
        if ref_rule["tool"] and ref_rule["tool"].startswith("panvc3_"):
            assert not set(ref_rule["flags"]) - set(our_rule["flags"]), name
            assert not set(our_rule["flags"]) - set(ref_rule["flags"]), name
        assert our_rule["device"] == (name == "project_alignments"), name
    assert "alignments.mapq-recalculated.sam.gz" in ours["all"]["input_raw"]


def test_test_workflow_tool_flag_values():
    text = shell_text(parse_snakefile(PORT_WORKFLOWS / "test-workflow/Snakefile")["project_alignments"])
    for frag in ("--reference-msa-id=REF", "--ref-id-separator=/", "--record-index-tag=XI",
                 "--preserve-tag=XS", "--preserve-tag=YS", "--device={params.device}"):
        assert frag in text, frag


def test_bowtie2_workflow_pipeline_rules():
    ref = ref_structure("bowtie2-workflow")
    ours = port_structure(PORT_WORKFLOWS / "bowtie2-workflow/Snakefile")
    for name in _PIPELINE_RULES:
        ref_rule, our_rule = ref[name], ours[name]
        if ref_rule["tool"] and ref_rule["tool"].startswith(("panvc3_", "bowtie2", "vcf2multialign")):
            assert our_rule["tool"] == ref_rule["tool"], name
            ref_f, our_f = set(ref_rule["flags"]), set(our_rule["flags"])
            assert not {f for f in ref_f - our_f if f not in _EXTRA_FLAG_ALLOWLIST}, name
            assert not {f for f in our_f - ref_f if f not in _EXTRA_FLAG_ALLOWLIST}, name
        assert ref_rule["io"]["output"] == our_rule["io"]["output"], name
        assert our_rule["has_benchmark"], name
        assert our_rule["device"] == (name == "project_alignments"), name
    # every rule, the adapters too, is the JAX package's apart from the names
    jax = derive_structure(parse_snakefile(REPO / "workflows/bowtie2-workflow/Snakefile"))
    assert set(jax) == set(ours)
    filter_raw = parse_snakefile(PORT_WORKFLOWS / "bowtie2-workflow/Snakefile")["filter_reference"]["shell"]
    assert "panvc3_tpu_torch.postprocess.coverage_tools" in filter_raw


@pytest.mark.parametrize("workflow", ["test-workflow", "bowtie2-workflow"])
@pytest.mark.parametrize("config,device", [({}, "cuda"), ({"device": "cpu"}, "cpu")])
def test_device_comes_from_the_config(workflow, config, device):
    """``--device`` of project_alignments is the config's ``device``, by
    default ``cuda``; no other rule passes one."""
    rules = snakefile_rules(PORT_WORKFLOWS / workflow / "Snakefile")
    for name, rule in rules.items():
        if name == "project_alignments":
            assert rule_entries(rule, "params", config).device == device
            assert '" --device={params.device}"' in rule["shell"]
        else:
            assert "--device" not in rule.get("shell", ""), name
    if workflow == "test-workflow":
        assert f" --device={device} " in rule_io(rules["project_alignments"], config)[3]


@pytest.fixture(scope="module")
def workflow_runs(tmp_path_factory):
    """The final SAMs of the port's Snakefile (device cpu) and of
    ``panvc3_tpu``'s, run the same way, and the port's sorted input."""
    root = tmp_path_factory.mktemp("workflows")
    env = {k: v for k, v in os.environ.items() if not k.startswith("PANVC3_")}
    env.update(PYTHONPATH=str(REPO), PANVC3_HOST_DP="0", PANVC3_FASTLANE_PROF="1")
    finals = {}
    for package, prefix, snakefile, config in (
        ("panvc3_tpu_torch", "panvc3_torch_", PORT_WORKFLOWS / "test-workflow/Snakefile",
         {"device": "cpu"}),
        ("panvc3_tpu", "panvc3_", REPO / "workflows/test-workflow/Snakefile", {}),
    ):
        shims = write_shims(root / f"bin-{package}", {
            prefix + tool: [sys.executable, "-m", package, tool] for tool in TOOLS
        })
        run_env = dict(env, PATH=f"{shims}{os.pathsep}{env.get('PATH', '')}")
        finals[package], err = run_test_workflow(snakefile, root / package, run_env, config)
        if package == "panvc3_tpu_torch":
            assert '"device": "cpu"' in err and '"dispatches": 0' not in err, err
    return finals, root


def test_workflow_matches_jax_package(workflow_runs):
    finals, _ = workflow_runs
    port, jax = finals["panvc3_tpu_torch"], finals["panvc3_tpu"]
    assert port.count(b"\n") > 3000
    assert strip_pg(port) == strip_pg(jax)


def test_workflow_matches_workflow_module(workflow_runs, tmp_path):
    """``python -m panvc3_tpu_torch.workflow`` on the Snakefile run's sorted
    input gives its final records."""
    finals, root = workflow_runs
    sorted_bam = root / "panvc3_tpu_torch/alignments/alignments.sorted.bam"
    env = {k: v for k, v in os.environ.items() if not k.startswith("PANVC3_")}
    proc = subprocess.run(
        [sys.executable, "-m", "panvc3_tpu_torch.workflow", "--workdir", str(tmp_path),
         "--alignments", str(sorted_bam), "--device", "cpu"],
        env=dict(env, PYTHONPATH=str(REPO)), cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    module_run = (tmp_path / "alignments.mapq-recalculated.sam").read_bytes()

    def body(sam: bytes) -> list[bytes]:
        return [ln for ln in sam.split(b"\n") if ln and not ln.startswith(b"@")]

    assert body(module_run) == body(finals["panvc3_tpu_torch"])
