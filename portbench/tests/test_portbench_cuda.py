"""On the card: one short run of each cell as committed, which has to come
out correct.  Run on a machine with a card, from the root of a checkout:

    python -m pytest portbench/tests/test_portbench_cuda.py -m cuda -q
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
from conftest import ROOT

CELLS = [cell["name"] for cell in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is false")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(card, cell):
    done = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed", str(2**31 + 3),
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200,
    )
    assert done.returncode == 0, done.stderr[-3000:]
    result = json.loads(done.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["platform"] == "gpu", done.stderr[-3000:]
