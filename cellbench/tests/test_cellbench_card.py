"""Each cell's command on the card, briefly: ``python -m pytest
cellbench/tests -m gpu`` on a machine with a CUDA card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from cellbench.tests.tiny import REPO

CELLS = ["o2arc_mlp.ppo", "color_eq.ppo", "o2arc_mlp.random_act",
         "color_eq.eval"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_the_cell_runs_correct_on_the_card(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "cellbench/run.py", "--workload", workload,
         "--seed", "4294967311", "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, cwd=REPO, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu"
