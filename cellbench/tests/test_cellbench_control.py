"""The control of each cell comes out not correct: the reference put in
the port's place at the precision below the configuration's (TF32 for the
float32 MLP, fp8 for the bf16 GPT; for the engine, the shaped reward kept
in bfloat16) fails at least one of the cell's limits, and the port does
not.  The policies at their own widths and depths, the batches and
lengths cut to what a CPU test holds; on the card the same is read at the
cells' own sizes by ``cellbench/calibrate.py``."""

from __future__ import annotations

import json

import pytest

from cellbench.tests.tiny import run_in, tiny_copy


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("tiny_control"), widths=False)


@pytest.mark.parametrize("workload", ["o2arc_mlp.ppo", "color_eq.ppo",
                                      "o2arc_mlp.random_act",
                                      "color_eq.eval"])
def test_the_control_fails_a_limit(tiny, workload):
    proc = run_in(tiny, (
        "from cellbench.calibrate import main\n"
        f"main(['--workload', {workload!r}, '--seeds', '13,14', "
        "'--variants', 'sound,control'], device='cpu')\n"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    limits = json.loads((tiny / "cellbench/limits"
                         / f"{workload}.json").read_text())
    rows = [json.loads(l) for l in proc.stdout.splitlines()]
    for r in rows:
        over = [k for k, lim in limits.items() if r["numbers"][k] > lim]
        if r["variant"] == "control":
            assert over, (r["seed"], r["numbers"])
        else:
            assert not over, (r["seed"], over, r["numbers"])
