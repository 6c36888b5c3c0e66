"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the port."""

from __future__ import annotations

import ast
import sys
from pathlib import Path

import pytest

from cellbench import harness as H
from cellbench.tests.tiny import BENCH, run_in, tiny_copy


@pytest.mark.parametrize("name,banned", [
    ("arcle_tpu_torch.training.ppo", False), ("arcle_tpu_torch", False),
    ("arcle_tpu.ops.table", True), ("arcle_tpu", True), ("jax", True),
    ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax.linen", True),
    ("jaxtyping", False), ("flaxen", False)])
def test_top_level_names_compare_whole(monkeypatch, name, banned):
    monkeypatch.setitem(sys.modules, name, object())
    assert (name.split(".")[0] in H.loaded_banned()) == banned


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("part", ["reference", "cost", "metrics"])
def test_yardsticks_import_nothing_of_the_port(part):
    for path in (BENCH / part).rglob("*.py"):
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("arcle_tpu_torch", "arcle_tpu", "jax",
                               "jaxlib", "flax"), (path, mod)


def test_a_run_loads_no_jax(tmp_path):
    root = tiny_copy(tmp_path)
    proc = run_in(root, (
        "from cellbench.run import main\n"
        "import io, contextlib\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    main(['--workload', 'color_eq.eval', '--seed', '3', "
        "'--seconds', '0.5', '--trace', '0'], device='cpu')\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = set(eval(proc.stdout.strip().splitlines()[-1]))
    assert "arcle_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "arcle_tpu"}


def test_the_reference_loads_nothing_of_the_port(tmp_path):
    root = tiny_copy(tmp_path)
    proc = run_in(root, (
        "import cellbench.reference.engine, cellbench.reference.mlp, "
        "cellbench.reference.gpt, cellbench.reference.ppo, "
        "cellbench.reference.compare, cellbench.reference.tasks, "
        "cellbench.cost.flops, cellbench.cost.step_kernel_bytes\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = set(eval(proc.stdout.strip().splitlines()[-1]))
    assert not loaded & {"arcle_tpu_torch", "jax", "jaxlib", "flax",
                         "arcle_tpu"}
