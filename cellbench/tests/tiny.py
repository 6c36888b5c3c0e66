"""A copy of the benchmark at sizes a CPU test holds: the same files with
the configurations' and mixes' sizes cut, beside the port."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
REPO = BENCH.parent

# the policies' widths and depths, cut unless a copy keeps them
WIDTHS = {
    "configs/o2arc_mlp.json": lambda d: d["policy"].update(hidden=[64, 32]),
    "configs/color_eq.json": lambda d: (
        d["policy"].update(n_layer=1, n_head=2, n_embd=32),
        d["env"].update(n_tasks=64)),
}
# batches and lengths, always cut: 2 x 2 minibatches of the tiny rollout's
# rows, as 4 x 8 of them would leave a handful of rows to an update
SHRINK = {
    "configs/color_eq.json": lambda d: d["learner"].update(
        n_epochs=2, n_minibatches=2),
    "traffic/ppo_4096x100.json": lambda d: d.update(
        n_envs=16, rollout_steps=8, checked_iterations=2,
        checked_from=1),
    "traffic/ppo_1024x64.json": lambda d: d.update(
        n_envs=8, rollout_steps=6, checked_iterations=2,
        checked_from=1),
    "traffic/random_act_4096x100.json": lambda d: d.update(
        n_envs=16, segment_steps=10, checked_from=3),
    "traffic/eval_512x50.json": lambda d: d.update(
        n_envs=8, episode_steps=6, n_tasks=32, checked_from=4),
}


def edit_json(path: Path, fn) -> None:
    d = json.loads(path.read_text())
    fn(d)
    path.write_text(json.dumps(d))


def tiny_copy(dst: Path, widths: bool = True) -> Path:
    """``BENCHMARK.json`` and ``cellbench/`` under ``dst``, cut to CPU
    sizes (the traffic's batches and lengths, and unless ``widths`` is
    False the policies' widths and depths); returns ``dst``."""
    shutil.copytree(BENCH, dst / "cellbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    for rel, fn in list(SHRINK.items()) + (list(WIDTHS.items()) if widths
                                             else []):
        edit_json(dst / "cellbench" / rel, fn)
    return dst


def run_in(root: Path, code: str, timeout: float = 600.0
           ) -> subprocess.CompletedProcess:
    """``code`` in a fresh interpreter that imports ``cellbench`` from
    ``root`` and the port from the repository, on the CPU."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    env.pop("PYTHONPATH", None)
    prog = (f"import sys; sys.path.insert(0, {str(root)!r}); "
            f"sys.path.append({str(REPO)!r})\n" + code)
    return subprocess.run([sys.executable, "-c", prog], capture_output=True,
                          text=True, timeout=timeout, env=env, cwd=root)


def run_cell(root: Path, workload: str, seed: int = 11, seconds: float = 1.0,
             trace: int = 0, prelude: str = "") -> dict:
    """One run of ``workload`` on the CPU; its result line as a dict."""
    proc = run_in(root, prelude + (
        "from cellbench.run import main\n"
        f"rc = main(['--workload', {workload!r}, '--seed', '{seed}', "
        f"'--seconds', '{seconds}', '--trace', '{trace}'], device='cpu')\n"
        "raise SystemExit(rc)\n"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])
