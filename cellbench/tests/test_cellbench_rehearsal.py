"""Every cell's run, end to end on the CPU at tiny sizes (``device="cpu"``
is injected by the test alone): its result line, its checks, the command
line without a card, a mix added by data alone, and the faults that
``correct`` must catch."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from cellbench.tests.tiny import REPO, edit_json, run_cell, run_in, tiny_copy

WORKLOADS = {"o2arc_mlp.ppo": "train_env_steps_per_s",
             "color_eq.ppo": "train_env_steps_per_s",
             "o2arc_mlp.random_act": "engine_env_steps_per_s",
             "color_eq.eval": "eval_env_steps_per_s"}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_each_cell_runs_and_is_correct(tiny, workload):
    out = run_cell(tiny, workload, seed=3_000_000_019)
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == {WORKLOADS[workload], "setup_s"}
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    for v in out["metrics"].values():
        assert v["value"] > 0


@pytest.mark.parametrize("workload", ["o2arc_mlp.ppo",
                                      "o2arc_mlp.random_act"])
def test_a_traced_run_reports_its_layers(tiny, workload):
    out = run_cell(tiny, workload, seed=5, trace=1)
    assert out["correct"] is True
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"] * 1.01
    bench = json.loads((tiny / "BENCHMARK.json").read_text())
    mine = {m["name"] for m in bench["per_layer"]
            if workload in m["workloads"]}
    # the shares of a peak need a card's peaks: not on the CPU
    assert set(out["metrics"]) <= mine
    assert {m for m in mine if "idle" in m} <= set(out["metrics"])
    assert len(out["breakdown"]["device_ops"]) <= 10
    assert len(out["breakdown"]["idle_gaps"]) <= 10


def test_the_same_seed_gives_the_same_checks(tiny):
    a = run_cell(tiny, "o2arc_mlp.random_act", seed=77, seconds=0.3)
    b = run_cell(tiny, "o2arc_mlp.random_act", seed=77, seconds=0.3)
    assert a["checks"] == b["checks"]


def _cli(root, *extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "cellbench/run.py", "--workload", "color_eq.eval",
         "--seed", "1", "--seconds", "1", "--trace", "0", *extra],
        capture_output=True, text=True, cwd=root, env=env, timeout=300)


def test_the_command_line_without_a_card_prints_no_result(tiny):
    proc = _cli(REPO)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_a_tree_without_the_port_prints_no_result(tiny):
    proc = _cli(tiny)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_a_mix_added_as_data_runs_without_edits(tmp_path):
    root = tiny_copy(tmp_path)
    before = {p: p.read_bytes() for p in (root / "cellbench").rglob("*")
              if p.is_file()}
    (root / "cellbench/traffic/random_act_8x5.json").write_text(json.dumps(
        {"driver": "random_act", "n_envs": 8, "segment_steps": 5,
         "actions": "bbox", "checked_segments": 1, "checked_from": 2}))
    (root / "cellbench/limits/o2arc_mlp.random_small.json").write_text(
        json.dumps({"transitions": 0}))

    def add(d):
        d["workloads"].append({"name": "o2arc_mlp.random_small",
                               "config": "o2arc_mlp",
                               "traffic": "random_act_8x5", "chips": 1,
                               "why": "a dummy mix"})
        for m in d["end_to_end"] + d["per_layer"]:
            if "o2arc_mlp.random_act" in m.get("workloads", []):
                m["workloads"].append("o2arc_mlp.random_small")
    edit_json(root / "BENCHMARK.json", add)
    out = run_cell(root, "o2arc_mlp.random_small", seed=9)
    assert out["correct"] is True
    assert "engine_env_steps_per_s" in out["metrics"]
    after = {p: p.read_bytes() for p in before}
    assert after == before


# ---- faults planted under the timed path: ``correct`` comes out false ----
UNCHANGED_STEP = (
    "import arcle_tpu_torch.envs.core as C\n"
    "orig = C.BatchedEnv.step\n"
    "def step(self, bs, act):\n"
    "    out = orig(self, bs, act)\n"
    "    return (bs,) + tuple(out[1:])\n"
    "C.BatchedEnv.step = step\n")
ALTERED_REWARD = (
    "import arcle_tpu_torch.envs.core as C\n"
    "orig = C.BatchedEnv.step\n"
    "def step(self, bs, act):\n"
    "    out = list(orig(self, bs, act))\n"
    "    r = out[2].clone(); r[0] += 1.0; out[2] = r\n"
    "    return tuple(out)\n"
    "C.BatchedEnv.step = step\n")


def _learner(module, body):
    return (f"import arcle_tpu_torch.training.{module} as M\n"
            "orig = M.train_step\n"
            f"def train_step(params, opt, batch, *a, **k):\n{body}\n"
            "M.train_step = train_step\n")


UNCHANGED_UPDATE = ("    import torch\n"
                    "    return {'total_loss': torch.zeros(())}")
HALF_BATCH = ("    n = batch.obs.shape[0] // 2\n"
              "    return orig(params, opt, batch.take(slice(0, n)), *a, "
              "**k)")
# every update's loss over the first half of its minibatch's rows
HALF_MINIBATCH = (
    "import arcle_tpu_torch.training.ppo as P\n"
    "orig_update = P._update\n"
    "def _update(params, opt, batch, *a, **k):\n"
    "    n = batch.obs.shape[0] // 2\n"
    "    return orig_update(params, opt, batch.take(slice(0, n)), *a, **k)\n"
    "P._update = _update\n")
ALTERED_ACTION = (
    "import arcle_tpu_torch.benchmarks.answer_given as AG\n"
    "orig_agent = AG.answer_given_agent\n"
    "def agent(*a, **k):\n"
    "    ag = orig_agent(*a, **k)\n"
    "    def sample_fn(*s, **kw):\n"
    "        acts, lp, v = ag.sample_fn(*s, **kw)\n"
    "        acts = acts.clone(); acts[0, 4] = (acts[0, 4] + 1) % 10\n"
    "        return acts, lp, v\n"
    "    import dataclasses\n"
    "    return dataclasses.replace(ag, sample_fn=sample_fn)\n"
    "AG.answer_given_agent = agent\n")

FAULTS = [
    ("o2arc_mlp.ppo", "unchanged_update", _learner("train",
                                                   UNCHANGED_UPDATE)),
    ("o2arc_mlp.ppo", "half_batch", _learner("train", HALF_BATCH)),
    ("o2arc_mlp.ppo", "half_minibatch", HALF_MINIBATCH),
    ("o2arc_mlp.ppo", "altered_reward", ALTERED_REWARD),
    ("color_eq.ppo", "unchanged_update",
     _learner("train_answer_given", UNCHANGED_UPDATE)),
    ("color_eq.ppo", "half_batch",
     _learner("train_answer_given", HALF_BATCH)),
    ("color_eq.ppo", "half_minibatch", HALF_MINIBATCH),
    ("color_eq.ppo", "altered_reward", ALTERED_REWARD),
    ("o2arc_mlp.random_act", "unchanged_step", UNCHANGED_STEP),
    ("o2arc_mlp.random_act", "altered_reward", ALTERED_REWARD),
    ("color_eq.eval", "unchanged_step", UNCHANGED_STEP),
    ("color_eq.eval", "altered_action", ALTERED_ACTION),
]


@pytest.mark.parametrize("workload,fault,patch", FAULTS,
                         ids=[f"{w}-{f}" for w, f, _ in FAULTS])
def test_a_planted_fault_is_not_correct(tiny, workload, fault, patch):
    out = run_cell(tiny, workload, seed=21, seconds=0.5, prelude=patch)
    assert out["correct"] is False, (fault, out["checks"])
