"""The port's E-MAML trainer (``train.run_emaml``), ``train_gpt`` and the
run supervisor, end to end on the CPU at smoke sizes."""

import importlib
import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from arcle_tpu_torch.utils import Checkpointer, RunConfig

ttrain, tgpt, tsup, tppo = (
    importlib.import_module(f"arcle_tpu_torch.training.{m}")
    for m in ("train", "train_gpt", "supervise", "ppo"))


def run_args(path, *extra):
    return ["--smoke", "--device", "cpu", "--log-file",
            str(path / "log.jsonl"), "--ckpt-dir", str(path / "ckpt"),
            *extra]


def iterations(path):
    return [l for l in map(json.loads, open(path / "log.jsonl"))
            if "iteration" in l]


EMAML_KEYS = {"total_loss", "outer_policy_loss", "outer_vf_loss",
              "outer_kl_loss", "outer_total_loss", "adapt_eprewmax",
              "adapt_eprewmean", "adapt_eprewmin", "post_eprewmax",
              "post_eprewmean", "post_eprewmin", "num_covered_tasks",
              "num_succeed_tasks", "kl", "sampled_tasks", "once_successful",
              "post_reward_per_task", "iteration", "wall_time"}


def test_run_emaml_smoke_and_resume(tmp_path):
    """``train --smoke`` runs E-MAML by default (the MLP policy): the log
    has the wandb keys, a checkpoint holds the whole state, and two
    iterations plus a resumed third equal three in a row bit for bit."""
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    straight = ttrain.main(run_args(tmp_path / "a", "--iterations", "3"))
    ttrain.main(run_args(tmp_path / "b", "--iterations", "2"))
    resumed = ttrain.main(run_args(tmp_path / "b", "--iterations", "3",
                                   "--resume"))
    for a, b in zip(straight.state_dict().values(),
                    resumed.state_dict().values()):
        assert torch.equal(a, b)
    lines_a, lines_b = iterations(tmp_path / "a"), iterations(tmp_path / "b")
    assert [l["iteration"] for l in lines_b] == [0, 1, 2]
    assert set(lines_a[0]) == EMAML_KEYS
    for la, lb in zip(lines_a, lines_b):
        assert la["total_loss"] == lb["total_loss"]
        assert np.isfinite(la["total_loss"])
        assert len(la["sampled_tasks"]) == 2
    saved = Checkpointer(str(tmp_path / "b" / "ckpt")).restore()
    assert saved["iteration"] == 2
    assert set(saved) == {"params", "opt_state", "kl_coeffs", "generator",
                          "state_generator", "tasks_covered",
                          "tasks_succeeded", "iteration"}
    assert saved["kl_coeffs"].shape == (2, 2)
    assert int(saved["tasks_covered"].sum()) == 2 * 3
    cfg, _ = ttrain.parse_config(run_args(tmp_path))
    assert cfg.algo == "emaml"


def test_successful_batches_pickled(tmp_path):
    """A solved task's post-adaptation batch lands in
    ``<ckpt>/successful/epoch<i>_<task>.pickle`` as ``{"task_idx",
    "batch": {field: numpy or None}}``, the JAX package's format."""
    cfg = RunConfig(checkpoint_dir=str(tmp_path))
    batch = tppo.PPOBatch(*(torch.arange(12.0).view(2, 6) + i
                            for i in range(6)))
    metrics = {"once_successful": torch.tensor([False, True]),
               "sampled_tasks": torch.tensor([5, 9], dtype=torch.int32)}
    ttrain._save_successful(cfg, 3, metrics, batch)
    assert os.listdir(tmp_path / "successful") == ["epoch3_9.pickle"]
    with open(tmp_path / "successful" / "epoch3_9.pickle", "rb") as fp:
        got = pickle.load(fp)
    assert got["task_idx"] == 9
    assert list(got["batch"]) == list(tppo.PPOBatch._fields)
    np.testing.assert_array_equal(got["batch"]["obs"],
                                  np.arange(6.0, 12.0))
    assert got["batch"]["rewards"] is None


def test_train_gpt_smoke_emaml(tmp_path):
    """``train_gpt --smoke`` on the CPU: the GPT (2 layers, width 32)
    through the fused E-MAML step; finite losses, params moved."""
    cfg, _ = tgpt.parse_config(run_args(tmp_path))
    init = ttrain.build_agent(cfg).init_fn(
        torch.Generator().manual_seed(cfg.seed))
    pol = tgpt.main(run_args(tmp_path, "--iterations", "1"))
    assert any(not torch.equal(a, b) for a, b in
               zip(pol.state_dict().values(), init.state_dict().values()))
    (line,) = iterations(tmp_path)
    assert set(line) == EMAML_KEYS and np.isfinite(line["total_loss"])
    meta = json.loads(open(tmp_path / "log.jsonl").readline())["meta"]
    assert meta["config"]["gpt"]["dtype"] == "torch.bfloat16"


def test_train_gpt_smoke_ppo_aux(tmp_path):
    """``train_gpt --algo ppo --aux-coeff 0.1 --smoke``: the PPO batch
    carries the aux targets and the three aux losses are logged finite."""
    tgpt.main(run_args(tmp_path, "--algo", "ppo", "--aux-coeff", "0.1",
                       "--iterations", "1"))
    (line,) = iterations(tmp_path)
    for k in ("aux_loss", "aux_rtm1_loss", "aux_r_loss", "aux_grid_loss",
              "total_loss"):
        assert np.isfinite(line[k]), k


def test_train_gpt_config():
    """The full configuration train_gpt builds (train_gpt.py:88-133)."""
    cfg, _ = tgpt.parse_config([])
    e = cfg.emaml
    assert cfg.model == "gpt" and cfg.algo == "emaml"
    assert cfg.device == "cuda" and cfg.checkpoint_every == 1
    assert cfg.gpt.attn_chunk == 256 and cfg.gpt.remat
    assert cfg.gpt.dtype == torch.bfloat16 and cfg.gpt.n_layer == 8
    assert (e.n_tasks, e.envs_per_task, e.rollout_steps, e.inner_steps,
            e.maml_opt_steps, e.n_micro) == (2, 1, 100, 20, 5, 2)
    assert e.first_order and e.chunked and e.cache_chain
    assert not e.kl_ladder_grads and e.ppo.vf_coeff == 0.5
    assert (cfg.env.n_envs, cfg.env.episode_limit, cfg.ppo.n_minibatches,
            cfg.ppo.vf_coeff) == (64, 100, 100, 0.5)
    cfg, _ = tgpt.parse_config(["--exact-chain", "--kl-ladder-grads",
                                "--envs-per-task", "3", "--no-remat"])
    assert not cfg.emaml.cache_chain and cfg.emaml.kl_ladder_grads
    assert cfg.emaml.n_micro == 6 and not cfg.gpt.remat
    with pytest.raises(SystemExit):
        tgpt.parse_config(["--aux-coeff", "0.1"])
    assert json.loads(cfg.to_json())["gpt"]["dtype"] == "torch.bfloat16"


def test_supervise_restarts_with_resume(tmp_path):
    """A child that fails without ``--resume`` is relaunched with it."""
    script = ("import sys; sys.exit(0 if '--resume' in sys.argv else 3)")
    log = tmp_path / "run.out"
    rc = tsup.run_supervised([sys.executable, "-c", script], str(log),
                             stale=600, max_restarts=2, poll=0.2)
    assert rc == 0
    text = open(log).read()
    assert "attempt 0" in text and "attempt 1" in text and "--resume" in text
    rc = tsup.run_supervised([sys.executable, "-c", "raise SystemExit(4)"],
                             str(tmp_path / "fail.out"), stale=600,
                             max_restarts=1, poll=0.2)
    assert rc == 4


@pytest.mark.parametrize("algo", ["emaml", "ppo"])
def test_train_gpt_cuda_without_card_raises(tmp_path, algo):
    """``--device cuda`` with no card raises; nothing falls back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    args = run_args(tmp_path, "--algo", algo)
    args[args.index("cpu")] = "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgpt.main(args)
