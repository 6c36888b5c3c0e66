"""The PPO trainer on the card against the trainer on the CPU.

Marked ``gpu``: it skips without a CUDA card and runs on one with
``python -m pytest tests/test_torch_train_gpu.py -m gpu``.  This file
imports no JAX, so it also runs where JAX is not installed.
"""

import dataclasses
import importlib

import pytest
import torch

from arcle_tpu_torch.envs import make_reset_pool
from arcle_tpu_torch.envs.core import BatchedState
from arcle_tpu_torch.ops import step_kernel

troll, ttrain = (importlib.import_module(f"arcle_tpu_torch.training.{m}")
                 for m in ("rollout", "train"))
tmlp = importlib.import_module("arcle_tpu_torch.models.mlp")


def test_env_options_follow_the_bank():
    """The reset options move to the bank's device when the env is built:
    options left on the host would cost a blocking copy, which waits for
    the device, on every auto-reset step."""
    from arcle_tpu_torch.envs import BatchedEnv, ResetOptions
    from arcle_tpu_torch.loaders import SyntheticLoader
    from arcle_tpu_torch.ops import o2arc_table
    env = BatchedEnv(table=o2arc_table(),
                     bank=SyntheticLoader(2, seed=0).bank(device="meta"),
                     opts=ResetOptions.make(reset_on_submit=True,
                                            device="cpu"))
    for f in dataclasses.fields(env.opts):
        assert getattr(env.opts, f.name).device.type == "meta", f.name


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the step kernel has no CPU mode")
    return torch.device("cuda", 0)


def _to(obj, device):
    return type(obj)(**{f.name: getattr(obj, f.name).to(device)
                        for f in dataclasses.fields(obj)})


def _smoke_iterations(cfg, start_env, monkeypatch, n_iter=2):
    """``n_iter`` smoke PPO iterations on ``cfg.device`` from the same
    weights (drawn on the CPU from the seed) and the same start state.  The
    reset pools and the sampling noise are drawn by CPU generators seeded
    alike and moved to the device, so both devices take the same actions
    (the smoke config's pool serves every auto-reset)."""
    pool_gen = torch.Generator().manual_seed(1)
    noise_gen = torch.Generator().manual_seed(2)

    def pool_on_cpu(env, generator, batch):
        cpu_env = dataclasses.replace(env, bank=env.bank.to("cpu"))
        return _to(make_reset_pool(cpu_env, pool_gen, batch), env.device)

    monkeypatch.setattr(troll, "make_reset_pool", pool_on_cpu)
    monkeypatch.setattr(tmlp, "gumbel_uniforms",
                        lambda shape, gen, device: torch.rand(
                            shape, generator=noise_gen).clamp_(min=1e-12)
                        .to(device))
    run = ttrain.setup_ppo(cfg)
    run.bs = BatchedState(env=_to(start_env, run.bs.env.device),
                          generator=run.generator)
    return [ttrain.ppo_iteration(run)[1] for _ in range(n_iter)]


@pytest.mark.gpu
def test_smoke_ppo_cuda_matches_cpu(cuda_device, monkeypatch):
    """Two ``--smoke`` PPO iterations on the card (through the step
    kernel) and on the CPU (through the plain step): the losses agree at
    rtol 1e-4 (atol 1e-6 for the means that cancel to ~0)."""
    cfg, _ = ttrain.parse_config(["--smoke", "--device", "cpu"])
    start = ttrain.setup_ppo(cfg).bs.env
    cpu = _smoke_iterations(cfg, start, monkeypatch)
    launches = step_kernel.LAUNCHES
    gpu = _smoke_iterations(dataclasses.replace(cfg, device="cuda"), start,
                            monkeypatch)
    torch.cuda.synchronize()
    assert step_kernel.LAUNCHES - launches == 2 * cfg.env.episode_limit
    for i, (c, g) in enumerate(zip(cpu, gpu)):
        assert set(c) == set(g)
        for k in c:
            torch.testing.assert_close(g[k].cpu(), c[k], rtol=1e-4,
                                       atol=1e-6, msg=f"iteration {i} {k}")
        assert torch.isfinite(g["total_loss"])
