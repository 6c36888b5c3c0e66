"""The trainers on the card against the trainers on the CPU.

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
    cfg, _ = ttrain.parse_config(["--algo", "ppo", "--smoke", "--device",
                                  "cpu"])
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


def _gpt_emaml_iteration(device, start_env, monkeypatch):
    """One meta-iteration of train_gpt's E-MAML step (chunked, cached
    chain, the KL read off the surrogate pass, two micro-batches) with a
    float32 GPT on ``device``, from weights drawn on the CPU.  Reset pools
    and sampling uniforms come from CPU generators seeded alike, so both
    devices take the same actions."""
    from arcle_tpu_torch.envs import BatchedEnv, ResetOptions
    from arcle_tpu_torch.loaders import SyntheticLoader
    from arcle_tpu_torch.models import GPTConfig, GPTPolicy
    from arcle_tpu_torch.ops import o2arc_table
    temaml, tagents = (importlib.import_module(
        f"arcle_tpu_torch.training.{m}") for m in ("emaml", "agents"))
    tbd, ttn = (importlib.import_module(f"arcle_tpu_torch.models.{m}")
                for m in ("bbox_dist", "truncated_normal"))
    pool_gen, op_gen, bb_gen = (torch.Generator().manual_seed(s)
                                for s in (1, 2, 3))

    def pool_on_cpu(env, generator, batch):
        cpu_env = dataclasses.replace(env, bank=env.bank.to("cpu"))
        return _to(make_reset_pool(cpu_env, pool_gen, batch), env.device)

    monkeypatch.setattr(troll, "make_reset_pool", pool_on_cpu)
    monkeypatch.setattr(tbd, "gumbel_uniforms", lambda shape, gen, dev: (
        torch.rand(shape, generator=op_gen).clamp_(min=1e-12).to(dev)))
    monkeypatch.setattr(ttn, "sample_uniforms", lambda shape, gen, dev: (
        1e-6 + torch.rand(shape, generator=bb_gen) * (1 - 2e-6)).to(dev))
    cfg = temaml.EMAMLConfig(n_tasks=2, envs_per_task=2, rollout_steps=6,
                             inner_steps=2, maml_opt_steps=2, n_micro=2,
                             first_order=True, chunked=True, cache_chain=True,
                             kl_ladder_grads=False)
    agent = tagents.gpt_agent(GPTPolicy(GPTConfig(
        n_layer=2, n_head=4, n_embd=32, dtype=torch.float32)))
    st = temaml.init_emaml(agent, cfg, 0, n_bank_tasks=8, device=device)
    env = BatchedEnv(table=o2arc_table(7, crop_at_33=True),
                     bank=SyntheticLoader(8, seed=7).bank(device=device),
                     max_trial=7, episode_limit=10, auto_reset=True,
                     dense_reward=True, augment=True, reset_pool=8,
                     opts=ResetOptions.make(
                         prob_index=torch.tensor([3, 3, 5, 5]),
                         device=device))
    bs = BatchedState(env=_to(start_env, device),
                      generator=torch.Generator(device=device))
    launches = step_kernel.LAUNCHES
    st, _, metrics = temaml.make_chunked_train_step(agent, cfg)(st, env, bs)
    return st, metrics, step_kernel.LAUNCHES - launches


@pytest.mark.gpu
def test_gpt_emaml_cuda_matches_cpu(cuda_device, monkeypatch):
    """train_gpt's E-MAML step on the card (every rollout step through the
    step kernel) and on the CPU: rollout_steps x (inner_steps + 1) = 18
    kernel launches, meta loss and rewards rtol 1e-4 / atol 1e-6, the
    params after the AdamW meta steps atol 1e-5 (all but the op head's
    last bias, whose gradient is 0 up to rounding)."""
    from arcle_tpu_torch.envs import BatchedEnv
    from arcle_tpu_torch.loaders import SyntheticLoader
    from arcle_tpu_torch.ops import o2arc_table
    start = BatchedEnv(table=o2arc_table(7, crop_at_33=True),
                       bank=SyntheticLoader(8, seed=7).bank(device="cpu"),
                       max_trial=7).reset(torch.Generator().manual_seed(0),
                                          4).env
    cpu_st, cpu_m, cpu_launches = _gpt_emaml_iteration("cpu", start,
                                                       monkeypatch)
    gpu_st, gpu_m, gpu_launches = _gpt_emaml_iteration(cuda_device, start,
                                                       monkeypatch)
    torch.cuda.synchronize()
    assert cpu_launches == 0 and gpu_launches == 6 * 3
    for k in ("meta_loss", "outer_total_loss", "adapt_reward_mean",
              "post_reward_mean", "inner_kl_mean"):
        torch.testing.assert_close(gpu_m[k].cpu(), cpu_m[k], rtol=1e-4,
                                   atol=1e-6, msg=k)
    assert torch.isfinite(gpu_m["meta_loss"])
    cpu_sd = cpu_st.params.state_dict()
    for k, v in gpu_st.params.state_dict().items():
        if k == "head_operation.Dense_2.bias":
            # shifting every op logit changes no softmax, so this bias's
            # gradient is 0 up to rounding, which AdamW's normalisation
            # turns into steps of up to meta_lr on either device
            continue
        torch.testing.assert_close(v.cpu(), cpu_sd[k], rtol=0, atol=1e-5,
                                   msg=k)


def _answer_given_iterations(device, start_env, monkeypatch, n_iter=2):
    """``n_iter`` iterations of the answer-given trainer (potential shaping,
    all three aux losses, 2 epochs x 2 minibatches) with a float32 policy
    on ``device``, from weights drawn on the CPU and the same start state.
    Tasks are pinned per env, and the sampling uniforms and the minibatch
    shuffles come from CPU generators seeded alike, so both devices take
    the same actions."""
    from arcle_tpu_torch.benchmarks import answer_given_agent
    from arcle_tpu_torch.envs import ResetOptions
    from arcle_tpu_torch.models import GPTPolicy
    tag_train, tppo = (importlib.import_module(
        f"arcle_tpu_torch.training.{m}")
        for m in ("train_answer_given", "ppo"))
    tbd = importlib.import_module("arcle_tpu_torch.models.bbox_dist")
    noise_gen, perm_gen = (torch.Generator().manual_seed(s) for s in (2, 3))
    monkeypatch.setattr(tbd, "gumbel_uniforms", lambda shape, gen, dev: (
        torch.rand(shape, generator=noise_gen).clamp_(min=1e-12).to(dev)))
    monkeypatch.setattr(tppo, "permutations", lambda gen, e, n, dev: [
        torch.randperm(n, generator=perm_gen).to(dev) for _ in range(e)])
    args = tag_train.parse_args([
        "--device", str(device), "--n-tasks", "16", "--n-envs", "16",
        "--rollout", "12", "--episode-limit", "8", "--colors", "2",
        "--n-layer", "1", "--n-head", "2", "--n-embd", "32", "--epochs",
        "2", "--minibatches", "2"])
    run = tag_train.setup(args)
    dev = run.env.device
    run.env = dataclasses.replace(run.env, opts=ResetOptions.make(
        prob_index=torch.arange(16), subprob_index=0, device=dev))
    pol = GPTPolicy(dataclasses.replace(run.params.cfg, dtype=torch.float32),
                    generator=torch.Generator().manual_seed(0)).to(dev)
    run.agent, run.params = answer_given_agent(pol), pol
    run.opt = tppo.make_optimizer(pol, run.pcfg)
    run.bs = BatchedState(env=_to(start_env, dev), generator=run.generator)
    launches = step_kernel.LAUNCHES
    stats = [tag_train.iteration(run, 0.05)[1] for _ in range(n_iter)]
    return stats, pol, step_kernel.LAUNCHES - launches


@pytest.mark.gpu
def test_answer_given_cuda_matches_cpu(cuda_device, monkeypatch):
    """Two answer-given iterations on the card (every env step through the
    step kernel's 5x5 instantiation on the colour-only table) and on the
    CPU: 12 launches per iteration, every statistic rtol 1e-4 / atol 1e-6,
    the params after the updates atol 1e-5 (all but the op head's last
    bias, whose gradient is 0 up to rounding)."""
    from arcle_tpu_torch.benchmarks import answer_given_env
    from arcle_tpu_torch.envs import ResetOptions
    env = answer_given_env(n_tasks=16, colors=2, seed=0, device="cpu")
    env = dataclasses.replace(env, opts=ResetOptions.make(
        prob_index=torch.arange(16), subprob_index=0, device="cpu"))
    start = env.reset(torch.Generator().manual_seed(0), 16).env
    cpu, cpu_pol, cpu_launches = _answer_given_iterations("cpu", start,
                                                          monkeypatch)
    gpu, gpu_pol, gpu_launches = _answer_given_iterations(cuda_device, start,
                                                          monkeypatch)
    torch.cuda.synchronize()
    assert cpu_launches == 0 and gpu_launches == 2 * 12
    for i, (c, g) in enumerate(zip(cpu, gpu)):
        assert set(c) == set(g)
        for k in c:
            torch.testing.assert_close(
                g[k].cpu().float(), c[k].float(), rtol=1e-4, atol=1e-6,
                msg=f"iteration {i} {k}")
        assert torch.isfinite(g["total_loss"]) and \
            torch.isfinite(g["aux_loss"])
        assert int(g["episodes"]) >= 16
    cpu_sd = cpu_pol.state_dict()
    for k, v in gpu_pol.state_dict().items():
        if k == "head_operation.Dense_2.bias":
            continue
        torch.testing.assert_close(v.cpu(), cpu_sd[k], rtol=0, atol=1e-5,
                                   msg=k)
