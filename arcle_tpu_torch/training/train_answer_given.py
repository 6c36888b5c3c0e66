"""Trainer of the paper §4.1 answer-given benchmark.

Counterpart of ``arcle_tpu/training/train_answer_given.py``: PPO over
thousands of lockstep 5x5 answer-given envs, with the colour-equivariant
policy and the three auxiliary losses.  Every rollout step launches the
step kernel once (on CUDA), 64 times per iteration at the defaults.

Experiment cells::

    # headline (Figure 5, rightmost curve): all three aux losses
    python -m arcle_tpu_torch.training.train_answer_given --aux all

    # vanilla PPO control ("not able to learn anything")
    python -m arcle_tpu_torch.training.train_answer_given --aux none

    # architecture control (Figure 6): non-sequential factorized policy
    python -m arcle_tpu_torch.training.train_answer_given --arch nonseq

    # continual setting (Figure 7): colours 2 -> 4 -> 6 -> 8 -> 10
    python -m arcle_tpu_torch.training.train_answer_given --continual

Success rate is measured per completed episode (solved episodes / finished
episodes within the rollout window); the paper's target is >95% in the
random setting.  ``--device cuda`` (the default) without a CUDA card
raises; nothing falls back to the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from ..benchmarks.answer_given import (
    RandomPairLoader, answer_given_agent, answer_given_env, make_policy,
    shaping_potential,
)
from ..envs.core import BatchedEnv, BatchedState
from ..loaders.loader import TaskBank
from ..utils.checkpoint import Checkpointer
from ..utils.metrics import TRACE, MetricLogger, Throughput
from .agents import Agent
from .ppo import (
    PPOBatch, PPOConfig, batch_from_trajectory, make_optimizer, train_step,
)
from .rollout import Trajectory, rollout
from .train import _Marks, git_sha, resolve_device

CONTINUAL_COLORS = (2, 4, 6, 8, 10)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m arcle_tpu_torch.training.train_answer_given")
    ap.add_argument("--setting", default="random", choices=["random", "arc"])
    ap.add_argument("--size", type=int, default=5)
    ap.add_argument("--colors", type=int, default=10)
    ap.add_argument("--n-tasks", type=int, default=16384)
    ap.add_argument("--episode-limit", type=int, default=50)
    ap.add_argument("--arch", default="color_eq",
                    choices=["color_eq", "nonseq", "sequential"])
    ap.add_argument("--aux", default="all",
                    choices=["none", "rtm1", "rtm1+rt", "all"])
    ap.add_argument("--aux-coeff", type=float, default=0.3)
    ap.add_argument("--n-layer", type=int, default=4)
    ap.add_argument("--n-head", type=int, default=4)
    ap.add_argument("--n-embd", type=int, default=128)
    ap.add_argument("--n-envs", type=int, default=1024)
    ap.add_argument("--rollout", type=int, default=64)
    ap.add_argument("--iterations", type=int, default=2000)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--gamma", type=float, default=0.95)
    ap.add_argument("--potential-shaping", action="store_true", default=True,
                    help="learner-side potential-based shaping with "
                         "phi(s) = -wrong/total (policy-invariant; env "
                         "reward and metrics stay the paper's)")
    ap.add_argument("--no-potential-shaping", dest="potential_shaping",
                    action="store_false")
    ap.add_argument("--bbox-dist", default="categorical",
                    choices=["categorical", "truncnorm"],
                    help="selection head: discrete per-coordinate "
                         "categorical (default) or the reference's "
                         "TruncatedNormal AROPandBBox parameterization")
    ap.add_argument("--min-log-std", type=float, default=-2.3,
                    help="floor on the bbox log-std (exploration keeps a "
                         "~0.1 noise floor on the [0,1] coords); -20 "
                         "restores reference-parity behavior")
    ap.add_argument("--gae-lambda", type=float, default=0.95)
    ap.add_argument("--clip", type=float, default=0.2)
    ap.add_argument("--vf-coeff", type=float, default=0.5)
    ap.add_argument("--ent-coeff", type=float, default=0.01,
                    help="final entropy bonus (after annealing)")
    ap.add_argument("--ent-coeff-start", type=float, default=0.1,
                    help="initial entropy bonus during the discovery "
                         "phase (keeps the selection heads diffuse so "
                         "precise single-cell actions keep occurring)")
    ap.add_argument("--ent-anneal-iters", type=int, default=1500,
                    help="iterations to anneal ent-coeff-start -> "
                         "ent-coeff; 0 = constant --ent-coeff")
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--minibatches", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--continual", action="store_true",
                    help="§4.1.3 continual setting: 5 phases with "
                         "2/4/6/8/10 colors (--phase-iters each)")
    ap.add_argument("--phase-iters", type=int, default=400)
    ap.add_argument("--log-file", default="answer_given_log.jsonl")
    ap.add_argument("--ckpt-dir", default="./ckpts_answer_given")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine and the learner")
    return ap.parse_args(argv)


def build(args) -> Tuple[BatchedEnv, Agent, PPOConfig]:
    """The env (on ``args.device``), the agent and the PPO configuration
    of one experiment cell."""
    env = answer_given_env(
        n_tasks=args.n_tasks, h=args.size, w=args.size, colors=args.colors,
        seed=args.seed, episode_limit=args.episode_limit,
        setting=args.setting, device=resolve_device(args.device))
    policy = make_policy(
        h=args.size, w=args.size, colors=args.colors, n_layer=args.n_layer,
        n_head=args.n_head, n_embd=args.n_embd,
        factorized=(args.arch == "nonseq"),
        color_equivariant=(args.arch == "color_eq"),
        bbox_dist_kind=args.bbox_dist)
    agent = answer_given_agent(policy, min_log_std=args.min_log_std,
                               sequential=(args.arch == "sequential"))
    pcfg = PPOConfig(
        gamma=args.gamma, gae_lambda=args.gae_lambda, clip_eps=args.clip,
        vf_clip=10.0, vf_coeff=args.vf_coeff, entropy_coeff=args.ent_coeff,
        kl_coeff=0.0, lr=args.lr, n_epochs=args.epochs,
        n_minibatches=args.minibatches, max_grad_norm=1.0,
        aux_coeff=0.0 if args.aux == "none" else args.aux_coeff,
        aux_terms="all" if args.aux == "none" else args.aux)
    return env, agent, pcfg


def ent_schedule(args, i: int) -> float:
    """Annealed exploration: ``--ent-coeff-start`` at iteration 0, falling
    linearly to ``--ent-coeff`` by ``--ent-anneal-iters``, constant after;
    ``--ent-anneal-iters 0`` holds ``--ent-coeff`` throughout."""
    if args.ent_anneal_iters <= 0:
        return float(args.ent_coeff)
    frac = min(max(i / args.ent_anneal_iters, 0.0), 1.0)
    return args.ent_coeff_start \
        + (args.ent_coeff - args.ent_coeff_start) * frac


def learner_batch(traj: Trajectory, last_v: torch.Tensor, pcfg: PPOConfig,
                  size: int, potential_shaping: bool) -> PPOBatch:
    """The PPO batch of one rollout.

    With ``potential_shaping`` the learner's reward is potential-shaped
    (Ng et al. 1999) with phi(s) = -(wrong cells inside answer_dim) /
    (answer area): the per-step *change* in wrongness plus a terminal solve
    bonus.  phi covers the same cells as the env's pixel reward, so
    phi(s_{t+1}) == r_t and

        r'_t = r_t + gamma * phi(s_{t+1}) * (1 - term) - phi(s_t)
             = r_t * (1 + gamma * (1 - term)) - phi(s_t).

    The aux heads (``pcfg.aux_coeff > 0``) still predict the raw §4.1
    reward: ``rewards`` and ``prev_rewards`` of the batch are the env's."""
    include_aux = pcfg.aux_coeff > 0.0
    learn_traj = traj
    if potential_shaping:
        phi_t = shaping_potential(traj.obs, size, size)
        term_f = traj.terminated.to(torch.float32)
        shaped = traj.rewards * (1.0 + pcfg.gamma * (1.0 - term_f)) - phi_t
        learn_traj = traj._replace(rewards=shaped)
    # grid cells lead the answer-given obs layout
    batch = batch_from_trajectory(learn_traj, last_v, pcfg,
                                  include_aux=include_aux,
                                  grid_slice=slice(0, size * size))
    if potential_shaping and include_aux:
        flat = lambda x: x.reshape((-1,) + tuple(x.shape[2:]))
        raw_prev = torch.cat([
            torch.zeros_like(traj.rewards[:1]),
            traj.rewards[:-1] * (1.0 - traj.dones[:-1].to(torch.float32))],
            dim=0)
        batch = batch._replace(rewards=flat(traj.rewards),
                               prev_rewards=flat(raw_prev))
    return batch


def episode_stats(traj: Trajectory) -> Dict[str, torch.Tensor]:
    """Per-episode statistics over the episodes finishing in the window."""
    n_done = traj.dones.sum()
    denom = torch.clamp(n_done, min=1)
    return {"success_rate": traj.terminated.sum() / denom,
            "episode_reward_mean": traj.rewards.sum() / denom,
            "episode_len_mean": traj.rewards.numel() / denom,
            "episodes": n_done}


@dataclasses.dataclass
class AnswerGivenRun:
    """What a run carries from one iteration to the next.  The generator
    (on the device) draws the resets, the actions and the minibatch
    shuffles."""

    args: argparse.Namespace
    env: BatchedEnv
    agent: Agent
    pcfg: PPOConfig
    params: nn.Module
    opt: torch.optim.Optimizer
    generator: torch.Generator
    bs: BatchedState
    banks: Optional[List[TaskBank]] = None    # --continual: one per phase


def setup(args) -> AnswerGivenRun:
    """Env, policy and optimizer on ``args.device``.  The weights are drawn
    on the CPU from ``args.seed``, so a seed gives the same weights on
    every device."""
    env, agent, pcfg = build(args)
    dev = env.device
    banks = None
    if args.continual:
        # §4.1.3: random pairs as before, the colour count rising over five
        # phases; the same 10-op action space
        banks = [RandomPairLoader(args.n_tasks, args.size, args.size, c,
                                  args.seed + 100 + c).bank(
                     H=args.size, W=args.size, device=dev)
                 for c in CONTINUAL_COLORS]
    generator = torch.Generator(device=dev).manual_seed(args.seed)
    bs = env.reset(generator, args.n_envs)
    params = agent.init_fn(torch.Generator().manual_seed(args.seed)).to(dev)
    return AnswerGivenRun(args=args, env=env, agent=agent, pcfg=pcfg,
                          params=params, opt=make_optimizer(params, pcfg),
                          generator=generator, bs=bs, banks=banks)


def iteration(run: AnswerGivenRun, ent_coeff: float
              ) -> Tuple[Trajectory, Dict[str, torch.Tensor], _Marks]:
    """One rollout of ``--rollout`` steps and the PPO update on it.
    Returns the trajectory, the statistics (device tensors) and the marks
    before the rollout, between rollout and update, and after the
    update."""
    with TRACE.span("iteration"):
        args = run.args
        marks = _Marks(run.bs.env.device)
        marks.mark()
        run.bs, traj, last_v = rollout(run.env, run.bs, run.params,
                                       run.generator, args.rollout, run.agent)
        with TRACE.span("learner_batch"):
            batch = learner_batch(traj, last_v, run.pcfg, args.size,
                                  args.potential_shaping)
        marks.mark()
        stats = train_step(run.params, run.opt, batch, run.generator,
                           run.agent, run.pcfg, ent_coeff)
        marks.mark()
        stats.update(episode_stats(traj))
        return traj, stats, marks


def train(args, logger: MetricLogger,
          on_iteration: Optional[Callable] = None) -> nn.Module:
    """Train for ``args.iterations`` iterations (``--continual``: five
    phases of ``--phase-iters``) and return the policy.

    Each logged line carries the loss and episode statistics, env-steps/s
    including the learner and ``rollout_ms`` / ``update_ms`` on the
    device's clock.  A checkpoint holds the policy, the optimizer, the
    generator's state and the iteration; ``--resume`` continues after the
    latest.  ``on_iteration(i, run, traj, stats)`` is called after each
    iteration."""
    run = setup(args)
    n_params = sum(p.numel() for p in run.params.parameters())
    print(f"policy params: {n_params:,}", file=sys.stderr)
    iterations = args.iterations
    if run.banks is not None:
        iterations = args.phase_iters * len(run.banks)

    ckpt = Checkpointer(args.ckpt_dir)
    start = 0
    if args.resume:
        restored = ckpt.restore(map_location="cpu")
        if restored is not None:
            run.params.load_state_dict(restored["params"])
            run.opt.load_state_dict(restored["opt_state"])
            run.generator.set_state(restored["generator"])
            start = int(restored["iteration"]) + 1
            print(f"resumed from iteration {start - 1}", file=sys.stderr)

    thr = Throughput()
    t0 = time.perf_counter()
    phase = -1
    for i in range(start, iterations):
        if run.banks is not None:
            p = min(i // args.phase_iters, len(run.banks) - 1)
            if p != phase:
                phase = p
                run.env = dataclasses.replace(run.env, bank=run.banks[p])
                run.bs = run.env.reset(run.generator, args.n_envs)
                print(f"[phase {p}] colors={CONTINUAL_COLORS[p]}",
                      file=sys.stderr)
        traj, stats, marks = iteration(run, ent_schedule(args, i))
        rate = thr.tick(args.n_envs * args.rollout, stats["total_loss"])
        stats["rollout_ms"], stats["update_ms"] = marks.ms()
        stats["env_steps_per_s"] = rate
        if run.banks is not None:
            stats["phase"] = phase
        logger.log(i, stats)
        if i % 10 == 0:
            print(f"[iter {i}] success={float(stats['success_rate']):.3f} "
                  f"eprew={float(stats['episode_reward_mean']):.2f} "
                  f"loss={float(stats['total_loss']):.4f} "
                  f"{rate:,.0f} steps/s ({time.perf_counter() - t0:.0f}s)",
                  file=sys.stderr, flush=True)
        if args.ckpt_every and i % args.ckpt_every == 0:
            ckpt.save(i, {"params": run.params.state_dict(),
                          "opt_state": run.opt.state_dict(),
                          "generator": run.generator.get_state(),
                          "iteration": i})
        if on_iteration is not None:
            on_iteration(i, run, traj, stats)
    return run.params


def main(argv=None) -> nn.Module:
    args = parse_args(argv)
    logger = MetricLogger(args.log_file)
    try:
        # provenance header, so a kept log can be read on its own
        logger.meta({"argv": list(argv) if argv else sys.argv[1:],
                     "config": dict(vars(args)), "git_sha": git_sha()})
        return train(args, logger)
    finally:
        logger.close()


if __name__ == "__main__":
    main()
