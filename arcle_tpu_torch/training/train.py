"""Training entry point: PPO and E-MAML.

Counterpart of ``arcle_tpu/training/train.py``: the CustomO2ARC-style env
(CropGrid at op 33, augmentation, dense shaped reward, max_trial=127,
TimeLimit 100), the MLP policy [1024,1024,512,512,256,128] tanh over the
FilterO2ARC + Flatten obs with BBox-tuple action heads (or the GPT policy,
``--model gpt``), E-MAML (the default) or plain PPO; checkpoints every N
iterations and JSONL metric logging with the reference's wandb schema.

Run:  python -m arcle_tpu_torch.training.train --algo emaml --model mlp \\
          --device cuda --iterations 100

``--device cuda`` without a CUDA card raises; nothing falls back to the
CPU.  ``--dtype bfloat16`` runs the MLP torso in bf16 (float32 parameters
and heads).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..envs import BatchedEnv, ResetOptions
from ..envs.core import BatchedState
from ..models.gpt import GPTPolicy
from ..models.mlp import FCPolicy
from ..parallel.mesh import rank_generator, shard_block, task_layout
from ..utils.checkpoint import Checkpointer
from ..utils.config import RunConfig, EnvConfig, make_table, make_loader
from ..utils.metrics import TRACE, MetricLogger, Throughput
from .agents import Agent, gpt_agent, mlp_agent
from .emaml import (
    EMAMLConfig, EMAMLState, all_task_rows, emaml_train_step, init_emaml,
    make_chunked_train_step, sample_task_assignment,
)
from .ppo import batch_from_trajectory, make_optimizer, train_step
from .rollout import Trajectory, rollout


def resolve_device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name}: CUDA is not available (the "
                           "trainer does not fall back to the CPU)")
    return dev


def build_agent(cfg: RunConfig) -> Agent:
    if cfg.model == "gpt":
        return gpt_agent(GPTPolicy(cfg.gpt))
    dtype = torch.bfloat16 if cfg.mlp_dtype in ("bf16", "bfloat16") \
        else torch.float32
    return mlp_agent(FCPolicy(hidden=tuple(cfg.mlp_hidden),
                              n_ops=make_table(cfg.env).n_ops, dtype=dtype))


def git_sha() -> str:
    """The short hash of the checkout this package runs from, or
    ``"unknown"``."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    try:
        proc = subprocess.run(["git", "-C", repo, "rev-parse", "--short",
                               "HEAD"], capture_output=True, text=True,
                              timeout=10)
        sha = proc.stdout.strip() if proc.returncode == 0 else ""
    except (OSError, subprocess.SubprocessError):
        sha = ""
    return sha or "unknown"


def log_provenance(logger: MetricLogger, cfg: RunConfig, argv=None) -> None:
    """One JSONL header line per run record: config, git sha, argv."""
    logger.meta({"config": json.loads(cfg.to_json()), "git_sha": git_sha(),
                 "argv": list(argv) if argv else sys.argv[1:]})


@dataclasses.dataclass
class PPORun:
    """Everything a PPO run carries from one iteration to the next.  The
    generator (on the device) draws the env resets, the reset pools, the
    actions and the minibatch shuffles.  ``group``: the data-parallel
    process group, or None for one process."""

    cfg: RunConfig
    env: BatchedEnv
    agent: Agent
    params: nn.Module
    opt: torch.optim.Optimizer
    generator: torch.Generator
    bs: BatchedState
    n_steps: int
    group: Optional[object] = None


def setup_ppo(cfg: RunConfig, group=None) -> PPORun:
    """Env, policy and optimizer on ``cfg.device``.  The weights are drawn
    on the CPU from ``cfg.seed``, so a seed gives the same weights on
    every device and every rank.  With a data-parallel ``group`` the
    ``cfg.env.n_envs`` envs are reset whole and this rank keeps its block
    (:func:`parallel.mesh.shard_block`), with its own generator."""
    agent = build_agent(cfg)
    dev = resolve_device(cfg.device)
    env = BatchedEnv(table=make_table(cfg.env),
                     bank=make_loader(cfg.env).bank(device=dev),
                     max_trial=cfg.env.max_trial,
                     episode_limit=cfg.env.episode_limit, auto_reset=True,
                     dense_reward=cfg.env.dense_reward,
                     augment=cfg.env.augment,
                     reset_pool=cfg.env.reset_pool)
    generator = torch.Generator(device=dev).manual_seed(cfg.seed)
    bs = env.reset(generator, cfg.env.n_envs)
    if group is not None:
        bs = shard_block(bs, dist.get_world_size(group), dist.get_rank(group))
    params = agent.init_fn(torch.Generator().manual_seed(cfg.seed)).to(dev)
    return PPORun(cfg=cfg, env=env, agent=agent, params=params,
                  opt=make_optimizer(params, cfg.ppo), generator=bs.generator,
                  bs=bs, n_steps=cfg.env.episode_limit or 100, group=group)


class _Marks:
    """Time marks on the device's clock: CUDA events on a card, the host
    clock on the CPU.  Reading them waits for the device."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: List = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def ms(self) -> List[float]:
        """Milliseconds between consecutive marks."""
        if self.cuda:
            self.marks[-1].synchronize()
            return [a.elapsed_time(b)
                    for a, b in zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def ppo_iteration(run: PPORun
                  ) -> Tuple[Trajectory, Dict[str, torch.Tensor], _Marks]:
    """One rollout of ``run.n_steps`` steps, GAE and the PPO update.
    Returns the trajectory, the statistics (device tensors) and the marks
    before the rollout, between rollout and update, and after the update.
    The batch carries the aux targets when the loss uses them (an agent
    with ``aux_fn`` and ``aux_coeff > 0``).  Under ``run.group`` each rank
    rolls out its own envs and the update and the statistics are the
    data-parallel ones."""
    with TRACE.span("iteration"):
        cfg = run.cfg
        marks = _Marks(run.bs.env.device)
        marks.mark()
        run.bs, traj, last_v = rollout(run.env, run.bs, run.params,
                                       run.generator, run.n_steps, run.agent)
        include_aux = cfg.ppo.aux_coeff > 0.0 \
            and run.agent.aux_fn is not None
        with TRACE.span("learner_batch"):
            batch = batch_from_trajectory(traj, last_v, cfg.ppo,
                                          include_aux=include_aux,
                                          group=run.group)
        marks.mark()
        stats = train_step(run.params, run.opt, batch, run.generator,
                           run.agent, cfg.ppo, group=run.group,
                           rollout_steps=run.n_steps)
        marks.mark()
        stats["episode_reward_mean"] = traj.rewards.sum(0).mean()
        # success = a true termination before truncation
        stats["success_rate"] = traj.terminated.any(0).to(
            torch.float32).mean()
        if run.group is not None:
            names = ("episode_reward_mean", "success_rate")
            both = torch.stack([stats[k] for k in names])
            dist.all_reduce(both, group=run.group)
            both = both / dist.get_world_size(run.group)
            stats.update(zip(names, both.unbind()))
        return traj, stats, marks


def _checkpoint(run: PPORun, i: int) -> Dict:
    return {"params": run.params.state_dict(),
            "opt_state": run.opt.state_dict(),
            "generator": run.generator.get_state(), "iteration": i}


def run_ppo(cfg: RunConfig, logger: MetricLogger, resume: bool = False,
            on_iteration: Optional[Callable] = None) -> nn.Module:
    """Train for ``cfg.total_iterations`` iterations and return the policy.

    Each logged line carries the loss statistics, env-steps/s including
    the learner and ``rollout_ms`` / ``update_ms`` on the device's clock.
    ``resume`` restores the latest checkpoint of ``cfg.checkpoint_dir``
    (policy, optimizer, generator, iteration) and continues after it.
    ``on_iteration(i, run, traj, stats)`` is called after each
    iteration."""
    run = setup_ppo(cfg)
    ckpt = Checkpointer(cfg.checkpoint_dir)
    start = 0
    if resume:
        restored = ckpt.restore(map_location="cpu")
        if restored is not None:
            run.params.load_state_dict(restored["params"])
            run.opt.load_state_dict(restored["opt_state"])
            run.generator.set_state(restored["generator"])
            start = int(restored["iteration"]) + 1
            print(f"resumed from iteration {start - 1}", file=sys.stderr)
    thr = Throughput()
    for i in range(start, cfg.total_iterations):
        traj, stats, marks = ppo_iteration(run)
        rate = thr.tick(cfg.env.n_envs * run.n_steps, stats["total_loss"])
        if i % cfg.log_every == 0:
            stats["rollout_ms"], stats["update_ms"] = marks.ms()
            stats["env_steps_per_s"] = rate
            logger.log(i, stats)
        if i % 50 == 0:
            # stderr heartbeat
            print(f"[iter {i}] loss={float(stats['total_loss']):.4f} "
                  f"success={float(stats['success_rate']):.3f} "
                  f"{rate:,.0f} steps/s", file=sys.stderr, flush=True)
        if cfg.checkpoint_every and i % cfg.checkpoint_every == 0:
            ckpt.save(i, _checkpoint(run, i))
        if on_iteration is not None:
            on_iteration(i, run, traj, stats)
    return run.params


def _emaml_checkpoint(st: EMAMLState, generator: torch.Generator, i: int,
                      rank_generators: Optional[List] = None) -> Dict:
    """The run's state after meta-iteration ``i``; under a group
    ``rank_generators`` holds every rank's rollout generator state."""
    out = {"params": st.params.state_dict(),
           "opt_state": st.opt.state_dict(), "kl_coeffs": st.kl_coeffs,
           "generator": generator.get_state(),
           "state_generator": st.generator.get_state(),
           "tasks_covered": st.tasks_covered,
           "tasks_succeeded": st.tasks_succeeded, "iteration": i}
    if rank_generators is not None:
        out["state_generators"] = rank_generators
    return out


def _save_successful(cfg: RunConfig, i: int, metrics: Dict,
                     post_batch) -> None:
    """Pickle the post-adaptation batch of every task solved in iteration
    ``i`` (train.py:126-128): ``<ckpt>/successful/epoch<i>_<task>.pickle``
    holding ``{"task_idx", "batch": {field: numpy array or None}}``, the
    JAX package's format.  The batch leaves the device only on a solve."""
    success = metrics["once_successful"].cpu().numpy()
    if not success.any():
        return
    task_ids = metrics["sampled_tasks"].cpu().numpy()
    sdir = os.path.join(cfg.checkpoint_dir, "successful")
    os.makedirs(sdir, exist_ok=True)
    for ti in np.nonzero(success)[0]:
        b = {k: None if v is None else v[ti].cpu().numpy()
             for k, v in post_batch._asdict().items()}
        with open(os.path.join(sdir, f"epoch{i}_{int(task_ids[ti])}.pickle"),
                  "wb") as fp:
            pickle.dump({"task_idx": int(task_ids[ti]), "batch": b}, fp)


def run_emaml(cfg: RunConfig, logger: MetricLogger, resume: bool = False,
              on_iteration: Optional[Callable] = None,
              profile: bool = False, group=None) -> nn.Module:
    """E-MAML for ``cfg.total_iterations`` meta-iterations; returns the
    policy holding the meta-parameters.

    Every meta-iteration draws a fresh task assignment (emaml.py:349-361)
    and builds its env with those tasks pinned per env.  ``cfg.emaml.
    chunked`` takes the decomposed FOMAML step, else the fused one.  Each
    logged line has the reference's wandb keys and the per-task arrays;
    ``profile`` adds the chunked step's ``unit_times``.  A checkpoint holds
    the params, the AdamW state, ``kl_coeffs``, both generators' states
    (task draws and resets; rollouts), ``tasks_covered`` /
    ``tasks_succeeded`` and the iteration; ``resume`` continues after the
    latest.  ``on_iteration(i, state, metrics)`` is called after each
    meta-iteration.

    With a data-parallel ``group`` the tasks are laid out over its ranks
    (:func:`parallel.mesh.task_layout`): every rank draws the same
    assignment (checked once against the first rank's), resets the whole
    env batch and keeps its rows, with its own rollout generator
    (:func:`parallel.mesh.rank_generator`), and runs the step under the
    group; the group's first rank alone logs and writes the pickles and
    checkpoints (every rank's rollout generator state included)."""
    ecfg = cfg.emaml
    agent = build_agent(cfg)
    dev = resolve_device(cfg.device)
    table = make_table(cfg.env)
    bank = make_loader(cfg.env).bank(device=dev)
    n_bank = int(bank.n_tasks)
    layout = task_layout(ecfg.n_tasks, ecfg.envs_per_task, group)
    lead = layout.index == 0
    st = init_emaml(agent, ecfg, cfg.seed, n_bank_tasks=n_bank, device=dev)
    if layout.size > 1:
        st.generator = rank_generator(st.generator, layout.index)
    generator = torch.Generator(device=dev).manual_seed(cfg.seed + 1)
    if ecfg.chunked:
        step = make_chunked_train_step(agent, ecfg, profile=profile,
                                       group=layout)
    else:
        step = lambda st_, env_, bs_: emaml_train_step(st_, env_, bs_, agent,
                                                        ecfg, group=layout)

    ckpt = Checkpointer(cfg.checkpoint_dir)
    start = 0
    if resume:
        restored = ckpt.restore(map_location="cpu")
        if restored is not None:
            st.params.load_state_dict(restored["params"])
            st.opt.load_state_dict(restored["opt_state"])
            st.kl_coeffs = restored["kl_coeffs"].to(dev)
            generator.set_state(restored["generator"])
            # the rollouts' own draws: without them a resumed run replays
            # iteration 0's exploration noise
            st.generator.set_state(
                restored["state_generator"] if group is None
                else restored["state_generators"][layout.index])
            st.tasks_covered = restored["tasks_covered"].to(dev)
            st.tasks_succeeded = restored["tasks_succeeded"].to(dev)
            start = int(restored["iteration"]) + 1
            if lead:
                print(f"resumed from iteration {start - 1}", file=sys.stderr)
    n_envs = ecfg.n_tasks * ecfg.envs_per_task
    t_iter = time.perf_counter()
    for i in range(start, cfg.total_iterations):
        assign = sample_task_assignment(generator, n_bank, ecfg)
        if group is not None and i == start:
            first = assign.clone()
            dist.broadcast(first, dist.get_global_rank(group, 0),
                           group=group)
            if not torch.equal(first, assign):
                raise RuntimeError(
                    f"run_emaml: rank {layout.index} drew the tasks "
                    f"{assign.tolist()}, the first rank {first.tolist()}")
        opts = ResetOptions.make(prob_index=assign, subprob_index=-1,
                                 adaptation=True, reset_on_submit=False,
                                 device=dev)
        env = BatchedEnv(table=table, bank=bank,
                         max_trial=cfg.env.max_trial,
                         episode_limit=cfg.env.episode_limit,
                         auto_reset=True, dense_reward=cfg.env.dense_reward,
                         augment=cfg.env.augment, opts=opts,
                         reset_pool=cfg.env.reset_pool)
        bs = env.reset(generator, n_envs)
        if layout.size > 1:
            # this rank's rows of the state, the slot-major pool and the
            # per-env options alike, so its envs reset onto its tasks
            bs = shard_block(bs, layout.size, layout.index)
            env = dataclasses.replace(env, opts=shard_block(
                env.opts, layout.size, layout.index))
        st, bs, metrics = step(st, env, bs)
        post_batch = metrics.pop("post_batch")
        if group is not None and bool(metrics["once_successful"].any()):
            post_batch = all_task_rows(layout, post_batch,
                                       ecfg.rollout_steps)
        if lead:
            # wandb schema keys (train.py:130-150)
            logged = {
                "total_loss": metrics["meta_loss"],
                "outer_policy_loss": metrics["outer_policy_loss"],
                "outer_vf_loss": metrics["outer_vf_loss"],
                "outer_kl_loss": metrics["outer_kl_loss"],
                "outer_total_loss": metrics["outer_total_loss"],
                "adapt_eprewmax": metrics["adapt_reward_max"],
                "adapt_eprewmean": metrics["adapt_reward_mean"],
                "adapt_eprewmin": metrics["adapt_reward_min"],
                "post_eprewmax": metrics["post_eprew_max"],
                "post_eprewmean": metrics["post_eprew_mean"],
                "post_eprewmin": metrics["post_eprew_min"],
                "num_covered_tasks": metrics["num_covered_tasks"],
                "num_succeed_tasks": metrics["num_succeed_tasks"],
                "kl": metrics["inner_kl_mean"],
                # per-task arrays, so a run log alone tells which tasks
                # solved
                "sampled_tasks": metrics["sampled_tasks"],
                "once_successful": metrics["once_successful"].to(
                    torch.int32),
                "post_reward_per_task": metrics["post_reward_per_task"],
            }
            if "unit_times" in metrics:
                logged["unit_times"] = metrics["unit_times"]
            logger.log(i, logged)
            # stderr heartbeat: liveness signal for supervise.py and humans
            now = time.perf_counter()
            print(f"[iter {i}] meta_loss={float(metrics['meta_loss']):.4f} "
                  f"post_eprew={float(metrics['post_eprew_mean']):.3f} "
                  f"({now - t_iter:.1f}s)", file=sys.stderr, flush=True)
            t_iter = now
            _save_successful(cfg, i, metrics, post_batch)
        if cfg.checkpoint_every and i % cfg.checkpoint_every == 0:
            rank_generators = None
            if group is not None:
                rank_generators = [None] * layout.size
                dist.all_gather_object(rank_generators,
                                       st.generator.get_state(), group=group)
            if lead:
                ckpt.save(i, _emaml_checkpoint(st, generator, i,
                                               rank_generators))
        if on_iteration is not None:
            on_iteration(i, st, metrics)
    return st.params


def run_config(cfg: RunConfig, args: argparse.Namespace,
               argv=None) -> nn.Module:
    """Log the config and its provenance, then run ``cfg.algo``."""
    print(cfg.to_json(), file=sys.stderr)
    logger = MetricLogger(args.log_file)
    try:
        log_provenance(logger, cfg, argv)
        run = run_ppo if cfg.algo == "ppo" else run_emaml
        return run(cfg, logger, resume=args.resume)
    finally:
        logger.close()


def parse_config(argv=None) -> Tuple[RunConfig, argparse.Namespace]:
    ap = argparse.ArgumentParser(
        prog="python -m arcle_tpu_torch.training.train")
    ap.add_argument("--algo", default="emaml", choices=["ppo", "emaml"])
    ap.add_argument("--model", default="mlp", choices=["mlp", "gpt"])
    ap.add_argument("--iterations", type=int, default=1000)
    ap.add_argument("--n-envs", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dataset", default="synthetic")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="MLP torso compute dtype (bfloat16: the torso on the "
                         "tensor cores, float32 parameters and heads)")
    ap.add_argument("--log-file", default="train_log.jsonl")
    ap.add_argument("--ckpt-dir", default="./ckpts")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine and the learner")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shapes for a quick end-to-end check")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest checkpoint in --ckpt-dir and "
                         "continue")
    args = ap.parse_args(argv)
    common = dict(seed=args.seed, algo=args.algo, model=args.model,
                  total_iterations=args.iterations,
                  checkpoint_dir=args.ckpt_dir, device=args.device,
                  mlp_dtype=args.dtype)
    if args.smoke:
        cfg = RunConfig(
            checkpoint_every=1,
            env=EnvConfig(family="o2arc_crop33", max_trial=7,
                          episode_limit=10, n_envs=32,
                          dataset=args.dataset, n_synthetic_tasks=8),
            emaml=EMAMLConfig(n_tasks=2, envs_per_task=4, rollout_steps=10,
                              inner_steps=2, maml_opt_steps=1),
            mlp_hidden=(128, 64), **common)
    else:
        cfg = RunConfig(env=EnvConfig(family="o2arc_crop33",
                                      n_envs=args.n_envs,
                                      dataset=args.dataset), **common)
    return cfg, args


def main(argv=None) -> nn.Module:
    cfg, args = parse_config(argv)
    return run_config(cfg, args, argv)


if __name__ == "__main__":
    main()
