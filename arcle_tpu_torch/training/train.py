"""PPO training entry point.

Counterpart of the PPO half of ``arcle_tpu/training/train.py``: the
CustomO2ARC-style env (CropGrid at op 33, augmentation, dense shaped
reward, max_trial=127, TimeLimit 100), the MLP policy
[1024,1024,512,512,256,128] tanh over the FilterO2ARC + Flatten obs,
BBox-tuple action heads and plain PPO; checkpoints every N iterations and
JSONL metric logging with the reference's wandb schema.

Run:  python -m arcle_tpu_torch.training.train --algo ppo --model mlp \\
          --device cuda --iterations 100

``--device cuda`` without a CUDA card raises; nothing falls back to the
CPU.  E-MAML (``--algo emaml``), the GPT policy (``--model gpt``) and the
bf16 torso (``--dtype bfloat16``) are not ported yet and raise.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..envs import BatchedEnv
from ..envs.core import BatchedState
from ..models.mlp import FCPolicy
from ..utils.checkpoint import Checkpointer
from ..utils.config import RunConfig, EnvConfig, make_table, make_loader
from ..utils.metrics import MetricLogger, Throughput
from .agents import Agent, mlp_agent
from .ppo import batch_from_trajectory, make_optimizer, train_step
from .rollout import Trajectory, rollout


def check_ported(cfg: RunConfig) -> None:
    """Raise for a configuration the port cannot run yet."""
    if cfg.algo != "ppo":
        raise NotImplementedError(f"algo={cfg.algo}: E-MAML is not ported "
                                  "yet (ROADMAP.md queue 1 item 11)")
    if cfg.model != "mlp":
        raise NotImplementedError(f"model={cfg.model}: the GPT policy is not "
                                  "ported yet (ROADMAP.md queue 1 item 10)")
    if cfg.mlp_dtype != "float32":
        raise NotImplementedError(
            f"mlp_dtype={cfg.mlp_dtype}: only the float32 MLP is ported "
            "(the bf16 torso is queued in ROADMAP.md queue 1 item 7)")


def resolve_device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name}: CUDA is not available (the "
                           "trainer does not fall back to the CPU)")
    return dev


def build_agent(cfg: RunConfig) -> Agent:
    check_ported(cfg)
    return mlp_agent(FCPolicy(hidden=tuple(cfg.mlp_hidden),
                              n_ops=make_table(cfg.env).n_ops))


def log_provenance(logger: MetricLogger, cfg: RunConfig, argv=None) -> None:
    """One JSONL header line per run record: config, git sha, argv."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    try:
        proc = subprocess.run(["git", "-C", repo, "rev-parse", "--short",
                               "HEAD"], capture_output=True, text=True,
                              timeout=10)
        sha = proc.stdout.strip() if proc.returncode == 0 else ""
    except (OSError, subprocess.SubprocessError):
        sha = ""
    logger.meta({"config": json.loads(cfg.to_json()),
                 "git_sha": sha or "unknown",
                 "argv": list(argv) if argv else sys.argv[1:]})


@dataclasses.dataclass
class PPORun:
    """Everything a PPO run carries from one iteration to the next.  The
    generator (on the device) draws the env resets, the reset pools, the
    actions and the minibatch shuffles."""

    cfg: RunConfig
    env: BatchedEnv
    agent: Agent
    params: FCPolicy
    opt: torch.optim.Optimizer
    generator: torch.Generator
    bs: BatchedState
    n_steps: int


def setup_ppo(cfg: RunConfig) -> PPORun:
    """Env, policy and optimizer on ``cfg.device``.  The weights are drawn
    on the CPU from ``cfg.seed``, so a seed gives the same weights on
    every device."""
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
    params = agent.init_fn(torch.Generator().manual_seed(cfg.seed)).to(dev)
    return PPORun(cfg=cfg, env=env, agent=agent, params=params,
                  opt=make_optimizer(params, cfg.ppo), generator=generator,
                  bs=bs, n_steps=cfg.env.episode_limit or 100)


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
    before the rollout, between rollout and update, and after the update."""
    cfg = run.cfg
    marks = _Marks(run.bs.env.device)
    marks.mark()
    run.bs, traj, last_v = rollout(run.env, run.bs, run.params,
                                   run.generator, run.n_steps, run.agent)
    batch = batch_from_trajectory(traj, last_v, cfg.ppo)
    marks.mark()
    stats = train_step(run.params, run.opt, batch, run.generator, run.agent,
                       cfg.ppo)
    marks.mark()
    stats["episode_reward_mean"] = traj.rewards.sum(0).mean()
    # success = a true termination before truncation
    stats["success_rate"] = traj.terminated.any(0).to(torch.float32).mean()
    return traj, stats, marks


def _checkpoint(run: PPORun, i: int) -> Dict:
    return {"params": run.params.state_dict(),
            "opt_state": run.opt.state_dict(),
            "generator": run.generator.get_state(), "iteration": i}


def run_ppo(cfg: RunConfig, logger: MetricLogger, resume: bool = False,
            on_iteration: Optional[Callable] = None) -> FCPolicy:
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


def parse_config(argv=None) -> Tuple[RunConfig, argparse.Namespace]:
    ap = argparse.ArgumentParser(
        prog="python -m arcle_tpu_torch.training.train")
    ap.add_argument("--algo", default="ppo", choices=["ppo", "emaml"])
    ap.add_argument("--model", default="mlp", choices=["mlp", "gpt"])
    ap.add_argument("--iterations", type=int, default=1000)
    ap.add_argument("--n-envs", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dataset", default="synthetic")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="MLP torso compute dtype (only float32 is ported)")
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
            mlp_hidden=(128, 64), **common)
    else:
        cfg = RunConfig(env=EnvConfig(family="o2arc_crop33",
                                      n_envs=args.n_envs,
                                      dataset=args.dataset), **common)
    return cfg, args


def main(argv=None) -> FCPolicy:
    cfg, args = parse_config(argv)
    print(cfg.to_json(), file=sys.stderr)
    logger = MetricLogger(args.log_file)
    try:
        log_provenance(logger, cfg, argv)
        return run_ppo(cfg, logger, resume=args.resume)
    finally:
        logger.close()


if __name__ == "__main__":
    main()
