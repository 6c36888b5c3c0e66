"""Multi-rank dry run: one data- and tensor-parallel PPO iteration.

Counterpart of ``__graft_entry__.py::dryrun_multichip``.  ``n`` ranks form
a ``(data, model)`` mesh with a model axis of 2 where ``n >= 4`` is even
(else 1).  The GPT policy at the flagship widths (width 128, 16 heads; 2
layers on the CPU as in JAX, all 8 of ``GPTConfig()`` on the card) drives
``2 * n_data`` O2ARCv2 envs for T=3 steps and one full-batch PPO update:
the envs sharded over ``data``, the wide kernels (``qkv`` [128, 384],
``Dense_0`` [128, 512]) column-parallel over ``model``.  Every rank
launches the step kernel (on the card) once per rollout step.

    python -m arcle_tpu_torch.parallel.dryrun --n 4 --device cpu
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import torch
import torch.distributed as dist

T = 3


def _check_placement(params, n_model: int) -> str:
    """The wide kernels hold ``1 / n_model`` of their rows; a head's last
    layer is whole."""
    from .mesh import is_tp_sharded

    blk = params.block_0
    qkv, mlp = blk.SelfAttention_0.qkv.weight, blk.Dense_0.weight
    crit = params.head_critic.Dense_2.weight
    if not (is_tp_sharded(qkv) and qkv.shape[0] == 384 // n_model):
        raise AssertionError(f"dryrun: qkv {tuple(qkv.shape)} not sharded")
    if not (is_tp_sharded(mlp) and mlp.shape[0] == 512 // n_model):
        raise AssertionError(f"dryrun: Dense_0 {tuple(mlp.shape)} not "
                             "sharded")
    if is_tp_sharded(crit):
        raise AssertionError("dryrun: head_critic.Dense_2 is sharded")
    return f"qkv {tuple(qkv.shape)}, Dense_0 {tuple(mlp.shape)} per rank"


def dryrun_rank(device: str) -> dict:
    """The dry run on this rank of the current process group.  Returns the
    loss, the step-kernel launches, the envs per rank and the update's
    milliseconds."""
    from ..envs import BatchedEnv
    from ..loaders import SyntheticLoader
    from ..models.gpt import GPTConfig, GPTPolicy
    from ..ops import o2arc_table, step_kernel
    from ..training.agents import gpt_agent
    from ..training.ppo import PPOConfig, make_optimizer
    from ..training.train import PPORun, ppo_iteration
    from ..utils.config import RunConfig
    from .mesh import axis_size, data_model_mesh, shard_leading, \
        shard_params_tp

    n = dist.get_world_size()
    n_model = 2 if n >= 4 and n % 2 == 0 else 1
    mesh = data_model_mesh(n_model, device_type=device)
    n_data = axis_size(mesh, "data")
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if device == "cuda" else torch.device("cpu")
    B = 2 * n_data
    cfg = PPOConfig(n_epochs=1, n_minibatches=1)
    gcfg = GPTConfig() if device == "cuda" else GPTConfig(n_layer=2)
    params = GPTPolicy(gcfg, torch.Generator().manual_seed(1)).to(dev)
    env = BatchedEnv(table=o2arc_table(max_trial=3),
                     bank=SyntheticLoader(4, seed=0).bank(device=dev),
                     max_trial=3, episode_limit=10, auto_reset=True)
    bs = shard_leading(env.reset(torch.Generator(device=dev).manual_seed(0),
                                 B), mesh, "data")
    params = shard_params_tp(params, mesh, "model")
    if n_model > 1:
        where = _check_placement(params, n_model)
    run = PPORun(cfg=RunConfig(ppo=cfg, device=device), env=env,
                 agent=gpt_agent(params), params=params,
                 opt=make_optimizer(params, cfg), generator=bs.generator,
                 bs=bs, n_steps=T, group=mesh.get_group("data"))
    launches = step_kernel.LAUNCHES
    _, stats, marks = ppo_iteration(run)
    loss = float(stats["total_loss"])
    launches = step_kernel.LAUNCHES - launches
    if not math.isfinite(loss):
        raise AssertionError(f"dryrun: loss {loss}")
    if run.bs.batch != B // n_data:
        raise AssertionError(f"dryrun: {run.bs.batch} envs on a rank, not "
                             f"{B // n_data}")
    if n_model > 1:
        _check_placement(params, n_model)
    if dist.get_rank() == 0:
        print(f"mesh: data={n_data} model={n_model}, {B // n_data} envs per "
              f"rank, GPT {gcfg.n_layer}L/{gcfg.n_head}H/{gcfg.n_embd}E on "
              f"{device}")
        if n_model > 1:
            print(f"TP shardings: {where}, head_critic.Dense_2 whole")
        print(f"dryrun_multichip({n}): one sharded PPO step OK, "
              f"loss={loss:.4f}", flush=True)
    return {"loss": loss, "launches": launches, "envs_per_rank": B // n_data,
            "update_ms": marks.ms()[1]}


def _rank_main(device: str) -> None:
    out = dryrun_rank(device)
    if dist.get_rank() == 0:
        print("DRYRUN " + json.dumps(out), flush=True)


def dryrun_multichip(n: int, device: str = "cuda",
                     report: bool = True) -> dict:
    """One sharded PPO iteration on ``n`` ranks, then (``report``) the
    scaling report for the rank counts up to ``n``, its update period
    this dry run's own update.

    Inside a process group of ``n`` ranks every rank runs it in place;
    ``n == 1`` without a group runs it in this process under a group of
    one; otherwise ``n`` ranks are spawned (NCCL on the card, Gloo on the
    CPU).  Returns (rank 0's) loss, step-kernel launches, envs per rank
    and update milliseconds."""
    from .launch import free_port, spawn
    from .multihost import init_multihost

    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise ValueError(f"dryrun_multichip({n}) inside a group of "
                             f"{dist.get_world_size()}")
        out = dryrun_rank(device)
    elif n == 1:
        init_multihost(f"127.0.0.1:{free_port()}", 1, 0, timeout_s=60.0,
                       device=device)
        try:
            out = dryrun_rank(device)
        finally:
            dist.destroy_process_group()
    else:
        lines = spawn("arcle_tpu_torch.parallel.dryrun:_rank_main", n, device,
                      (device,), timeout_s=900.0)[0].splitlines()
        print("\n".join(x for x in lines if not x.startswith("DRYRUN ")))
        out = json.loads(next(x for x in lines
                              if x.startswith("DRYRUN "))[len("DRYRUN "):])
    if report:
        from .scaling import scaling_report
        scaling_report([d for d in (1, 2, 4, 8) if d <= n],
                       update_period_s=out["update_ms"] / 1e3,
                       period_source=f"this dry run's update ({device})",
                       device=device)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m arcle_tpu_torch.parallel."
                                      "dryrun")
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
