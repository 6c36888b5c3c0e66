"""E-MAML meta-RL learner.

Counterpart of ``arcle_tpu/training/emaml.py`` (the reference's Ray-based
EMAML, emaml.py:329-527, and its MAMLLoss, emaml_policy.py:141-281):

* tasks map onto slices of the lockstep env batch (one ``prob_index`` per
  task, pinned through per-env ResetOptions); :func:`task_rollout` runs
  each task's policy on its slice with its own parameters and steps all
  ``n_tasks * envs_per_task`` envs together, so every rollout step is one
  ``BatchedEnv.step`` (one step-kernel launch on CUDA);
* inner adaptation = per-task SGD on the unclipped surrogate
  (WorkerLoss, emaml_policy.py:101-137); per-task parameters are
  name -> tensor mappings that the agents run through
  ``torch.func.functional_call``;
* the meta update differentiates through the replayed inner SGD chain on
  the stored inner batches and applies the clipped PPO loss on the
  post-adaptation batch (MAMLLoss); ``first_order=False`` differentiates
  through the inner gradients (``create_graph=True``), ``first_order=True``
  stops them (FOMAML);
* the per-task, per-step inner KL coefficient ladder follows KLCoeffMixin
  (emaml_policy.py:284-299); the meta optimizer is AdamW with the weight
  decay passed explicitly (``optax.adamw``'s, applied to every parameter).

:func:`emaml_train_step` is the fused step; :func:`make_chunked_train_step`
is the decomposed FOMAML step of train_gpt's path, with the
``cache_chain`` and ``kl_ladder_grads=False`` options that change its
numbers.  In eager PyTorch both are host loops over the same functions;
the JAX package's reasons for chunking (a TPU runtime's limit on one
program's duration) do not apply, its semantics do.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.state import I32
from ..envs.core import BatchedEnv, BatchedState
from ..parallel.mesh import TaskLayout, task_layout
from .agents import Agent
from .ppo import PPOConfig, PPOBatch, _all_reduce_grads, \
    batch_from_trajectory, ppo_loss, surrogate_loss
from .rollout import Trajectory, rollout

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class EMAMLConfig:
    """Defaults follow train.py:43-102 scaled to fit on-device."""

    n_tasks: int = 10               # num_workers in the reference
    envs_per_task: int = 10
    rollout_steps: int = 100        # rollout_fragment_length
    inner_steps: int = 5            # inner_adaptation_steps (ref: 20)
    maml_opt_steps: int = 5         # maml_optimizer_steps
    inner_lr: float = 1e-3
    meta_lr: float = 1e-4
    weight_decay: float = 1e-5      # AdamW meta-opt (emaml_policy.py:330-339)
    first_order: bool = False
    kl_target: float = 0.01         # inner_adaptation_kl_target
    n_micro: int = 1                # >1: every per-task batch evaluation
                                    # (inner grads, KL terms, outer PPO
                                    # loss) is a mean over n_micro
                                    # micro-batches, each checkpointed where
                                    # a later backward needs it, so
                                    # activations of one micro-batch at a
                                    # time are held
    chunked: bool = False           # the decomposed FOMAML step
                                    # (make_chunked_train_step); requires
                                    # first_order=True
    cache_chain: bool = False       # chunked only: replay the inner chain
                                    # once (it is the inner-adaptation
                                    # pass) and transport the adapted
                                    # deltas through the later meta-opt
                                    # steps; exact for the first meta-opt
                                    # step, first-order close after
    kl_ladder_grads: bool = True    # False: the ladder KLs come from the
                                    # surrogate gradient's own forward and
                                    # the KL-ladder gradient term (~1e-7 of
                                    # the loss) is dropped from the meta
                                    # gradient
    ppo: PPOConfig = dataclasses.field(default_factory=PPOConfig)


@dataclasses.dataclass
class EMAMLState:
    """What E-MAML carries across meta-iterations.  ``params`` is the
    policy module holding the meta-parameters, ``opt`` its AdamW, and
    ``generator`` (on the policy's device) draws the rollouts."""

    params: nn.Module
    opt: torch.optim.Optimizer
    kl_coeffs: torch.Tensor       # f32 [n_tasks, inner_steps] KL ladder
    generator: torch.Generator
    # success bookkeeping across meta-iterations (the reference's
    # tasks_covered / succeed accumulators, train.py:106-108,118-121)
    tasks_covered: torch.Tensor   # i32 [n_bank_tasks] times sampled
    tasks_succeeded: torch.Tensor # i32 [n_bank_tasks] times solved


def make_meta_optimizer(params: nn.Module, cfg: EMAMLConfig
                        ) -> torch.optim.AdamW:
    """``optax.adamw(meta_lr, weight_decay=weight_decay)``: the same betas
    and eps, decoupled decay of every parameter."""
    return torch.optim.AdamW(params.parameters(), lr=cfg.meta_lr,
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=cfg.weight_decay)


def init_emaml(agent: Agent, cfg: EMAMLConfig, seed: int,
               n_bank_tasks: int = 1, device="cuda") -> EMAMLState:
    """Weights drawn on the CPU from ``seed`` (the same on every device),
    moved to ``device``; the rollout generator seeded there."""
    params = agent.init_fn(torch.Generator().manual_seed(seed)).to(device)
    return EMAMLState(
        params=params, opt=make_meta_optimizer(params, cfg),
        kl_coeffs=torch.full((cfg.n_tasks, cfg.inner_steps), 0.0005,
                             device=device),
        generator=torch.Generator(device=device).manual_seed(seed),
        tasks_covered=torch.zeros((n_bank_tasks,), dtype=I32, device=device),
        tasks_succeeded=torch.zeros((n_bank_tasks,), dtype=I32,
                                    device=device))


def meta_params(module: nn.Module) -> Params:
    return dict(module.named_parameters())


def _leaves(p: Params) -> Params:
    """Detached copies that track gradients: the start of a unit that
    differentiates with respect to ``p`` alone."""
    return {k: v.detach().requires_grad_() for k, v in p.items()}


def _grads(loss: torch.Tensor, params: Params,
           create_graph: bool = False) -> Params:
    """d loss / d params, zeros for parameters the loss does not reach
    (as ``jax.grad`` gives)."""
    gs = torch.autograd.grad(loss, list(params.values()),
                             create_graph=create_graph, allow_unused=True)
    return {k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(params.items(), gs)}


def _tree(fn: Callable, *trees):
    """``fn`` leaf by leaf over tensors, tuples and dicts of one shape."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, tuple):
        return tuple(_tree(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _microbatches(batch: PPOBatch, n: int) -> List[PPOBatch]:
    """``[N, ...]`` rows -> ``n`` consecutive micro-batches of ``N // n``."""
    N = batch.obs.shape[0]
    if N % n:
        raise ValueError(
            f"per-task batch size {N} (rollout_steps*envs_per_task) is "
            f"not divisible by n_micro={n}")
    m = N // n
    return [batch.take(slice(i * m, (i + 1) * m)) for i in range(n)]


def _accumulated(fn: Callable, batch: PPOBatch, n: int,
                 recompute: bool = True):
    """``mean_over_micros(fn(micro))`` (``fn(batch)`` for ``n <= 1``).
    With ``recompute``, where gradients are recorded, each micro-batch
    runs under ``checkpoint``: a later backward recomputes one micro-batch
    at a time, so the activations held never exceed a single
    micro-batch's.  An ``fn`` that takes its own gradients frees each
    micro-batch's graph itself and needs no recomputation."""
    if n <= 1:
        return fn(batch)
    total = None
    for mb in _microbatches(batch, n):
        out = checkpoint(fn, mb, use_reentrant=False) \
            if recompute and torch.is_grad_enabled() else fn(mb)
        total = out if total is None else _tree(torch.add, total, out)
    return _tree(lambda x: x / n, total)


def _task_mean(grads: Params, task_group) -> Params:
    """The mean over a split task's ranks of their gradients, each of its
    rank's mean over an equal share of the task's rows: the gradient of
    the task's mean, the same on every rank of the task.  One all-reduce
    of a flat buffer, differentiable (second-order E-MAML differentiates
    through it; ``dist.all_reduce`` would cut the graph silently)."""
    flat = torch.cat([g.reshape(-1) for g in grads.values()])
    flat = dist_nn.all_reduce(flat, group=task_group) \
        / dist.get_world_size(task_group)
    parts = flat.split([g.numel() for g in grads.values()])
    return {k: part.view_as(g) for (k, g), part in zip(grads.items(), parts)}


def _surrogate_grads(params: Params, batch: PPOBatch, cfg: EMAMLConfig,
                     agent: Agent, create_graph: bool = False,
                     task_group=None) -> Params:
    """d surrogate / d params, the mean over micro-batches; the graph of
    each is kept only with ``create_graph``.  A split task's ``task_group``
    makes it the gradient of the mean over all the task's rows."""
    g = _accumulated(
        lambda mb: _grads(surrogate_loss(params, agent, mb, cfg.ppo), params,
                          create_graph), batch, cfg.n_micro, recompute=False)
    return g if task_group is None else _task_mean(g, task_group)


def _surrogate_and_kl(params: Params, batch: PPOBatch, cfg: EMAMLConfig,
                      agent: Agent, task_group=None
                      ) -> Tuple[Params, torch.Tensor]:
    """(d surrogate / d params, inner KL) from ONE evaluate forward per
    micro-batch: the ``kl_ladder_grads=False`` fast path, where the KL
    value rides on the surrogate's pass instead of paying its own
    backward.  Under a split task's ``task_group`` the gradient is the
    task's and the KL this rank's share of it (:func:`_share`)."""
    def one(mb):
        lp, value, _ = agent.evaluate_fn(params, mb.obs, mb.actions)
        ratio = torch.exp(lp - mb.log_probs)
        policy_loss = -(ratio * mb.advantages).mean()
        vf_loss = 0.5 * ((value - mb.returns) ** 2).mean()
        return (_grads(policy_loss + cfg.ppo.vf_coeff * vf_loss, params),
                (mb.log_probs - lp).mean().detach())

    g, kl = _accumulated(one, batch, cfg.n_micro, recompute=False)
    if task_group is None:
        return g, kl
    return _task_mean(g, task_group), _share(kl, task_group)


def _share(x, task_group):
    """This rank's share of a split task's mean: its own mean over the
    task's ranks (the shares of all the task's ranks sum to the task's
    mean); ``x`` itself for a whole task.  Losses and KLs enter the meta
    gradient as shares, so each of the task's rows counts once."""
    if task_group is None:
        return x
    k = dist.get_world_size(task_group)
    return _tree(lambda v: v / k, x)


def _inner_update(params: Params, batch: PPOBatch, cfg: EMAMLConfig,
                  agent: Agent, task_group=None) -> Params:
    """One inner SGD step on the unclipped surrogate, differentiable in
    ``params``; through the inner gradient too unless ``first_order``."""
    g = _surrogate_grads(params, batch, cfg, agent,
                         create_graph=not cfg.first_order,
                         task_group=task_group)
    return {k: p - cfg.inner_lr * g[k] for k, p in params.items()}


def _adapt(params: Params, batch: PPOBatch, cfg: EMAMLConfig,
           agent: Agent, task_group=None) -> Params:
    """The inner SGD step as a value: no graph kept."""
    p = _leaves(params)
    g = _surrogate_grads(p, batch, cfg, agent, task_group=task_group)
    return {k: (v - cfg.inner_lr * g[k]).detach() for k, v in p.items()}


def _batch_kl(params: Params, batch: PPOBatch, cfg: EMAMLConfig,
              agent: Agent, task_group=None) -> torch.Tensor:
    """mean(old_logp - logp), the inner-step KL of the ladder (this rank's
    share of it under a split task's ``task_group``)."""
    def kl_of(mb):
        lp, _, _ = agent.evaluate_fn(params, mb.obs, mb.actions)
        return (mb.log_probs - lp).mean()

    return _share(_accumulated(kl_of, batch, cfg.n_micro), task_group)


def _outer_ppo_loss(params: Params, batch: PPOBatch, cfg: EMAMLConfig,
                    agent: Agent):
    """Clipped PPO loss (+stats), micro-batched when configured.  Every
    stat is a batch mean, so the micro mean-of-means is exact; the aux
    losses normalise by a batch-global count and do not decompose."""
    if cfg.n_micro > 1 and cfg.ppo.aux_coeff > 0.0 and \
            agent.aux_fn is not None and batch.rewards is not None:
        raise ValueError("aux losses are not supported with n_micro > 1 "
                         "(global-denominator aux terms don't decompose "
                         "over micro-batches)")
    return _accumulated(lambda mb: ppo_loss(params, agent, mb, cfg.ppo),
                        batch, cfg.n_micro)


def sample_task_assignment(generator: torch.Generator, n_bank_tasks: int,
                           cfg: EMAMLConfig) -> torch.Tensor:
    """Per-env prob_index row pinning one bank task per task slot, the
    tasks drawn without replacement (sample_tasks, agents/env.py:66-67)."""
    if cfg.n_tasks > n_bank_tasks:
        raise ValueError(f"{cfg.n_tasks} tasks drawn without replacement "
                         f"from a bank of {n_bank_tasks}")
    tasks = torch.randperm(n_bank_tasks, generator=generator,
                           device=generator.device)[:cfg.n_tasks]
    return tasks.repeat_interleave(cfg.envs_per_task).to(I32)


def _per_task(agent: Agent, n_tasks: int) -> Agent:
    """``agent`` over a list of ``n_tasks`` per-task params: task ``t``'s
    params act on the ``t``-th of ``n_tasks`` equal slices of the env
    batch, and the results are concatenated."""
    def cat(outs):
        return tuple(torch.cat(parts) for parts in zip(*outs))

    def sample_fn(task_params, obs, generator=None, deterministic=False,
                  u=None):
        return cat([agent.sample_fn(p, o, generator, deterministic)
                    for p, o in zip(task_params, obs.chunk(n_tasks))])

    def evaluate_fn(task_params, obs, actions):
        return cat([agent.evaluate_fn(p, o, a) for p, o, a in zip(
            task_params, obs.chunk(n_tasks), actions.chunk(n_tasks))])

    return dataclasses.replace(agent, sample_fn=sample_fn,
                               evaluate_fn=evaluate_fn, aux_fn=None)


def task_rollout(env: BatchedEnv, bs: BatchedState,
                 task_params: List[Params], generator: torch.Generator,
                 agent: Agent, cfg: EMAMLConfig, deterministic: bool
                 ) -> Tuple[BatchedState, Trajectory, torch.Tensor]:
    """``cfg.rollout_steps`` steps of every task's policy, with its own
    params, on its own slice of the env batch (the tasks of
    ``task_params``, equal slices in order); all the envs step together,
    one ``BatchedEnv.step`` per rollout step.  Returns the carry, the
    ``[steps, envs]`` trajectory and the last values."""
    return rollout(env, bs, task_params, generator, cfg.rollout_steps,
                   _per_task(agent, len(task_params)), deterministic)


def task_batches(traj: Trajectory, last_v: torch.Tensor, cfg: EMAMLConfig,
                 layout: Optional[TaskLayout] = None) -> List[PPOBatch]:
    """One PPO batch per task of ``layout``'s rank (every task without
    one), advantages normalised within the task: over all its ranks where
    the task is split."""
    layout = layout or task_layout(cfg.n_tasks, cfg.envs_per_task)
    E = layout.envs
    out = []
    for t, task_group in enumerate(layout.task_groups):
        sl = slice(t * E, (t + 1) * E)
        out.append(batch_from_trajectory(
            Trajectory(*(x[:, sl] for x in traj)), last_v[sl], cfg.ppo,
            group=task_group))
    return out


def task_rewards(traj: Trajectory, n_tasks: int) -> torch.Tensor:
    """The rewards of ``n_tasks`` equal slices of envs as ``[n_tasks,
    steps, envs]``."""
    S = traj.rewards.shape[0]
    return traj.rewards.view(S, n_tasks, -1).transpose(0, 1)


def _stack_batches(batches: List[PPOBatch]) -> PPOBatch:
    return PPOBatch(*(None if xs[0] is None else torch.stack(xs)
                      for xs in zip(*batches)))


def _mean_stats(stats: List[Dict[str, torch.Tensor]]
                ) -> Dict[str, torch.Tensor]:
    return {k: torch.stack([s[k].detach() for s in stats]).mean()
            for k in stats[0]}


def _apply_meta_grads(state: EMAMLState, group=None) -> None:
    """One AdamW step, on the sum of every rank's ``.grad`` under a
    ``group``.  A parameter the loss does not reach gets a zero gradient,
    so AdamW moves and decays it as optax does (``step`` skips parameters
    whose gradient is None)."""
    if group is not None:
        _all_reduce_grads(state.params, group)
    for p in state.params.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    state.opt.step()
    state.opt.zero_grad(set_to_none=True)


def _layout(cfg: EMAMLConfig, group) -> TaskLayout:
    """``group`` as the layout of ``cfg``'s tasks: a process group (or
    None) is laid out by :func:`task_layout`, a :class:`TaskLayout` is
    checked against ``cfg``."""
    if not isinstance(group, TaskLayout):
        return task_layout(cfg.n_tasks, cfg.envs_per_task, group)
    if (group.n_tasks, group.envs_per_task) != (cfg.n_tasks,
                                                cfg.envs_per_task):
        raise ValueError(
            f"a layout of {group.n_tasks} tasks x {group.envs_per_task} "
            f"envs for a step of {cfg.n_tasks} x {cfg.envs_per_task}")
    return group


def emaml_train_step(state: EMAMLState, env: BatchedEnv, bs: BatchedState,
                     agent: Agent, cfg: EMAMLConfig, group=None):
    """One full EMAML.training_step (emaml.py:346-527).

    ``env`` has per-env ``opts.prob_index`` pinned to the task assignment
    and ``adaptation=True``; batch = n_tasks * envs_per_task.  Updates
    ``state`` in place and returns ``(state, bs, metrics)``.

    ``group``: a data-parallel process group, or its
    :class:`~..parallel.mesh.TaskLayout` (make it once per run where the
    tasks are split: laying them out makes process groups).  ``env`` and
    ``bs`` then hold this rank's rows of the env batch
    (``layout.rows``); the rank adapts its tasks, every rank of a split
    task holding the same adapted params; the meta gradient is summed
    over the group, so every rank takes the same AdamW step and ends with
    the same params, ``kl_coeffs`` and bookkeeping; every metric is that
    of all tasks, except ``post_batch``, which holds this rank's rows."""
    layout = _layout(cfg, group)
    T, gen = cfg.n_tasks, state.generator
    tasks, task_groups = layout.tasks, layout.task_groups

    # ---- inner adaptation loop (emaml.py:367-401) ----
    task_params = [{k: v.detach() for k, v in
                    meta_params(state.params).items()}] * len(tasks)
    inner_batches, inner_rews = [], []
    for _ in range(cfg.inner_steps):
        bs, traj, last_v = task_rollout(env, bs, task_params, gen, agent,
                                        cfg, False)
        batches = task_batches(traj, last_v, cfg, layout)
        task_params = [_adapt(p, b, cfg, agent, tg)
                       for p, b, tg in zip(task_params, batches, task_groups)]
        inner_batches.append(batches)
        inner_rews.append(task_rewards(traj, len(tasks)))

    # ---- post-adaptation rollouts, explore=False (emaml.py:410-423) ----
    bs, post_traj, post_last_v = task_rollout(env, bs, task_params, gen,
                                              agent, cfg, True)
    post_batches = task_batches(post_traj, post_last_v, cfg, layout)

    # ---- meta loss: replay the inner chain differentiably (MAMLLoss);
    # one backward per task accumulates the gradient of the task mean ----
    state.opt.zero_grad(set_to_none=True)
    for _ in range(cfg.maml_opt_steps):
        params = meta_params(state.params)
        losses, kls, stats = [], [], []
        for i, tg in enumerate(task_groups):
            p, task_kls = params, []
            for step_batches in inner_batches:
                # inner-step KL term (KLCoeffMixin ladder)
                task_kls.append(_batch_kl(p, step_batches[i], cfg, agent,
                                          tg))
                p = _inner_update(p, step_batches[i], cfg, agent, tg)
            loss, st = _share(_outer_ppo_loss(p, post_batches[i], cfg,
                                              agent), tg)
            task_kls = torch.stack(task_kls)
            task_loss = loss + torch.sum(state.kl_coeffs[tasks[i]]
                                         * task_kls)
            (task_loss / T).backward()
            losses.append(task_loss.detach())
            kls.append(task_kls.detach())
            stats.append(st)
        _apply_meta_grads(state, layout.group)
    # the loss, KLs and outer stats of the last meta-opt step
    metrics = _finish_step(
        state, env, cfg, layout, torch.stack(losses), torch.stack(kls),
        stats, inner_rews, task_rewards(post_traj, len(tasks)), post_batches)
    return state, bs, metrics


def _gather(layout: TaskLayout, x: torch.Tensor) -> torch.Tensor:
    """``x`` of every rank of the layout's group, stacked in rank order."""
    parts = [torch.empty_like(x) for _ in range(layout.size)]
    dist.all_gather(parts, x.contiguous(), group=layout.group)
    return torch.stack(parts)


def _all_tasks(layout: TaskLayout, x: torch.Tensor) -> torch.Tensor:
    """``[tasks, ...]`` of this rank's tasks -> ``[n_tasks, split, ...]``
    of all tasks, on every rank (``split`` parts of a split task, one of
    a whole one)."""
    x = _gather(layout, x)
    return x.view(layout.n_tasks, layout.split, *x.shape[2:])


def all_task_envs(layout: TaskLayout, x: torch.Tensor,
                  env_dim: int) -> torch.Tensor:
    """``x`` ``[tasks, ...]`` of this rank's tasks, their envs on axis
    ``env_dim``, for all ``n_tasks`` tasks on every rank: a split task's
    envs concatenated in rank order, as the unsharded step holds them."""
    return _all_tasks(layout, x).movedim(1, env_dim).flatten(env_dim,
                                                             env_dim + 1)


def all_task_rows(layout: TaskLayout, batch: PPOBatch,
                  steps: int) -> PPOBatch:
    """A post-adaptation batch (``[tasks, steps * envs, ...]`` fields of
    this rank's tasks and rows) for all tasks, on every rank."""
    def full(x):
        x = x.view(x.shape[0], steps, layout.envs, *x.shape[2:])
        return all_task_envs(layout, x, 2).flatten(1, 2)

    return PPOBatch(*(None if x is None else full(x) for x in batch))


def _finish_step(state: EMAMLState, env: BatchedEnv, cfg: EMAMLConfig,
                 layout: TaskLayout, task_losses, inner_kls, stats,
                 inner_rews, post_rewards, post_batches) -> Dict:
    """KL-ladder update, success bookkeeping and the wandb-schema metrics
    shared by the fused and chunked steps.  Per task of this rank:
    ``task_losses`` ``[tasks]``, ``inner_kls`` ``[tasks, inner_steps]``
    and ``stats`` (a list of dicts) of the last meta-opt step, and the
    rewards of each inner rollout (a list) and of the post-adaptation
    rollout, ``[tasks, steps, envs]``.  Under a group they are gathered
    for all ``n_tasks`` tasks first, so every rank computes the same."""
    prob = env.opts.prob_index
    task_ids = prob.view(len(layout.tasks), -1)[:, 0] if prob.ndim > 0 \
        else torch.zeros((len(layout.tasks),), dtype=I32,
                         device=task_losses.device)
    if layout.group is not None:
        names = sorted(stats[0])
        shares = torch.cat([
            task_losses[:, None], inner_kls,
            torch.stack([torch.stack([s[n].detach() for s in stats])
                         for n in names], dim=1)], dim=1)
        shares = _all_tasks(layout, shares).sum(1)
        task_ids = _all_tasks(layout, task_ids.to(I32))[:, 0]
        rewards = all_task_envs(
            layout, torch.stack(inner_rews + [post_rewards], dim=1), 3)
        S = inner_kls.shape[1]
        task_losses, inner_kls = shares[:, 0], shares[:, 1:1 + S]
        stats = [dict(zip(names, row)) for row in shares[:, 1 + S:]]
        inner_rews, post_rewards = list(rewards[:, :-1].unbind(1)), \
            rewards[:, -1]
    loss, outer_stats = task_losses.mean(), _mean_stats(stats)
    inner_rews = torch.stack([r.mean(dim=(1, 2)) for r in inner_rews])

    # ---- inner KL coefficient ladder (emaml_policy.py:284-299) ----
    kc = state.kl_coeffs
    kc = torch.where(inner_kls > 2.0 * cfg.kl_target, kc * 1.5, kc)
    kc = torch.where(inner_kls < 0.5 * cfg.kl_target, kc * 0.5, kc)
    state.kl_coeffs = kc

    # ---- success bookkeeping (emaml.py:431-454, train.py:118-121) ----
    # a task counts as solved iff its post-adaptation batch holds a
    # positive reward (rewards.max() > 0 in the reference)
    task_success = post_rewards.amax(dim=(1, 2)) > 0.0
    ids = task_ids.long()
    state.tasks_covered = state.tasks_covered.index_add(
        0, ids, torch.ones_like(ids, dtype=I32))
    state.tasks_succeeded = state.tasks_succeeded.index_add(
        0, ids, task_success.to(I32))

    # per-episode reward aggregates for the wandb schema (train.py:130-150),
    # episodes approximated by per-env rollout sums
    post_ep = post_rewards.sum(dim=1)                 # [T, E]
    return {
        "meta_loss": loss,
        "outer_policy_loss": outer_stats["policy_loss"],
        "outer_vf_loss": outer_stats["vf_loss"],
        "outer_kl_loss": outer_stats["kl"],
        "outer_total_loss": outer_stats["total_loss"],
        "adapt_reward_mean": inner_rews.mean(),
        "adapt_reward_max": inner_rews.max(),
        "adapt_reward_min": inner_rews.min(),
        "post_reward_mean": post_rewards.mean(),
        "post_reward_per_task": post_rewards.mean(dim=(1, 2)),
        "post_eprew_mean": post_ep.mean(),
        "post_eprew_max": post_ep.max(),
        "post_eprew_min": post_ep.min(),
        "inner_kl_mean": inner_kls.mean(),
        "inner_kls": inner_kls,
        "sampled_tasks": task_ids,
        "once_successful": task_success,
        "num_covered_tasks": (state.tasks_covered > 0).sum(),
        "num_succeed_tasks": (state.tasks_succeeded > 0).sum(),
        # the post-adaptation batch ([tasks, N, ...] fields of this rank's
        # tasks and rows), for the successful-batch pickles
        # (train.py:126-128)
        "post_batch": _stack_batches(post_batches),
    }


class _UnitTimes:
    """Time per named unit: CUDA events on a card (read once, at the end
    of the step), the host clock on the CPU."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.marks: List[Tuple[str, object, object]] = []

    def run(self, name: str, fn: Callable, *args):
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
        else:
            start = time.perf_counter()
            out = fn(*args)
            end = time.perf_counter()
        self.marks.append((name, start, end))
        return out

    def read(self) -> Dict[str, Dict[str, float]]:
        """``{unit: {"s": seconds, "n": calls}}``; forgets the marks."""
        if self.cuda and self.marks:
            self.marks[-1][2].synchronize()
        out: Dict[str, Dict[str, float]] = {}
        for name, a, b in self.marks:
            s = a.elapsed_time(b) / 1e3 if self.cuda else b - a
            rec = out.setdefault(name, {"s": 0.0, "n": 0})
            rec["s"] += s
            rec["n"] += 1
        self.marks.clear()
        return out


def make_chunked_train_step(agent: Agent, cfg: EMAMLConfig,
                            profile: bool = False, group=None):
    """The decomposed FOMAML E-MAML step (the GPT path of train_gpt).

    With ``first_order=True`` the replayed chain's Jacobian ``d p_final /
    d p_0`` is the identity (each update subtracts a gradient that is not
    differentiated), so the meta gradient is the sum of the per-inner-step
    KL-term gradients at the replayed params plus the outer-loss gradient
    at the final params.  The step runs as units:

      * per inner step: the per-task rollout, then the inner update
        (``update``) or, with ``cache_chain``, the chain step that also
        records the ladder KLs and KL gradients (``update+chain``);
      * the post-adaptation rollout (``rollout[det]``);
      * per meta-opt step: the chain replay (``chain`` x inner_steps) or,
        with ``cache_chain``, the adapted params re-based on the moved
        meta-params (``shift``, from the second step on), then the outer
        PPO gradient and one AdamW step (``outer``).

    ``profile`` puts ``{unit: {"s": seconds, "n": calls}}`` in the
    metrics as ``unit_times`` (CUDA events on a card).  ``group`` (a
    process group or its layout, laid out once here) makes the step
    data-parallel as :func:`emaml_train_step`'s.  Returns ``step(state,
    env, bs) -> (state, bs, metrics)``, as :func:`emaml_train_step`."""
    if not cfg.first_order:
        raise ValueError(
            "make_chunked_train_step requires first_order=True: the "
            "decomposed meta gradient relies on the FOMAML identity chain "
            "(second-order MAML needs the fused emaml_train_step)")
    T = cfg.n_tasks
    layout = _layout(cfg, group)
    tasks, task_groups = layout.tasks, layout.task_groups

    def rollout_unit(task_params, bs, gen, env, deterministic):
        bs, traj, last_v = task_rollout(env, bs, task_params, gen, agent,
                                        cfg, deterministic)
        return bs, task_batches(traj, last_v, cfg, layout), \
            task_rewards(traj, len(tasks))

    def update_unit(task_params, batches):
        return [_adapt(p, b, cfg, agent, tg)
                for p, b, tg in zip(task_params, batches, task_groups)]

    def chain_step(task_params, acc, batches, klc_i):
        """Replay one inner step per task; with ``kl_ladder_grads``
        accumulate the KL-ladder gradient klc_i * d kl_i / d p_i into
        ``acc`` (None = zeros), else read the KL off the surrogate
        pass."""
        new_params, kls, new_acc = [], [], []
        for t, (p0, b, tg) in enumerate(zip(task_params, batches,
                                            task_groups)):
            p = _leaves(p0)
            if cfg.kl_ladder_grads:
                kl = _batch_kl(p, b, cfg, agent, tg)
                gkl = _grads(kl, p)
                g = _surrogate_grads(p, b, cfg, agent, task_group=tg)
                a = {k: klc_i[t] * v for k, v in gkl.items()} if acc is None \
                    else {k: acc[t][k] + klc_i[t] * v for k, v in gkl.items()}
                new_acc.append(a)
                kl = kl.detach()
            else:
                g, kl = _surrogate_and_kl(p, b, cfg, agent, tg)
            new_params.append({k: (v - cfg.inner_lr * g[k]).detach()
                               for k, v in p.items()})
            kls.append(kl)
        return new_params, (new_acc or acc), torch.stack(kls)

    def shift_unit(task_params, params, params0):
        """cache_chain transport: p_final(params) ~= task_params +
        (params - params0), exact when params == params0."""
        return [{k: tp[k] + (params[k] - params0[k]) for k in tp}
                for tp in task_params]

    def outer_update(p_final, acc, post_batches, kl_pens, state):
        """Outer PPO gradient at the final params plus the accumulated
        KL-ladder gradients, averaged over tasks (summed over the group);
        one AdamW step.  Returns the task losses and outer stats."""
        losses, stats, total = [], [], None
        for t, tg in enumerate(task_groups):
            p = _leaves(p_final[t])
            loss, st = _share(_outer_ppo_loss(p, post_batches[t], cfg,
                                              agent), tg)
            g = _grads(loss, p)
            if acc is not None:
                g = _tree(torch.add, g, acc[t])
            total = g if total is None else _tree(torch.add, total, g)
            losses.append(loss.detach())
            stats.append(st)
        for name, q in state.params.named_parameters():
            q.grad = total[name] / T
        _apply_meta_grads(state, layout.group)
        return torch.stack(losses) + kl_pens, stats

    def step(state: EMAMLState, env: BatchedEnv, bs: BatchedState):
        gen = state.generator
        times = _UnitTimes(next(state.params.parameters()).is_cuda)
        run = times.run if profile else (lambda name, fn, *a: fn(*a))
        current = lambda: {k: v.detach() for k, v in
                           meta_params(state.params).items()}
        params0 = {k: v.clone() for k, v in current().items()}
        kl_coeffs = lambda: state.kl_coeffs[tasks.start:tasks.stop]

        # ---- inner adaptation (emaml.py:367-401); with cache_chain this
        # pass IS the chain replay from params0, so its (acc, kls) serve
        # every meta-opt step ----
        task_params = [params0] * len(tasks)
        acc0, inner_batches, inner_rews, kls0 = None, [], [], []
        for i in range(cfg.inner_steps):
            bs, batches, rews = run("rollout", rollout_unit, task_params,
                                    bs, gen, env, False)
            if cfg.cache_chain:
                task_params, acc0, kl = run(
                    "update+chain", chain_step, task_params, acc0, batches,
                    kl_coeffs()[:, i])
                kls0.append(kl)
            else:
                task_params = run("update", update_unit, task_params,
                                  batches)
                inner_batches.append(batches)
            inner_rews.append(rews)

        # ---- post-adaptation rollouts, explore=False ----
        bs, post_batches, post_rewards = run(
            "rollout[det]", rollout_unit, task_params, bs, gen, env, True)

        # ---- meta-opt loop: the FOMAML chain, decomposed ----
        for opt_step in range(cfg.maml_opt_steps):
            if cfg.cache_chain:
                p = task_params if opt_step == 0 else run(
                    "shift", shift_unit, task_params, current(), params0)
                acc, inner_kls = acc0, torch.stack(kls0, dim=1)  # [T, S]
            else:
                p, acc, kls = [current()] * len(tasks), None, []
                for i, tb in enumerate(inner_batches):
                    p, acc, kl = run("chain", chain_step, p, acc, tb,
                                     kl_coeffs()[:, i])
                    kls.append(kl)
                inner_kls = torch.stack(kls, dim=1)           # [T, S]
            kl_pens = torch.sum(kl_coeffs() * inner_kls, dim=1)
            task_losses, stats = run("outer", outer_update, p, acc,
                                     post_batches, kl_pens, state)

        metrics = _finish_step(state, env, cfg, layout, task_losses,
                               inner_kls, stats, inner_rews, post_rewards,
                               post_batches)
        if profile:
            metrics["unit_times"] = times.read()
        return state, bs, metrics

    return step
