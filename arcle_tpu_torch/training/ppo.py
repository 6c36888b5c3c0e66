"""PPO learner.

Counterpart of ``arcle_tpu/training/ppo.py``.  The loss mirrors the
reference's functional ``PPOLoss`` (emaml_policy.py:38-99): clipped
surrogate + clipped value loss + entropy bonus + KL penalty against the
behaviour policy.  The optimizer is optax's ``clip_by_global_norm`` +
``adam``: the clip is written out (:func:`clip_by_global_norm_`) because
``torch.nn.utils.clip_grad_norm_`` scales by ``max_norm / (norm + 1e-6)``
where optax scales by ``max_norm / norm``, and only above the limit;
``torch.optim.Adam`` (eps 1e-8 outside the square root, bias-corrected)
is the same formula as ``optax.adam``.

``params`` is the policy ``nn.Module``; :func:`train_step` updates it and
its optimizer in place and returns the loss statistics as device tensors.

Data parallelism (``group=``, a process group over the data axis): every
rank holds a block of the env batch, ``[T, B/n]``, and the update computes
the unsharded function.  The advantage statistics are all-reduced (count
and sum, then the centred sum of squares, as ``jnp.std`` takes two
passes); the minibatch permutation is one global permutation of the
``T*B`` rows, broadcast from the group's first rank, of which each rank
takes the rows it holds (its local row ``(t, b)`` is global row ``t*B +
rank*B/n + b``); every loss term is a local sum over the global count;
one SUM all-reduce of a flat gradient buffer precedes the clip, whose norm
counts each tensor-parallel block once; the statistics are all-reduced for
logging.  Without a group the code path is the single-process one.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..utils.metrics import TRACE
from .rollout import Trajectory, gae


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """Hyperparameters; defaults follow the reference EMAMLConfig and
    training scripts (train.py:43-59, emaml.py:161-280)."""

    gamma: float = 0.9
    gae_lambda: float = 1.0
    clip_eps: float = 0.3        # clip_param (emaml.py:122)
    vf_clip: float = 10.0        # vf_clip_param (emaml.py:123)
    vf_coeff: float = 0.1        # vf_loss_coeff (train.py:56)
    entropy_coeff: float = 0.0   # (emaml.py:121)
    kl_coeff: float = 0.0005
    lr: float = 1e-4
    n_epochs: int = 1
    n_minibatches: int = 1
    max_grad_norm: float = 10.0  # grad_clip (train.py:58); 0 = off
    bootstrap_truncation: bool = True  # TimeLimit GAE bootstrap; False =
                                 # treat truncation as termination
    aux_coeff: float = 0.0       # weight of the GPT auxiliary losses
                                 # (paper §4.1.1); 0 = off
    aux_terms: str = "all"       # "rtm1" | "rtm1+rt" | "all"


class PPOBatch(NamedTuple):
    obs: torch.Tensor        # [N, D]
    actions: torch.Tensor    # [N, 5]
    log_probs: torch.Tensor  # [N]
    values: torch.Tensor     # [N]
    advantages: torch.Tensor # [N]
    returns: torch.Tensor    # [N]
    # aux-loss targets (None unless built with include_aux; paper §4.1.1)
    rewards: Optional[torch.Tensor] = None       # [N]    r_t
    prev_rewards: Optional[torch.Tensor] = None  # [N]    r_{t-1}
    next_grid: Optional[torch.Tensor] = None     # [N, 900] i8
    aux_valid: Optional[torch.Tensor] = None     # [N] f32

    def take(self, idx: torch.Tensor) -> "PPOBatch":
        """The rows ``idx`` of every field that is present."""
        return PPOBatch(*(None if x is None else x[idx] for x in self))


def _normalise(adv: torch.Tensor, group) -> torch.Tensor:
    """``(adv - mean) / (std + 1e-8)`` over the advantages of every rank
    of ``group``, in two passes as ``jnp.std``."""
    s = torch.stack([adv.sum(), torch.full_like(adv.sum(), adv.numel())])
    dist.all_reduce(s, group=group)
    mean = s[0] / s[1]
    css = ((adv - mean) ** 2).sum()
    dist.all_reduce(css, group=group)
    return (adv - mean) / (torch.sqrt(css / s[1]) + 1e-8)


def batch_from_trajectory(traj: Trajectory, last_value: torch.Tensor,
                          cfg: PPOConfig, include_aux: bool = False,
                          grid_slice: slice = slice(902, 1802),
                          group=None) -> PPOBatch:
    """Flatten a trajectory into a PPO batch with normalised advantages.
    ``include_aux`` adds the targets of the GPT auxiliary predictions: r_t,
    r_{t-1} (zeroed across episode boundaries) and the next observation's
    grid cells (``grid_slice`` locates them in the flattened obs).  With a
    data-parallel ``group`` the advantages are normalised over every
    rank's trajectory."""
    adv, ret = gae(traj, last_value, cfg.gamma, cfg.gae_lambda,
                   cfg.bootstrap_truncation)
    if group is None:
        # jnp.std is the population standard deviation
        adv_n = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    else:
        adv_n = _normalise(adv, group)
    flat = lambda x: x.reshape((-1,) + tuple(x.shape[2:]))
    aux = {}
    if include_aux:
        done_f = traj.dones.to(torch.float32)
        prev_r = torch.cat([torch.zeros_like(traj.rewards[:1]),
                            traj.rewards[:-1] * (1.0 - done_f[:-1])], dim=0)
        # the step after a done belongs to a fresh episode, and the last
        # step has no successor stored
        nxt = torch.cat([traj.obs[1:, :, grid_slice],
                         traj.obs[-1:, :, grid_slice]], dim=0)
        valid = torch.cat([1.0 - done_f[:-1],
                           torch.zeros_like(traj.rewards[-1:])], dim=0)
        aux = dict(rewards=flat(traj.rewards), prev_rewards=flat(prev_r),
                   next_grid=flat(nxt), aux_valid=flat(valid))
    return PPOBatch(obs=flat(traj.obs), actions=flat(traj.actions),
                    log_probs=flat(traj.log_probs), values=flat(traj.values),
                    advantages=flat(adv_n), returns=flat(ret), **aux)


def ppo_loss(params, agent, batch: PPOBatch, cfg: PPOConfig,
             ent_coeff=None, count=None, aux_denom=None):
    """Clipped PPO loss (emaml_policy.py:38-99); returns
    ``(total, stats)``.  ``ent_coeff`` optionally overrides
    ``cfg.entropy_coeff``.  ``count`` turns every mean over rows into a sum
    over this batch divided by ``count`` (a data-parallel rank's share of
    the global mean), and ``aux_denom`` replaces the next-grid loss's
    ``max(sum(aux_valid), 1)``."""
    mean = torch.mean if count is None else (lambda x: x.sum() / count)
    lp, value, entropy_arr = agent.evaluate_fn(params, batch.obs,
                                               batch.actions)
    ratio = torch.exp(lp - batch.log_probs)
    surr = torch.minimum(
        ratio * batch.advantages,
        torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps)
        * batch.advantages)
    policy_loss = -mean(surr)

    vf_err = (value - batch.returns) ** 2
    vf_clipped = (batch.values
                  + torch.clamp(value - batch.values, -cfg.vf_clip,
                                cfg.vf_clip)
                  - batch.returns) ** 2
    vf_loss = 0.5 * mean(torch.maximum(vf_err, vf_clipped))

    entropy = mean(entropy_arr)
    approx_kl = mean(batch.log_probs - lp)

    if ent_coeff is None:
        ent_coeff = cfg.entropy_coeff
    total = (policy_loss + cfg.vf_coeff * vf_loss
             - ent_coeff * entropy + cfg.kl_coeff * approx_kl)
    stats = {"policy_loss": policy_loss, "vf_loss": vf_loss,
             "entropy": entropy, "kl": approx_kl}

    if cfg.aux_coeff > 0.0 and getattr(agent, "aux_fn", None) is not None:
        # r_{t-1} from the unconditioned pass, r_t and the next grid from
        # the action-conditioned one (paper §4.1.1)
        aux = agent.aux_fn(params, batch.obs, batch.actions)
        rtm1_loss = mean((aux["rtm1"] - batch.prev_rewards) ** 2)
        r_loss = mean((aux["r"] - batch.rewards) ** 2)
        g_logp = F.log_softmax(aux["g_logits"], dim=-1)
        tgt = batch.next_grid.long().clamp(0, g_logp.shape[-1] - 1)
        ce = -torch.gather(g_logp, -1, tgt.unsqueeze(-1)).squeeze(-1)
        denom = torch.clamp(batch.aux_valid.sum(), min=1.0) \
            if aux_denom is None else aux_denom
        g_loss = (ce.mean(-1) * batch.aux_valid).sum() / denom
        aux_loss = rtm1_loss
        if cfg.aux_terms in ("rtm1+rt", "all"):
            aux_loss = aux_loss + r_loss
        if cfg.aux_terms == "all":
            aux_loss = aux_loss + g_loss
        total = total + cfg.aux_coeff * aux_loss
        stats.update({"aux_loss": aux_loss, "aux_rtm1_loss": rtm1_loss,
                      "aux_r_loss": r_loss, "aux_grid_loss": g_loss})

    stats["total_loss"] = total
    return total, stats


def surrogate_loss(params, agent, batch: PPOBatch, cfg: PPOConfig):
    """The unclipped inner-loop surrogate (WorkerLoss,
    emaml_policy.py:101-137): importance-weighted advantage + value
    error."""
    lp, value, _ = agent.evaluate_fn(params, batch.obs, batch.actions)
    ratio = torch.exp(lp - batch.log_probs)
    policy_loss = -(ratio * batch.advantages).mean()
    vf_loss = 0.5 * ((value - batch.returns) ** 2).mean()
    return policy_loss + cfg.vf_coeff * vf_loss


def make_optimizer(params, cfg: PPOConfig) -> torch.optim.Adam:
    """``optax.adam(cfg.lr)`` over the policy's parameters; the global-norm
    clip of ``cfg.max_grad_norm`` is applied by :func:`train_step`."""
    return torch.optim.Adam(params.parameters(), lr=cfg.lr,
                            betas=(0.9, 0.999), eps=1e-8)


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         sharded: List[torch.Tensor] = (),
                         model_group=None) -> None:
    """``optax.clip_by_global_norm`` in place: every gradient becomes
    ``g / norm * max_norm`` where the global norm reaches ``max_norm``, and
    stays as it is below it.  No value comes back to the host.
    ``sharded`` are the gradients of tensor-parallel blocks: their squares
    are summed over ``model_group``, so each block counts once."""
    norm_sq = sum(torch.sum(g * g) for g in grads)
    if sharded:
        blocks = sum(torch.sum(g * g) for g in sharded)
        dist.all_reduce(blocks, group=model_group)
        norm_sq = norm_sq + blocks
    norm = torch.sqrt(norm_sq)
    keep = norm < max_norm
    for g in (*grads, *sharded):
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def _clip(params, max_norm: float) -> None:
    grads, sharded, group = [], [], None
    for p in params.parameters():
        if p.grad is None:
            continue
        if getattr(p, "tp_group", None) is None:
            grads.append(p.grad)
        else:
            sharded.append(p.grad)
            group = p.tp_group
    clip_by_global_norm_(grads, max_norm, sharded, group)


def permutations(generator: Optional[torch.Generator], n_epochs: int,
                 n: int, device) -> List[torch.Tensor]:
    """One shuffle of the ``n`` batch rows per epoch."""
    return [torch.randperm(n, generator=generator, device=device)
            for _ in range(n_epochs)]


def _update(params, opt: torch.optim.Optimizer, batch: PPOBatch, agent,
            cfg: PPOConfig, ent_coeff) -> Dict[str, torch.Tensor]:
    """One gradient step of the clipped loss on ``batch``."""
    with TRACE.span("minibatch"):
        opt.zero_grad(set_to_none=True)
        loss, stats = ppo_loss(params, agent, batch, cfg, ent_coeff)
        loss.backward()
        if cfg.max_grad_norm > 0:
            _clip(params, cfg.max_grad_norm)
        opt.step()
        return {k: v.detach() for k, v in stats.items()}


def _all_reduce_grads(params, group) -> None:
    """One SUM all-reduce of every present gradient, through one flat
    buffer.  Which gradients are present is the same on every rank: it
    depends on the loss's graph, not on the rows."""
    grads = [p.grad for p in params.parameters() if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def _update_grouped(params, opt: torch.optim.Optimizer, batch: PPOBatch,
                    rows: Optional[torch.Tensor], count: int, agent,
                    cfg: PPOConfig, ent_coeff, group
                    ) -> Dict[str, torch.Tensor]:
    """One data-parallel gradient step on the global minibatch of
    ``count`` rows of which this rank holds ``rows`` (None: all of
    ``batch``).  Returns this rank's share of the statistics."""
    weight = 1.0
    if rows is not None:
        if rows.numel() == 0:
            # no row of this minibatch is here: a zero-weighted row keeps
            # the graph, and so the set of gradients, that of the others
            rows, weight = torch.zeros(1, dtype=torch.long,
                                       device=rows.device), 0.0
        batch = batch.take(rows)
    aux_denom = None
    if cfg.aux_coeff > 0.0 and getattr(agent, "aux_fn", None) is not None:
        aux_denom = (batch.aux_valid.sum() * weight).reshape(1)
        dist.all_reduce(aux_denom, group=group)
        aux_denom = torch.clamp(aux_denom[0], min=1.0)
    opt.zero_grad(set_to_none=True)
    loss, stats = ppo_loss(params, agent, batch, cfg, ent_coeff,
                           count=count, aux_denom=aux_denom)
    (loss * weight).backward()
    _all_reduce_grads(params, group)
    if cfg.max_grad_norm > 0:
        _clip(params, cfg.max_grad_norm)
    opt.step()
    return {k: v.detach() * weight for k, v in stats.items()}


def _mean_stats(stats: List[Dict[str, torch.Tensor]]
                ) -> Dict[str, torch.Tensor]:
    return {k: torch.stack([s[k] for s in stats]).mean() for k in stats[0]}


def _train_step_grouped(params, opt, batch: PPOBatch, generator, agent,
                        cfg: PPOConfig, ent_coeff, group, rollout_steps
                        ) -> Dict[str, torch.Tensor]:
    n_ranks, rank = dist.get_world_size(group), dist.get_rank(group)
    n_local = batch.obs.shape[0]
    n = n_local * n_ranks
    if cfg.n_epochs == 1 and cfg.n_minibatches == 1:
        stats = _update_grouped(params, opt, batch, None, n, agent, cfg,
                                ent_coeff, group)
    else:
        if rollout_steps is None or n_local % rollout_steps:
            raise ValueError("train_step: a data-parallel shuffle needs "
                             "rollout_steps, the T of the [T, B/n] rows")
        b_local = n_local // rollout_steps
        b = b_local * n_ranks
        mb = max(1, n // cfg.n_minibatches)
        src = dist.get_global_rank(group, 0)
        epochs = []
        for perm in permutations(generator, cfg.n_epochs, n,
                                 batch.obs.device):
            dist.broadcast(perm, src, group=group)
            minibatches = []
            for i in range(cfg.n_minibatches):
                g = perm[i * mb:(i + 1) * mb]
                t, col = g // b, g % b
                mine = col // b_local == rank
                rows = (t * b_local + col % b_local)[mine]
                minibatches.append(_update_grouped(
                    params, opt, batch, rows, mb, agent, cfg, ent_coeff,
                    group))
            epochs.append(_mean_stats(minibatches))
        stats = _mean_stats(epochs)
    names = sorted(stats)
    total = torch.stack([stats[k] for k in names])
    dist.all_reduce(total, group=group)
    return dict(zip(names, total.unbind()))


def train_step(params, opt: torch.optim.Optimizer, batch: PPOBatch,
               generator: Optional[torch.Generator], agent, cfg: PPOConfig,
               ent_coeff=None, group=None,
               rollout_steps: Optional[int] = None
               ) -> Dict[str, torch.Tensor]:
    """``n_epochs`` x ``n_minibatches`` PPO updates on one batch.

    With one epoch of one minibatch the batch is used as it is (the update
    does not depend on row order, and a shuffle would copy the whole
    ``[N, D]`` batch).  Otherwise each epoch shuffles the rows with a
    permutation drawn from ``generator`` and takes ``n // n_minibatches``
    rows per minibatch, dropping the rest.  The statistics are averaged
    over the minibatches of each epoch, then over the epochs.

    ``group`` makes the update data-parallel (see the module's
    docstring): ``batch`` is this rank's ``[T * B/n]`` rows and
    ``rollout_steps`` their ``T``.  Each rank takes the rows it holds of
    every minibatch, which waits for the device once per minibatch."""
    with TRACE.span("update"):
        if group is not None:
            return _train_step_grouped(params, opt, batch, generator, agent,
                                       cfg, ent_coeff, group, rollout_steps)
        if cfg.n_epochs == 1 and cfg.n_minibatches == 1:
            return _update(params, opt, batch, agent, cfg, ent_coeff)
        n = batch.obs.shape[0]
        mb = max(1, n // cfg.n_minibatches)
        epochs = []
        for perm in permutations(generator, cfg.n_epochs, n,
                                 batch.obs.device):
            shuf = batch.take(perm)
            epochs.append(_mean_stats([
                _update(params, opt, shuf.take(slice(i * mb, (i + 1) * mb)),
                        agent, cfg, ent_coeff)
                for i in range(cfg.n_minibatches)]))
        return _mean_stats(epochs)
