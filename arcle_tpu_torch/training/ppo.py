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
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.nn.functional as F

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


def batch_from_trajectory(traj: Trajectory, last_value: torch.Tensor,
                          cfg: PPOConfig, include_aux: bool = False,
                          grid_slice: slice = slice(902, 1802)) -> PPOBatch:
    """Flatten a trajectory into a PPO batch with normalised advantages.
    ``include_aux`` adds the targets of the GPT auxiliary predictions: r_t,
    r_{t-1} (zeroed across episode boundaries) and the next observation's
    grid cells (``grid_slice`` locates them in the flattened obs)."""
    adv, ret = gae(traj, last_value, cfg.gamma, cfg.gae_lambda,
                   cfg.bootstrap_truncation)
    # jnp.std is the population standard deviation
    adv_n = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
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
             ent_coeff=None):
    """Clipped PPO loss (emaml_policy.py:38-99); returns
    ``(total, stats)``.  ``ent_coeff`` optionally overrides
    ``cfg.entropy_coeff``."""
    lp, value, entropy_arr = agent.evaluate_fn(params, batch.obs,
                                               batch.actions)
    ratio = torch.exp(lp - batch.log_probs)
    surr = torch.minimum(
        ratio * batch.advantages,
        torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps)
        * batch.advantages)
    policy_loss = -surr.mean()

    vf_err = (value - batch.returns) ** 2
    vf_clipped = (batch.values
                  + torch.clamp(value - batch.values, -cfg.vf_clip,
                                cfg.vf_clip)
                  - batch.returns) ** 2
    vf_loss = 0.5 * torch.maximum(vf_err, vf_clipped).mean()

    entropy = entropy_arr.mean()
    approx_kl = (batch.log_probs - lp).mean()

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
        rtm1_loss = ((aux["rtm1"] - batch.prev_rewards) ** 2).mean()
        r_loss = ((aux["r"] - batch.rewards) ** 2).mean()
        g_logp = F.log_softmax(aux["g_logits"], dim=-1)
        tgt = batch.next_grid.long().clamp(0, g_logp.shape[-1] - 1)
        ce = -torch.gather(g_logp, -1, tgt.unsqueeze(-1)).squeeze(-1)
        denom = torch.clamp(batch.aux_valid.sum(), min=1.0)
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
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """``optax.clip_by_global_norm`` in place: every gradient becomes
    ``g / norm * max_norm`` where the global norm reaches ``max_norm``, and
    stays as it is below it.  No value comes back to the host."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def permutations(generator: Optional[torch.Generator], n_epochs: int,
                 n: int, device) -> List[torch.Tensor]:
    """One shuffle of the ``n`` batch rows per epoch."""
    return [torch.randperm(n, generator=generator, device=device)
            for _ in range(n_epochs)]


def _update(params, opt: torch.optim.Optimizer, batch: PPOBatch, agent,
            cfg: PPOConfig, ent_coeff) -> Dict[str, torch.Tensor]:
    """One gradient step of the clipped loss on ``batch``."""
    opt.zero_grad(set_to_none=True)
    loss, stats = ppo_loss(params, agent, batch, cfg, ent_coeff)
    loss.backward()
    if cfg.max_grad_norm > 0:
        clip_by_global_norm_([p.grad for p in params.parameters()
                              if p.grad is not None], cfg.max_grad_norm)
    opt.step()
    return {k: v.detach() for k, v in stats.items()}


def _mean_stats(stats: List[Dict[str, torch.Tensor]]
                ) -> Dict[str, torch.Tensor]:
    return {k: torch.stack([s[k] for s in stats]).mean() for k in stats[0]}


def train_step(params, opt: torch.optim.Optimizer, batch: PPOBatch,
               generator: Optional[torch.Generator], agent, cfg: PPOConfig,
               ent_coeff=None) -> Dict[str, torch.Tensor]:
    """``n_epochs`` x ``n_minibatches`` PPO updates on one batch.

    With one epoch of one minibatch the batch is used as it is (the update
    does not depend on row order, and a shuffle would copy the whole
    ``[N, D]`` batch).  Otherwise each epoch shuffles the rows with a
    permutation drawn from ``generator`` and takes ``n // n_minibatches``
    rows per minibatch, dropping the rest.  The statistics are averaged
    over the minibatches of each epoch, then over the epochs."""
    if cfg.n_epochs == 1 and cfg.n_minibatches == 1:
        return _update(params, opt, batch, agent, cfg, ent_coeff)
    n = batch.obs.shape[0]
    mb = max(1, n // cfg.n_minibatches)
    epochs = []
    for perm in permutations(generator, cfg.n_epochs, n, batch.obs.device):
        shuf = batch.take(perm)
        epochs.append(_mean_stats([
            _update(params, opt, shuf.take(slice(i * mb, (i + 1) * mb)),
                    agent, cfg, ent_coeff)
            for i in range(cfg.n_minibatches)]))
    return _mean_stats(epochs)
