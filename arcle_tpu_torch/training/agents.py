"""Policy-agnostic agent interface for the rollout, PPO and E-MAML
machinery.

Counterpart of ``arcle_tpu/training/agents.py``.  An :class:`Agent`
packages functions over a flat observation vector, so the learners never
care which network is behind them.  ``params`` is either the policy
``nn.Module`` itself (the PPO learner) or a mapping from parameter names
to tensors, which runs the agent's module through
``torch.func.functional_call`` (E-MAML's per-task parameters):

* ``obs_fn(env_state) -> obs``                    batched observations
* ``sample_fn(params, obs, generator, deterministic=False, u=None)
  -> (actions [..., 5], log_prob, value)``; ``u`` injects the uniforms
* ``evaluate_fn(params, obs, actions) -> (log_prob, value, entropy)``
* ``init_fn(generator) -> params``                a freshly initialised policy
* ``aux_fn(params, obs, actions) -> {"rtm1", "r", "g_logits"}`` (GPT only)

:func:`mlp_agent` is the FilterO2ARC MLP pipeline (train.py:62-68);
:func:`gpt_agent` the transformer over the full observation with the
categorical op + truncated-normal bbox head (train_gpt.py, bboxdist.py).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Optional

import torch
from torch import nn

from ..models import bbox_dist
from ..models.gpt import GPTPolicy
from ..models.mlp import (
    FCPolicy, multi_categorical_sample, multi_categorical_log_prob,
    multi_categorical_entropy, stack_padded_logits,
)
from ..utils.metrics import TRACE
from ..wrappers import flatten_obs, full_flatten_obs, unflatten_full, \
    FULL_OBS_DIM


@dataclasses.dataclass(frozen=True)
class Agent:
    obs_fn: Callable
    sample_fn: Callable
    evaluate_fn: Callable
    init_fn: Callable          # (generator) -> params
    obs_dim: int
    # optional action-conditioned auxiliary predictions
    # (params, obs, actions) -> {"rtm1", "r", "g_logits"}; used by
    # ppo_loss when aux_coeff > 0 (paper §4.1.1 losses)
    aux_fn: Optional[Callable] = None


def apply(module: nn.Module, params, *args, **kwargs):
    """``module(*args, **kwargs)`` with ``params``: the module itself, or
    a name -> tensor mapping that stands in for its parameters."""
    if isinstance(params, nn.Module):
        return params(*args, **kwargs)
    return torch.func.functional_call(module, params, args, kwargs)


def mlp_agent(policy: FCPolicy) -> Agent:
    def sample_fn(params, obs, generator=None, deterministic=False, u=None):
        with TRACE.span("policy"):
            logits_tuple, value = apply(policy, params, obs)
            if deterministic:
                acts = torch.argmax(stack_padded_logits(logits_tuple),
                                    dim=-1).to(torch.int32)
                lp = multi_categorical_log_prob(logits_tuple, acts)
            else:
                acts, lp = multi_categorical_sample(logits_tuple, generator,
                                                    u)
            return acts, lp, value

    def evaluate_fn(params, obs, actions):
        with TRACE.span("policy"):
            logits_tuple, value = apply(policy, params, obs)
            lp = multi_categorical_log_prob(logits_tuple, actions)
            ent = multi_categorical_entropy(logits_tuple)
            return lp, value, ent

    def init_fn(generator: Optional[torch.Generator] = None) -> FCPolicy:
        fresh = copy.deepcopy(policy)
        fresh.reset_parameters(generator)
        return fresh

    return Agent(obs_fn=flatten_obs, sample_fn=sample_fn,
                 evaluate_fn=evaluate_fn, init_fn=init_fn,
                 obs_dim=policy.obs_dim)


def gpt_agent(model: GPTPolicy, grid_size: int = 30) -> Agent:
    """The op + bbox distribution math lives in :mod:`models.bbox_dist`.
    ``u`` of ``sample_fn`` is ``(u_op, u_bbox)``."""

    def forward(params, obs, **kw):
        f = unflatten_full(obs)
        return apply(model, params, f["grid"], f["grid_dim"], f["input"],
                     f["input_dim"], f["trials_remain"], f["active"], **kw)

    def sample_fn(params, obs, generator=None, deterministic=False, u=None):
        with TRACE.span("policy"):
            out = forward(params, obs)
            u_op, u_bbox = (None, None) if u is None else u
            s = bbox_dist.sample(out["op_logits"], out["bbox_mean_all"],
                                 out["bbox_std_all"], grid_size,
                                 deterministic, generator=generator,
                                 u_op=u_op, u_bbox=u_bbox)
            acts = torch.cat([s.bbox, s.operation[..., None]], dim=-1)
            return acts, s.log_prob, out["value"]

    def evaluate_fn(params, obs, actions):
        with TRACE.span("policy"):
            out = forward(params, obs)
            op = actions[..., 4]
            lp = bbox_dist.log_prob(out["op_logits"], out["bbox_mean_all"],
                                    out["bbox_std_all"], op,
                                    actions[..., :4], grid_size)
            ent = bbox_dist.entropy(out["op_logits"], out["bbox_mean_all"],
                                    out["bbox_std_all"], op)
            return lp, out["value"], ent

    def aux_fn(params, obs, actions):
        """The action-conditioned forward (GPTPolicy.py:401-456 intent):
        r_t and next-grid predictions, and r_{t-1} from the same pass's
        CLS (pre-action information, so conditioning is harmless)."""
        out = forward(params, obs, operation=actions[..., 4],
                      bbox=actions[..., :4].to(torch.float32) / grid_size)
        return {"rtm1": out["aux_rtm1"], "r": out["aux_reward"],
                "g_logits": out["aux_transition"]}

    def init_fn(generator: Optional[torch.Generator] = None) -> GPTPolicy:
        return GPTPolicy(model.cfg, generator)

    return Agent(obs_fn=full_flatten_obs, sample_fn=sample_fn,
                 evaluate_fn=evaluate_fn, init_fn=init_fn,
                 obs_dim=FULL_OBS_DIM, aux_fn=aux_fn)
