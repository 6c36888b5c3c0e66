"""Policy-agnostic agent interface for the rollout and PPO machinery.

Counterpart of ``arcle_tpu/training/agents.py``.  An :class:`Agent`
packages functions over a flat observation vector, so the learners never
care which network is behind them.  ``params`` is the policy
``nn.Module`` itself:

* ``obs_fn(env_state) -> obs``                    batched observations
* ``sample_fn(params, obs, generator, deterministic=False, u=None)
  -> (actions [..., 5], log_prob, value)``; ``u`` injects the uniforms
* ``evaluate_fn(params, obs, actions) -> (log_prob, value, entropy)``
* ``init_fn(generator) -> params``                a freshly initialised policy

Only :func:`mlp_agent` is ported; ``gpt_agent`` waits for the GPT stack
(ROADMAP queue 1 item 10).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Optional

import torch

from ..models.mlp import (
    FCPolicy, multi_categorical_sample, multi_categorical_log_prob,
    multi_categorical_entropy, stack_padded_logits,
)
from ..wrappers import flatten_obs


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


def mlp_agent(policy: FCPolicy) -> Agent:
    def sample_fn(params, obs, generator=None, deterministic=False, u=None):
        logits_tuple, value = params(obs)
        if deterministic:
            acts = torch.argmax(stack_padded_logits(logits_tuple),
                                dim=-1).to(torch.int32)
            lp = multi_categorical_log_prob(logits_tuple, acts)
        else:
            acts, lp = multi_categorical_sample(logits_tuple, generator, u)
        return acts, lp, value

    def evaluate_fn(params, obs, actions):
        logits_tuple, value = params(obs)
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
