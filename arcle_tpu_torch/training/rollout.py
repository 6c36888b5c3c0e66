"""Trajectory collection and generalised advantage estimation.

Counterpart of ``arcle_tpu/training/rollout.py``.  :func:`rollout` steps a
:class:`BatchedEnv` T times with the policy on the engine's device; the
JAX package's ``lax.scan`` becomes a Python loop over preallocated
time-major storage.  On CUDA the loop never waits for the device: each
step launches the step kernel, the policy's forward passes and a few small
kernels, and no value comes back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from ..core.state import Action, I8, I32, F32
from ..envs.core import BatchedEnv, BatchedState, make_reset_pool
from ..utils.metrics import TRACE
from ..wrappers import bbox_action


class Trajectory(NamedTuple):
    """Time-major rollout storage (``[T, B, ...]``)."""

    obs: torch.Tensor           # i8 [T, B, D]  flattened FilterO2ARC obs
    actions: torch.Tensor       # i32 [T, B, 5] (x1, y1, x2, y2, op)
    log_probs: torch.Tensor     # f32 [T, B]
    values: torch.Tensor        # f32 [T, B]
    rewards: torch.Tensor       # f32 [T, B]
    dones: torch.Tensor         # bool [T, B]   terminated | truncated
    terminated: torch.Tensor    # bool [T, B]   true terminations
    final_values: torch.Tensor  # f32 [T, B]    V(pre-reset obs) where
                                # truncated & not terminated, else 0: the
                                # TimeLimit bootstrap of the reference's
                                # GAE (emaml_policy.py:449-460)


def decode_bbox_actions(actions: torch.Tensor, H: int = 30, W: int = 30
                        ) -> Action:
    """``[B, 5]`` ints -> selection-mask actions (BBoxWrapper semantics)."""
    return bbox_action(actions[:, 0], actions[:, 1], actions[:, 2],
                       actions[:, 3], actions[:, 4], H, W)


@torch.no_grad()
def rollout(env: BatchedEnv, bs: BatchedState, params,
            generator: torch.Generator, n_steps: int, agent,
            deterministic: bool = False
            ) -> Tuple[BatchedState, Trajectory, torch.Tensor]:
    """Collect ``n_steps`` of experience with an agent; returns
    ``(carry, traj, last_value)``.  ``generator`` (on the engine's device)
    draws the refreshed reset pool and the actions."""
    with TRACE.span("rollout"):
        H, W = env.bank.in_grids.shape[-2:]
        # refresh the auto-reset pool once per rollout: fresh augmentations
        # in one batch over B*K rows instead of inside the steps
        if env.auto_reset and env.reset_pool > 0:
            with TRACE.span("reset_pool"):
                bs = dataclasses.replace(
                    bs, pool=make_reset_pool(env, generator, bs.batch))
        B, dev, T = bs.batch, bs.env.device, n_steps
        traj = Trajectory(
            obs=torch.empty((T, B, agent.obs_dim), dtype=I8, device=dev),
            actions=torch.empty((T, B, 5), dtype=I32, device=dev),
            log_probs=torch.empty((T, B), dtype=F32, device=dev),
            values=torch.empty((T, B), dtype=F32, device=dev),
            rewards=torch.empty((T, B), dtype=F32, device=dev),
            dones=torch.empty((T, B), dtype=torch.bool, device=dev),
            terminated=torch.empty((T, B), dtype=torch.bool, device=dev),
            final_values=torch.empty((T, B), dtype=F32, device=dev))
        for t in range(T):
            obs = agent.obs_fn(bs.env)
            acts, lp, value = agent.sample_fn(params, obs, generator,
                                              deterministic)
            bs, obs_env, rew, term, trunc = env.step(
                bs, decode_bbox_actions(acts, H, W))
            # TimeLimit bootstrap: V of the pre-reset observation, kept
            # only where an episode was truncated without terminating.
            # Computed for every env on every step: branching on
            # any(trunc & ~term), as the JAX package does, would make the
            # host wait for the device here.
            _, v_fin, _ = agent.evaluate_fn(params, agent.obs_fn(obs_env),
                                            acts)
            need = trunc & ~term
            traj.obs[t] = obs
            traj.actions[t] = acts
            traj.log_probs[t] = lp
            traj.values[t] = value
            traj.rewards[t] = rew
            traj.dones[t] = term | trunc
            traj.terminated[t] = term
            traj.final_values[t] = torch.where(need, v_fin,
                                               torch.zeros_like(v_fin))
        last_obs = agent.obs_fn(bs.env)
        zero_act = torch.zeros((B, 5), dtype=I32, device=dev)
        _, last_value, _ = agent.evaluate_fn(params, last_obs, zero_act)
        return bs, traj, last_value


def gae(traj: Trajectory, last_value: torch.Tensor, gamma: float,
        lam: float, bootstrap_truncation: bool = True
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generalised advantage estimation over a time-major trajectory (the
    reference's RLlib GAE postprocessing, emaml_policy.py:449-460).

    With auto-reset the observation after a done belongs to a fresh
    episode, so the advantage chain is cut at every done; a truncated but
    not terminated step bootstraps its delta with ``traj.final_values``.
    ``bootstrap_truncation=False`` treats truncation as termination.
    Returns ``(advantages, returns)``, ``returns = advantages + values``.
    """
    fv = traj.final_values if bootstrap_truncation \
        else torch.zeros_like(traj.values)
    advs = torch.empty_like(traj.values)
    adv_next = torch.zeros_like(last_value)
    v_next = last_value
    for t in reversed(range(traj.values.shape[0])):
        noncut = 1.0 - traj.dones[t].to(F32)
        # at a truncation fv = V(pre-reset obs) and noncut = 0: the delta
        # bootstraps while the advantage chain still cuts
        delta = traj.rewards[t] + gamma * (v_next * noncut + fv[t]) \
            - traj.values[t]
        adv_next = delta + gamma * lam * noncut * adv_next
        advs[t] = adv_next
        v_next = traj.values[t]
    return advs, advs + traj.values
