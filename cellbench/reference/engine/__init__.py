"""A frozen copy of the port's plain PyTorch transition.

``state``, ``geometry``, ``floodfill``, ``groups`` and ``table`` are copies
of ``arcle_tpu_torch/core/{state,geometry,floodfill}.py`` and
``arcle_tpu_torch/ops/{groups,table}.py`` as they stood when the
benchmark was written, held bit for bit to the JAX package's transition by
the repository's tests.  They import nothing of the port, so a later
change to the port cannot move the yardstick that judges it.

Above them, the parts of ``BatchedEnv`` that a step adds to the
transition, written out plainly: the bbox selection of an action, the
reward modes, termination on a match, the TimeLimit and auto-reset from a
pool of pre-drawn episodes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .geometry import bbox_selection
from .groups import G
from .state import Action, EnvState, FIELDS, F32, I8, I32, init_state
from .table import (
    OpTable, answers_match_any, dense_reward, o2arc_table, pixel_reward,
    step,
)


def color_table(n_colors: int) -> OpTable:
    """The answer-given setting's table: Color0..Color{k-1}, no Submit."""
    return OpTable(name=f"AnswerGiven{n_colors}",
                   group=tuple([G.COLOR] * n_colors),
                   param=tuple(range(n_colors)),
                   reset_sel=tuple([False] * n_colors), max_trial=-1,
                   submit_op=-1)


def bbox_actions(acts: torch.Tensor, H: int, W: int) -> Action:
    """``[B, 5]`` (x1, y1, x2, y2, op) -> selection-mask actions."""
    return Action(selection=bbox_selection(acts[:, 0], acts[:, 1],
                                           acts[:, 2], acts[:, 3], H, W),
                  operation=acts[:, 4].to(I32).contiguous())


@dataclasses.dataclass(frozen=True)
class EnvSpec:
    """What one batched step does around the transition."""

    table: OpTable
    episode_limit: int = 0
    dense_reward: bool = False
    pixel_reward: bool = False
    terminate_on_match: bool = False
    max_trial: int = -1


def env_step(spec: EnvSpec, st: EnvState, act: Action,
             reward_dtype: torch.dtype = F32
             ) -> Tuple[EnvState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One lockstep step before auto-reset: ``(state, reward, terminated,
    truncated)``.  A ``reward_dtype`` below float32 makes the precision
    control: the shaped reward kept in that type."""
    s2, reward, term = step(st, act, spec.table)
    W = s2.grid.shape[-1]
    if spec.dense_reward:
        reward = dense_reward(s2, reward)
    if spec.pixel_reward:
        reward = pixel_reward(s2, W)
    reward = reward.to(reward_dtype).to(F32)
    if spec.terminate_on_match:
        solved = answers_match_any(s2, W)
        s2 = dataclasses.replace(s2, terminated=torch.maximum(
            s2.terminated, solved.to(I8)))
        term = s2.terminated != 0
    if spec.episode_limit > 0:
        trunc = s2.steps >= spec.episode_limit
    else:
        trunc = torch.zeros_like(term)
    return s2, reward, term, trunc


def fresh_from_pool(pool, counter: torch.Tensor, max_trial: int,
                    reset_on_submit: torch.Tensor) -> EnvState:
    """The next pre-drawn episode of every env slot: slot ``i`` owns rows
    ``[i*K, (i+1)*K)`` of the pool and ``counter`` walks them, wrapping
    past K."""
    grid, dim, answer, answer_dim = pool
    B = counter.shape[0]
    k = grid.shape[0] // B
    idx = (torch.arange(B, dtype=torch.int64, device=grid.device) * k
           + (counter % k).long())
    st = init_state(grid[idx], dim[idx], answer[idx], answer_dim[idx],
                    max_trial=max_trial, reset_on_submit=reset_on_submit)
    return st


def merge_done(done: torch.Tensor, fresh: EnvState, old: EnvState
               ) -> EnvState:
    """Fresh rows where ``done``, the old ones elsewhere."""
    return EnvState(**{
        f: torch.where(done.view((-1,) + (1,) * (getattr(old, f).ndim - 1)),
                       getattr(fresh, f), getattr(old, f)) for f in FIELDS})


__all__ = ["Action", "EnvSpec", "EnvState", "FIELDS", "G", "OpTable",
           "bbox_actions", "color_table", "env_step", "fresh_from_pool",
           "init_state", "merge_done", "o2arc_table"]
