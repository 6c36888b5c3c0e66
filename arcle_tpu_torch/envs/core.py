"""The batched lockstep engine.

Counterpart of ``arcle_tpu/envs/core.py``.  ``reset`` picks a (task, pair)
per env from a :class:`TaskBank` on the bank's device; randomness comes
from an explicit ``torch.Generator`` (a documented divergence from the JAX
package's keys: parity tests pin task indices and inject the same pool).

:meth:`BatchedEnv.step` goes through the CUDA step kernel when the state
lives on a CUDA device and through the plain PyTorch transition when it
lives on the CPU.  On CUDA the step asks the host nothing: the kernel
finishes flood fills itself, and auto-reset merges fresh rows with
``torch.where`` for every env.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..core.state import EnvState, Action, init_state, I8, I32, F32
from ..loaders.loader import TaskBank
from ..ops.table import (
    OpTable, dense_reward as _dense, pixel_reward as _pixel,
    answers_match_any as _match,
)
from ..ops.step_kernel import complete_step
from .meta import augment_task, draw_augmentation


def _env_rows(v: torch.Tensor, batch: int) -> torch.Tensor:
    """A scalar option broadcast to ``[batch]``, or a ``[batch]`` row."""
    if v.ndim == 0:
        return v.expand(batch)
    if tuple(v.shape) != (batch,):
        raise ValueError(f"per-env option of shape {tuple(v.shape)} for a "
                         f"batch of {batch}")
    return v


@dataclasses.dataclass(frozen=True)
class ResetOptions:
    """Reset options (the reference's ``options`` dict, base.py:87-93).
    Each field is a scalar, shared by all envs, or a per-env ``[B]`` row.
    A negative index means: draw it."""

    prob_index: torch.Tensor      # i32 [] or [B]
    subprob_index: torch.Tensor   # i32 [] or [B]
    adaptation: torch.Tensor      # bool [] or [B]
    reset_on_submit: torch.Tensor # bool [] or [B]

    @staticmethod
    def make(prob_index=-1, subprob_index=-1, adaptation=True,
             reset_on_submit=False, device="cuda") -> "ResetOptions":
        t = lambda v, dt: torch.as_tensor(v, device=device).to(dt)
        return ResetOptions(
            prob_index=t(prob_index, I32),
            subprob_index=t(subprob_index, I32),
            adaptation=t(adaptation, torch.bool),
            reset_on_submit=t(reset_on_submit, torch.bool))

    def to(self, device) -> "ResetOptions":
        return ResetOptions(**{f.name: getattr(self, f.name).to(device)
                               for f in dataclasses.fields(self)})

    def rows(self, batch: int, device) -> "ResetOptions":
        """Every field as a ``[batch]`` row on ``device``."""
        return ResetOptions(**{
            f.name: _env_rows(getattr(self, f.name), batch).to(device)
            for f in dataclasses.fields(self)})


def reset(bank: TaskBank, generator: torch.Generator, opts: ResetOptions,
          batch: int, max_trial: int = -1,
          augment: bool = False) -> EnvState:
    """Fresh states for ``batch`` envs: pick (task, pair), initialise.

    ``augment`` applies the reset-time rot90 + colour permutation
    (:mod:`.meta`) to the chosen pairs, drawn from ``generator``.
    """
    dev = bank.device
    o = opts.rows(batch, dev)
    draw_task = torch.randint(0, bank.n_tasks, (batch,), generator=generator,
                              device=dev, dtype=I32)
    draw_pair = torch.randint(0, 1 << 30, (batch,), generator=generator,
                              device=dev, dtype=I32)
    prob = torch.where(o.prob_index >= 0, o.prob_index, draw_task)
    count = bank.pair_count(prob, o.adaptation)
    sub = torch.where(o.subprob_index >= 0, o.subprob_index,
                      draw_pair % torch.clamp(count, min=1))
    flat = bank.pair_index(prob, sub, o.adaptation).long()
    grid, dim = bank.in_grids[flat], bank.in_dims[flat]
    answer, answer_dim = bank.out_grids[flat], bank.out_dims[flat]
    if augment:
        k, perm = draw_augmentation(generator, batch, dev)
        grid, dim, answer, answer_dim = augment_task(grid, dim, answer,
                                                     answer_dim, k, perm)
    return init_state(grid, dim, answer, answer_dim, max_trial=max_trial,
                      reset_on_submit=o.reset_on_submit.to(I8))


@dataclasses.dataclass(frozen=True)
class ResetPool:
    """Pre-drawn fresh episodes for auto-reset.  Env slot ``i`` owns rows
    ``[i*K, (i+1)*K)``, drawn with slot ``i``'s options; ``counter`` walks
    each slot's rows and wraps past K."""

    grid: torch.Tensor        # i8 [B*K, H, W] input masked to its dims
    dim: torch.Tensor         # i8 [B*K, 2]
    answer: torch.Tensor      # i8 [B*K, H, W]
    answer_dim: torch.Tensor  # i8 [B*K, 2]
    counter: torch.Tensor     # i32 [B] next row per env slot

    @property
    def k(self) -> int:
        return self.grid.shape[0] // self.counter.shape[0]


@dataclasses.dataclass(frozen=True)
class BatchedState:
    """Carry of a lockstep batch: env states, the generator of auto-reset
    draws, and the optional reset pool."""

    env: EnvState
    generator: torch.Generator
    pool: Optional[ResetPool] = None

    @property
    def batch(self) -> int:
        return self.env.batch


@dataclasses.dataclass(frozen=True)
class BatchedEnv:
    """Vectorised env family over a task bank.

    ``auto_reset`` replaces terminated or truncated envs with fresh tasks;
    ``episode_limit`` is the TimeLimit the reference's drivers use; with
    ``reset_pool`` K > 0 the fresh states come from a K-deep
    :class:`ResetPool`.  The bank's device is the engine's device.
    """

    table: OpTable
    bank: TaskBank
    max_trial: int = -1
    episode_limit: int = 0          # 0 = unlimited
    auto_reset: bool = True
    dense_reward: bool = False      # CustomO2ARCEnv shaping
    pixel_reward: bool = False      # paper §4.1: -(incorrect/total)
    terminate_on_match: bool = False
    augment: bool = False           # reset-time rot90 + recolour (meta.py)
    reset_pool: int = 0
    opts: Optional[ResetOptions] = None     # None: the defaults

    def __post_init__(self):
        # the options live beside the bank: a blocking host-to-device copy
        # waits for the stream, so options left on the host would make
        # every auto-reset step wait for the device
        opts = ResetOptions.make(device=self.device) if self.opts is None \
            else self.opts.to(self.device)
        object.__setattr__(self, "opts", opts)

    @property
    def device(self) -> torch.device:
        return self.bank.device

    def reset(self, generator: torch.Generator, batch: int) -> BatchedState:
        env = reset(self.bank, generator, self.opts, batch, self.max_trial,
                    self.augment)
        pool = (make_reset_pool(self, generator, batch)
                if self.reset_pool > 0 and self.auto_reset else None)
        return BatchedState(env=env, generator=generator, pool=pool)

    def step(self, bs: BatchedState, action: Action
             ) -> Tuple[BatchedState, EnvState, torch.Tensor, torch.Tensor,
                        torch.Tensor]:
        """Lockstep step: returns ``(carry, obs, reward, terminated,
        truncated)``; ``obs`` is the post-step state before auto-reset."""
        env2, reward, term = complete_step(bs.env, action, self.table)
        env2, reward, term = self._shape_reward_term(env2, reward, term)
        if self.episode_limit > 0:
            trunc = env2.steps >= self.episode_limit
        else:
            trunc = torch.zeros_like(term)
        if not self.auto_reset:
            return (BatchedState(env=env2, generator=bs.generator,
                                 pool=bs.pool), env2, reward, term, trunc)
        return self._auto_reset(env2, bs, term | trunc), env2, reward, \
            term, trunc

    def _shape_reward_term(self, env2: EnvState, reward: torch.Tensor,
                           term: torch.Tensor):
        """Optional reward shaping and success termination on the post-op
        state."""
        W = int(self.bank.in_grids.shape[-1])
        if self.dense_reward:
            reward = _dense(env2, reward)
        if self.pixel_reward:
            reward = _pixel(env2, W)
        if self.terminate_on_match:
            solved = _match(env2, W)
            env2 = env2.replace(terminated=torch.maximum(
                env2.terminated, solved.to(I8)))
            term = env2.terminated != 0
        return env2, reward, term

    def _fresh_from_pool(self, pool: ResetPool, batch: int) -> EnvState:
        """The next pre-drawn fresh state of every env slot."""
        dev = pool.grid.device
        k = pool.k
        idx = (torch.arange(batch, dtype=torch.int64, device=dev) * k
               + (pool.counter % k).long())
        grid0, dim = pool.grid[idx], pool.dim[idx]
        zg, zd = torch.zeros_like(grid0), torch.zeros_like(dim)
        zs = torch.zeros((batch,), dtype=I8, device=dev)
        ros = _env_rows(self.opts.reset_on_submit, batch).to(
            device=dev, dtype=I8).contiguous()
        return EnvState(
            trials_remain=torch.full((batch,), self.max_trial, dtype=I8,
                                     device=dev),
            terminated=zs, input=grid0, input_dim=dim, grid=grid0,
            grid_dim=dim, clip=zg, clip_dim=zd, selected=zg, active=zs,
            object=zg, object_sel=zg, object_dim=zd, object_pos=zd,
            background=zg, rotation_parity=zs,
            answer=pool.answer[idx], answer_dim=pool.answer_dim[idx],
            reset_on_submit=ros,
            steps=torch.zeros((batch,), dtype=I32, device=dev),
            submit_count=torch.zeros((batch,), dtype=I32, device=dev),
            last_action_op=torch.full((batch,), -1, dtype=I32, device=dev),
            last_reward=torch.zeros((batch,), dtype=F32, device=dev),
        )

    def _auto_reset(self, env2: EnvState, bs: BatchedState,
                    done: torch.Tensor) -> BatchedState:
        """Replace done envs with fresh states, from the pool when one rides
        the carry, else freshly drawn.  Rows are merged with
        ``torch.where`` for the whole batch, so the host is never asked
        whether any env is done."""
        B = env2.batch
        if bs.pool is not None:
            fresh = self._fresh_from_pool(bs.pool, B)
            pool = dataclasses.replace(
                bs.pool, counter=bs.pool.counter + done.to(I32))
        else:
            fresh = reset(self.bank, bs.generator, self.opts, B,
                          self.max_trial, self.augment)
            pool = None
        env3 = EnvState(**{
            f.name: torch.where(
                done.view((-1,) + (1,) * (getattr(env2, f.name).ndim - 1)),
                getattr(fresh, f.name), getattr(env2, f.name))
            for f in dataclasses.fields(EnvState)})
        return BatchedState(env=env3, generator=bs.generator, pool=pool)


def make_reset_pool(env: BatchedEnv, generator: torch.Generator, batch: int,
                    k: Optional[int] = None) -> ResetPool:
    """Draw ``k`` fresh (task, pair, augmentation) rows per env slot in one
    batch; slot
    ``i``'s rows use its own per-env options, so task pinning holds."""
    k = env.reset_pool if k is None else k
    rows = env.opts.rows(batch, env.device)
    opts = ResetOptions(**{f.name: torch.repeat_interleave(
        getattr(rows, f.name), k) for f in dataclasses.fields(rows)})
    fresh = reset(env.bank, generator, opts, batch * k, env.max_trial,
                  env.augment)
    return ResetPool(grid=fresh.grid, dim=fresh.grid_dim,
                     answer=fresh.answer, answer_dim=fresh.answer_dim,
                     counter=torch.zeros((batch,), dtype=I32,
                                         device=env.device))
