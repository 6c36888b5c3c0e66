"""The meta-RL environment layer.

Counterpart of ``arcle_tpu/envs/meta.py``, after the reference agents'
``CustomO2ARCEnv`` (agents/env.py:14-87).  For the batched engine, the
reset-time augmentation of task pairs: a random rot90^k of each pair's
h x w block, re-anchored at the origin, and one colour permutation shared
by grid and answer (agents/env.py:31-42).  The transform is split from its
draw: :func:`augment_task` is deterministic given ``k`` and ``perm``, and
:func:`draw_augmentation` draws them per row from a ``torch.Generator``.
For one env, the Gymnasium adapter :class:`CustomO2ARCEnv`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.geometry import roll_axis
from ..core.state import I8
from ..ops.table import OpTable, o2arc_table
from .gym_compat import O2ARCv2Env

COLORS = 10


def draw_augmentation(generator: torch.Generator, batch: int, device,
                      colors: int = COLORS
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per row: a rotation count ``k`` in [0, 4) (int64 ``[B]``) and a
    uniform permutation of the colours (int8 ``[B, colors]``, the argsort
    of uniforms)."""
    k = torch.randint(0, 4, (batch,), generator=generator, device=device)
    u = torch.rand((batch, colors), generator=generator, device=device)
    return k, torch.argsort(u, dim=1).to(I8)


def _recolor(g: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """``perm[b][g[b]]`` per cell; values outside the colour range stay."""
    B, H, W = g.shape
    colors = perm.shape[1]
    idx = g.long().clamp(0, colors - 1).view(B, H * W)
    mapped = torch.gather(perm, 1, idx).view(B, H, W)
    inside = (g >= 0) & (g < colors)
    return torch.where(inside, mapped, g)


def _rot_padded(g: torch.Tensor, dim: torch.Tensor, k: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """rot90^k of each row's block, rolled back to the origin: for k=1 the
    block lands at rows [W-w, W), for k=2 at both far edges, for k=3 at
    columns [H-h, H)."""
    _, H, W = g.shape
    if H != W:
        raise ValueError(f"augment_task: rotation needs square grids, got "
                         f"{H}x{W}")
    h, w = dim[:, 0].long(), dim[:, 1].long()
    g1 = roll_axis(torch.rot90(g, 1, dims=(1, 2)), w - W, 1)
    g2 = roll_axis(roll_axis(torch.rot90(g, 2, dims=(1, 2)), h - H, 1),
                   w - W, 2)
    g3 = roll_axis(torch.rot90(g, 3, dims=(1, 2)), h - H, 2)
    kk = k.view(-1, 1, 1)
    out = torch.where(kk == 0, g, torch.where(
        kk == 1, g1, torch.where(kk == 2, g2, g3)))
    odd = (k % 2 == 1).view(-1, 1)
    return out, torch.where(odd, dim.flip(1), dim).to(I8)


def augment_task(grid: torch.Tensor, dim: torch.Tensor, answer: torch.Tensor,
                 answer_dim: torch.Tensor, k: torch.Tensor,
                 perm: torch.Tensor):
    """Rotate and recolour a batch of padded (grid, answer) pairs.

    ``grid`` / ``answer`` are int8 ``[B, N, N]``, the dims int8 ``[B, 2]``,
    ``k`` ``[B]`` in [0, 4) and ``perm`` ``[B, colors]``.  For odd ``k``
    the dims swap.  Background 0 is permuted too, as in the reference.
    Returns ``(grid, dim, answer, answer_dim)``.
    """
    perm = perm.to(I8)
    grid, dim = _rot_padded(_recolor(grid, perm), dim, k)
    answer, answer_dim = _rot_padded(_recolor(answer, perm), answer_dim, k)
    return grid, dim, answer, answer_dim


class CustomO2ARCEnv(O2ARCv2Env):
    """O2ARC with CropGrid at op 33, augmentation, the dense reward, and
    the TaskSettable API (agents/env.py:14-87), without Ray."""

    def __init__(self, data_loader=None, max_grid_size=(30, 30), colors=10,
                 max_trial=-1, render_mode=None, render_size=None,
                 augment: bool = True, dense: bool = True,
                 backend: str = "auto", device="cuda"):
        self.augment = augment
        self.dense = dense
        super().__init__(data_loader, max_grid_size, colors, max_trial,
                         render_mode, render_size, backend, device)
        self.reset_options = {"adaptation": True, "prob_index": None}

    def _make_table(self, max_trial: int) -> OpTable:
        return o2arc_table(max_trial, crop_at_33=True)

    def reset(self, seed=None, options=None):
        obs, info = super().reset(seed, self.reset_options)
        if self.augment:
            k = int(self.np_random.integers(0, 4))
            perm = self.np_random.permutation(10).astype(np.int8)
            self.input_ = np.copy(np.rot90(perm[self.input_], k=k))
            self.answer = np.copy(np.rot90(perm[self.answer], k=k))
            self._reset_engine()
            obs, info = self._observation(), self.init_info()
            self.info = info
        return obs, info

    def step(self, action: Dict):
        obs, sparse, term, trunc, info = super().step(action)
        if self.dense:
            reward = self._dense_reward(obs, sparse)
            self.last_reward = reward
            return obs, reward, term, trunc, info
        return obs, sparse, term, trunc, info

    def _dense_reward(self, obs: Dict, sparse: float) -> float:
        """agents/env.py:44-58 in numpy."""
        h, w = (int(v) for v in obs["grid_dim"])
        Ha, Wa = self.answer.shape
        minh, minw = min(h, Ha), min(w, Wa)
        total = minh * minw
        correct = int(np.sum(
            obs["grid"][:minh, :minw] == self.answer[:minh, :minw]))
        if (h <= Ha) == (w <= Wa):
            total += abs(Ha * Wa - h * w)
        else:
            total += abs(h - Ha) * minw + abs(w - Wa) * minh
        return sparse * 100.0 - 1.0 + correct / total

    # ---- TaskSettableEnv API (agents/env.py:66-87) ----
    def sample_tasks(self, n_tasks: int) -> List[int]:
        return list(np.random.choice(len(self.loader.data), n_tasks,
                                     replace=False))

    def get_task(self) -> Optional[int]:
        return self.reset_options.get("prob_index")

    def set_task(self, task: int) -> None:
        self.reset_options = {"adaptation": True, "prob_index": int(task)}
        super(O2ARCv2Env, self).reset(options=self.reset_options)

    def init_adaptation(self) -> None:
        self.adaptation = True
        self.reset_options["adaptation"] = True
        super(O2ARCv2Env, self).reset(options=self.reset_options)

    def post_adaptation(self) -> None:
        self.adaptation = False
        self.reset_options["adaptation"] = False
        super(O2ARCv2Env, self).reset(options=self.reset_options)
