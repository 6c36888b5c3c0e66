"""Reset-time augmentation of task pairs.

Counterpart of the functional part of ``arcle_tpu/envs/meta.py``: a random
rot90^k of each pair's h x w block, re-anchored at the origin, and one
colour permutation shared by grid and answer (the reference agents'
``CustomO2ARCEnv``, agents/env.py:31-42).  The transform is split from its
draw: :func:`augment_task` is deterministic given ``k`` and ``perm``, and
:func:`draw_augmentation` draws them per row from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core.geometry import roll_axis
from ..core.state import I8

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
