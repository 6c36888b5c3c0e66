"""A rollout driver with random bbox actions.

Counterpart of the loop that ``bench.py::bench_tpu`` times: every step
draws a random op and a random bounding-box selection per env from a
``torch.Generator`` on the engine's device, and steps the batch with
auto-reset.  The checksum of the final carry is a device tensor, so the
loop itself never waits for the device.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..core.geometry import bbox_selection, point_selection
from ..core.state import Action, I32, F32
from .core import BatchedEnv, BatchedState


def random_bbox_actions(generator: torch.Generator, batch: int, n_ops: int,
                        H: int, W: int, device) -> Action:
    """Uniform ops and two uniform corners per env (the BBoxWrapper action
    surface)."""
    ops = torch.randint(0, n_ops, (batch,), generator=generator,
                        device=device, dtype=I32)
    corners = torch.randint(0, H, (4, batch), generator=generator,
                            device=device, dtype=I32)
    sel = bbox_selection(corners[0], corners[1], corners[2], corners[3], H, W)
    return Action(selection=sel, operation=ops)


def random_point_actions(generator: torch.Generator, batch: int, n_ops: int,
                         H: int, W: int, device) -> Action:
    """Uniform ops and one uniform pixel per env (the PointWrapper action
    surface)."""
    ops = torch.randint(0, n_ops, (batch,), generator=generator,
                        device=device, dtype=I32)
    points = torch.randint(0, H, (2, batch), generator=generator,
                           device=device, dtype=I32)
    return Action(selection=point_selection(points[0], points[1], H, W),
                  operation=ops)


def random_bbox_rollout(env: BatchedEnv, bs: BatchedState, steps: int,
                        generator: torch.Generator,
                        draw: Callable = random_bbox_actions
                        ) -> Tuple[BatchedState, torch.Tensor]:
    """Run ``steps`` lockstep steps with random bbox actions (or those of
    ``draw``, e.g. :func:`random_point_actions`).

    Returns the final carry and an int64 checksum: the sum of the final
    grids, of the step counters and of the rewards of all steps.
    """
    B = bs.batch
    H, W = bs.env.hw
    dev = bs.env.grid.device
    rewards = torch.zeros((), dtype=F32, device=dev)
    for _ in range(steps):
        act = draw(generator, B, env.table.n_ops, H, W, dev)
        bs, _obs, rew, _term, _trunc = env.step(bs, act)
        rewards = rewards + rew.sum()
    chk = (bs.env.grid.to(torch.int64).sum()
           + bs.env.steps.to(torch.int64).sum() + rewards.to(torch.int64))
    return bs, chk
