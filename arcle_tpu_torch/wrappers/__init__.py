"""Action constructors and observation flattening for the batched engine.

Counterpart of the functional part of ``arcle_tpu/wrappers/__init__.py``
(reference wrappers/bbox.py:9-49 and the FilterO2ARC projection of
agents/env.py:89-126).  Every function takes batched tensors: grids
``[B, H, W]``, per-env scalars ``[B]``.  The Gymnasium wrappers of the
single-env adapters (``BBoxWrapper``, ``PointWrapper``, ``FilterO2ARC``,
:mod:`.gym_wrappers`) are defined here only where ``gymnasium`` imports.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict

import torch

from ..core.geometry import bbox_selection, point_selection
from ..core.state import Action, EnvState, I8, I32


def _ops(op) -> torch.Tensor:
    # contiguous: the step kernel reads the ops as a dense int32 row, and
    # ``op`` is often a column of an ``[B, 5]`` action tensor
    return torch.as_tensor(op).to(I32).contiguous()


def bbox_action(x1, y1, x2, y2, op, H: int = 30, W: int = 30) -> Action:
    """Per env ``(x1, y1, x2, y2, op)`` -> a rectangular selection action
    (bbox.py:22-30)."""
    return Action(selection=bbox_selection(x1, y1, x2, y2, H, W),
                  operation=_ops(op))


def point_action(x, y, op, H: int = 30, W: int = 30) -> Action:
    """Per env ``(x, y, op)`` -> a one-pixel selection action
    (bbox.py:43-49)."""
    return Action(selection=point_selection(x, y, H, W), operation=_ops(op))


# the JAX package vmaps its single-env constructors; these take batches
batched_bbox_action = bbox_action
batched_point_action = point_action


# The 9-key observation projection of FilterO2ARC (agents/env.py:109-126).
FILTER_O2ARC_KEYS = ("trials_remain", "grid", "grid_dim", "clip", "clip_dim",
                     "active", "object", "object_dim", "object_pos")


def filter_obs(state: EnvState) -> Dict[str, torch.Tensor]:
    """Project a batched state to the FilterO2ARC key set."""
    return OrderedDict((k, getattr(state, k)) for k in FILTER_O2ARC_KEYS)


def _flat_fields(state: EnvState, keys) -> torch.Tensor:
    """The fields ``keys`` of a batched state as one int8 ``[B, n]`` row
    per env: grids flattened, scalars given an axis."""
    return torch.cat([getattr(state, k).reshape(state.batch, -1).to(I8)
                      for k in keys], dim=1)


def flatten_obs(state: EnvState) -> torch.Tensor:
    """FilterO2ARC + FlattenObservation: the keys concatenated in sorted
    order (Gymnasium's Dict flattening), as int8 ``[B, 3*H*W + 10]``
    (2710 at 30x30).  Every field fits int8; models cast on entry."""
    return _flat_fields(state, sorted(FILTER_O2ARC_KEYS))


# Full 16-field flattening in the reference's FlattenObservation order
# (GPTPolicy.unflatten_vec hard-codes it, GPTPolicy.py:17-42): Dict keys
# alphabetical with object_states nested between input_dim and selected.
FULL_OBS_FIELDS = (
    ("clip", 900), ("clip_dim", 2), ("grid", 900), ("grid_dim", 2),
    ("input", 900), ("input_dim", 2), ("active", 1), ("background", 900),
    ("object", 900), ("object_dim", 2), ("object_pos", 2),
    ("object_sel", 900), ("rotation_parity", 1), ("selected", 900),
    ("terminated", 1), ("trials_remain", 1),
)
FULL_OBS_DIM = sum(n for _, n in FULL_OBS_FIELDS)   # 6314


def full_flatten_obs(state: EnvState) -> torch.Tensor:
    """The full int8 ``[B, 6314]`` observation vector (the GPT path, which
    feeds the complete flattened dict)."""
    return _flat_fields(state, [k for k, _ in FULL_OBS_FIELDS])


def unflatten_full(obs: torch.Tensor, H: int = 30, W: int = 30
                   ) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`full_flatten_obs` -> dict of int32 tensors."""
    out = {}
    ofs = 0
    for k, n in FULL_OBS_FIELDS:
        v = obs[..., ofs:ofs + n]
        ofs += n
        if n == 900:
            v = v.reshape(*v.shape[:-1], H, W)
        elif n == 1:
            v = v.squeeze(-1)
        out[k] = v.to(I32)
    return out


__all__ = [
    "bbox_action", "point_action", "batched_bbox_action",
    "batched_point_action", "filter_obs", "flatten_obs",
    "full_flatten_obs", "unflatten_full", "FULL_OBS_FIELDS", "FULL_OBS_DIM",
    "FILTER_O2ARC_KEYS",
]

try:
    import gymnasium  # noqa: F401
except ImportError:
    gymnasium = None
if gymnasium is not None:
    from .gym_wrappers import BBoxWrapper, PointWrapper, FilterO2ARC
    __all__ += ["BBoxWrapper", "PointWrapper", "FilterO2ARC"]
