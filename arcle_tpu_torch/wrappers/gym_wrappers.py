"""Gymnasium wrappers of the adapters: ``BBoxWrapper`` and
``PointWrapper`` (the reference's wrappers/bbox.py:9-49) and
``FilterO2ARC`` (agents/env.py:89-126).  Counterpart of the gym classes
of ``arcle_tpu/wrappers/__init__.py``.  This module needs ``gymnasium``;
the package imports it only where gymnasium imports.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Tuple

import gymnasium as gym
import numpy as np
from gymnasium import spaces


class BBoxWrapper(gym.ActionWrapper):
    """``(x1, y1, x2, y2, op)`` -> a rectangular selection action."""

    def __init__(self, env: gym.Env):
        super().__init__(env)
        u = env.unwrapped
        self.action_space = spaces.Tuple((
            spaces.Discrete(u.H), spaces.Discrete(u.W),
            spaces.Discrete(u.H), spaces.Discrete(u.W),
            spaces.Discrete(len(u.operations)),
        ))

    def action(self, action: Tuple):
        x1, y1, x2, y2, op = action
        u = self.env.unwrapped
        sel = np.zeros((u.H, u.W), np.int8)
        x1, x2 = min(x1, x2), max(x1, x2)
        y1, y2 = min(y1, y2), max(y1, y2)
        sel[x1:x2 + 1, y1:y2 + 1] = 1
        return {"selection": sel, "operation": op}


class PointWrapper(gym.ActionWrapper):
    """``(x, y, op)`` -> a one-pixel selection action."""

    def __init__(self, env: gym.Env):
        super().__init__(env)
        u = env.unwrapped
        self.action_space = spaces.Tuple((
            spaces.Discrete(u.H), spaces.Discrete(u.W),
            spaces.Discrete(len(u.operations)),
        ))

    def action(self, action: Tuple):
        x, y, op = action
        u = self.env.unwrapped
        sel = np.zeros((u.H, u.W), np.int8)
        sel[x, y] = 1
        return {"selection": sel, "operation": op}


class FilterO2ARC(gym.ObservationWrapper):
    """Project the O2ARC dict obs to 9 keys for MLP training
    (agents/env.py:89-126)."""

    def __init__(self, env: gym.Env):
        super().__init__(env)
        u = env.unwrapped
        H, W = u.H, u.W
        box = lambda lo, hi: spaces.Box(low=np.array(lo), high=np.array(hi),
                                        dtype=np.int8)
        grid = lambda: spaces.Box(0, u.colors, (H, W), dtype=np.int8)
        self.observation_space = spaces.Dict({
            "trials_remain": spaces.Box(-1, u.max_trial, shape=(1,),
                                        dtype=np.int8),
            "grid": grid(),
            "grid_dim": box([1, 1], [H, W]),
            "clip": grid(),
            "clip_dim": box([0, 0], [H, W]),
            "active": spaces.MultiBinary(1),
            "object": grid(),
            "object_dim": box([0, 0], [H, W]),
            "object_pos": box([-128, -128], [127, 127]),
        })

    def observation(self, observation):
        o2s = observation["object_states"]
        return OrderedDict([
            ("trials_remain", observation["trials_remain"]),
            ("grid", observation["grid"]),
            ("grid_dim", observation["grid_dim"]),
            ("clip", observation["clip"]),
            ("clip_dim", observation["clip_dim"]),
            ("active", o2s["active"]),
            ("object", o2s["object"]),
            ("object_dim", o2s["object_dim"]),
            ("object_pos", o2s["object_pos"]),
        ])


__all__ = ["BBoxWrapper", "PointWrapper", "FilterO2ARC"]
