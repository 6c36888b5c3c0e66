from .core import (
    ResetOptions, reset, ResetPool, BatchedState, BatchedEnv,
    make_reset_pool,
)
from .rollout import random_bbox_actions, random_bbox_rollout

__all__ = [
    "ResetOptions", "reset", "ResetPool", "BatchedState", "BatchedEnv",
    "make_reset_pool", "random_bbox_actions", "random_bbox_rollout",
]
