"""Environment layer: the batched engine, augmentation, the random-action
rollout loop, the single-env engine and the Gymnasium adapters.

Where ``gymnasium`` imports, the adapters are registered under
``ARCLE-CUDA/*`` (the reference's IDs, arcle/envs/__init__.py:7-25, plus
the NoFill variant of agents/wrapper.py:61-65); ``ARCLE/*`` and
``ARCLE-TPU/*`` belong to ``arcle_tpu``.
"""

from .core import (
    ResetOptions, reset, ResetPool, BatchedState, BatchedEnv,
    make_reset_pool,
)
from .meta import augment_task, draw_augmentation, CustomO2ARCEnv
from .rollout import random_bbox_actions, random_bbox_rollout
from .single import TorchEngine
from .gym_compat import (
    TorchARCEnvBase, RawARCEnv, ARCEnv, O2ARCv2Env, O2ARCNoFillEnv,
    make_engine, gym,
)

GYM_IDS = (
    ("ARCLE-CUDA/RawARCEnv-v0", "arcle_tpu_torch.envs.gym_compat:RawARCEnv",
     None),
    ("ARCLE-CUDA/ARCEnv-v0", "arcle_tpu_torch.envs.gym_compat:ARCEnv", None),
    ("ARCLE-CUDA/O2ARCEnv-v2", "arcle_tpu_torch.envs.gym_compat:O2ARCv2Env",
     None),
    ("ARCLE-CUDA/O2ARCv2Env-v0",
     "arcle_tpu_torch.envs.gym_compat:O2ARCv2Env", None),
    ("ARCLE-CUDA/O2ARCNoFillEnv",
     "arcle_tpu_torch.envs.gym_compat:O2ARCNoFillEnv", 300),
    ("ARCLE-CUDA/CustomO2ARCEnv-v0",
     "arcle_tpu_torch.envs.meta:CustomO2ARCEnv", None),
)

if gym is not None:
    for _id, _ep, _steps in GYM_IDS:
        if _id not in gym.envs.registration.registry:
            gym.envs.registration.register(id=_id, entry_point=_ep,
                                           max_episode_steps=_steps)

__all__ = [
    "reset", "ResetOptions", "ResetPool", "BatchedState", "BatchedEnv",
    "make_reset_pool", "augment_task", "draw_augmentation",
    "random_bbox_actions", "random_bbox_rollout", "TorchEngine",
    "TorchARCEnvBase", "RawARCEnv", "ARCEnv", "O2ARCv2Env", "O2ARCNoFillEnv",
    "CustomO2ARCEnv", "make_engine", "GYM_IDS",
]
