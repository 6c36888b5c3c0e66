from .rollout import Trajectory, rollout, gae, decode_bbox_actions
from .ppo import (
    PPOConfig, PPOBatch, batch_from_trajectory, ppo_loss, surrogate_loss,
    make_optimizer, train_step, clip_by_global_norm_,
)
from .agents import Agent, mlp_agent, gpt_agent
from .emaml import (
    EMAMLConfig, EMAMLState, init_emaml, emaml_train_step,
    make_chunked_train_step, make_meta_optimizer, sample_task_assignment,
    task_rollout,
)

__all__ = [
    "Trajectory", "rollout", "gae", "decode_bbox_actions",
    "PPOConfig", "PPOBatch", "batch_from_trajectory", "ppo_loss",
    "surrogate_loss", "make_optimizer", "train_step", "clip_by_global_norm_",
    "Agent", "mlp_agent", "gpt_agent", "EMAMLConfig", "EMAMLState",
    "init_emaml", "emaml_train_step", "make_chunked_train_step",
    "make_meta_optimizer", "sample_task_assignment", "task_rollout",
]
