"""Run configuration.

Counterpart of ``arcle_tpu/utils/config.py``: one serialisable
dataclass tree per run.  The JAX package's ``ppo_chunked`` (two jitted
units instead of one fused program, a TPU runtime's workaround) has no
meaning in eager PyTorch and is left out.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple

from ..models.gpt import GPTConfig
from ..training.emaml import EMAMLConfig
from ..training.ppo import PPOConfig


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    # raw | arc | o2arc | o2arc_crop33 | o2arc_nofill
    family: str = "o2arc"
    max_trial: int = 127            # train.py:62 (max_trial=127)
    episode_limit: int = 100        # TimeLimit(100), train.py:67
    n_envs: int = 4096
    dataset: str = "synthetic"      # synthetic | arc | miniarc
    n_synthetic_tasks: int = 32
    dense_reward: bool = True       # CustomO2ARCEnv shaping
    augment: bool = True
    reset_pool: int = 8             # K>0: per-rollout pre-drawn auto-reset
                                    # pool (envs.core.ResetPool); 0 = off


@dataclasses.dataclass(frozen=True)
class RunConfig:
    seed: int = 0
    algo: str = "ppo"               # ppo | emaml
    model: str = "mlp"              # mlp | gpt
    total_iterations: int = 1000
    checkpoint_every: int = 10      # algo.save cadence (train.py:153-154)
    log_every: int = 1
    checkpoint_dir: str = "./ckpts"
    device: str = "cuda"            # the engine's and the learner's device
    env: EnvConfig = dataclasses.field(default_factory=EnvConfig)
    ppo: PPOConfig = dataclasses.field(default_factory=PPOConfig)
    emaml: EMAMLConfig = dataclasses.field(default_factory=EMAMLConfig)
    gpt: GPTConfig = dataclasses.field(default_factory=GPTConfig)
    mlp_hidden: Tuple[int, ...] = (1024, 1024, 512, 512, 256, 128)
    mlp_dtype: str = "float32"      # torso compute dtype: float32 | bfloat16

    def to_json(self) -> str:
        """The tree as JSON; a torch dtype becomes its name
        (``"torch.bfloat16"``)."""
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)


def make_table(env_cfg: EnvConfig):
    from ..ops import raw_table, arc_table, o2arc_table
    f = env_cfg.family
    if f == "raw":
        return raw_table(env_cfg.max_trial)
    if f == "arc":
        return arc_table(env_cfg.max_trial)
    if f == "o2arc_crop33":
        return o2arc_table(env_cfg.max_trial, crop_at_33=True)
    if f == "o2arc_nofill":
        return o2arc_table(env_cfg.max_trial, no_fill=True)
    return o2arc_table(env_cfg.max_trial)


def make_loader(env_cfg: EnvConfig):
    from ..loaders import ARCLoader, MiniARCLoader, SyntheticLoader
    if env_cfg.dataset == "arc":
        return ARCLoader()
    if env_cfg.dataset == "miniarc":
        return MiniARCLoader()
    return SyntheticLoader(env_cfg.n_synthetic_tasks, seed=7)
