"""The FCPolicy configurations: the reference ARCLE agents' MLP over the
flattened FilterO2ARC observation, trained by PPO on O2ARCv2 envs."""

from __future__ import annotations

import math
from typing import List

import torch

from . import ParamSpec

DIGEST_OBS = True         # 2,710 bytes an env-step: keep a digest of it


def param_specs(config: dict) -> List[ParamSpec]:
    """lecun-normal kernels and zero biases.  The logits head is drawn at
    unit gain (the port's init uses 0.01), so that the policy is far from
    uniform and a log-probability that is off shows."""
    p = config["policy"]
    widths = [p["obs_dim"], *p["hidden"]]
    out: List[ParamSpec] = []
    for i in range(len(p["hidden"])):
        out.append((f"fc_{i}.weight", (widths[i + 1], widths[i]), "normal",
                    1.0 / math.sqrt(widths[i])))
        out.append((f"fc_{i}.bias", (widths[i + 1],), "const", 0.0))
    n_logits = sum(p["heads"])
    d = widths[-1]
    out += [("pi.weight", (n_logits, d), "normal", 1.0 / math.sqrt(d)),
            ("pi.bias", (n_logits,), "const", 0.0),
            ("vf.weight", (1, d), "normal", 1.0 / math.sqrt(d)),
            ("vf.bias", (1,), "const", 0.0)]
    return out


def env_config(config: dict, n_envs: int):
    from arcle_tpu_torch.utils import EnvConfig
    e = config["env"]
    return EnvConfig(family=e["family"], max_trial=e["max_trial"],
                     episode_limit=e["episode_limit"], n_envs=n_envs,
                     dataset=e["dataset"],
                     n_synthetic_tasks=e["n_synthetic_tasks"],
                     dense_reward=e["dense_reward"], augment=e["augment"],
                     reset_pool=e["reset_pool"])


def program_ppo(config: dict, traffic: dict, seed: int, device):
    """``training/train.py``: ``setup_ppo`` and ``ppo_iteration``."""
    from arcle_tpu_torch.training.ppo import PPOConfig
    from arcle_tpu_torch.training.train import ppo_iteration, setup_ppo
    from arcle_tpu_torch.utils import RunConfig
    L = config["learner"]
    ppo = PPOConfig(**{k: L[k] for k in (
        "gamma", "gae_lambda", "clip_eps", "vf_clip", "vf_coeff",
        "entropy_coeff", "kl_coeff", "lr", "n_epochs", "n_minibatches",
        "max_grad_norm", "bootstrap_truncation", "aux_coeff")})
    cfg = RunConfig(seed=seed, algo="ppo", model="mlp", total_iterations=1,
                    checkpoint_every=0, device=str(device),
                    env=env_config(config, traffic["n_envs"]), ppo=ppo,
                    mlp_hidden=tuple(config["policy"]["hidden"]),
                    mlp_dtype=config["precision"]["compute"])
    run = setup_ppo(cfg)
    run.n_steps = traffic["rollout_steps"]
    return run, lambda: ppo_iteration(run)


def program_env(config: dict, n_envs: int, seed: int, device):
    """The O2ARCv2 env of ``setup_ppo``, reset from the seed."""
    from arcle_tpu_torch.envs import BatchedEnv
    from arcle_tpu_torch.utils.config import make_loader, make_table
    ec = env_config(config, n_envs)
    env = BatchedEnv(table=make_table(ec),
                     bank=make_loader(ec).bank(device=device),
                     max_trial=ec.max_trial, episode_limit=ec.episode_limit,
                     auto_reset=True, dense_reward=ec.dense_reward,
                     augment=ec.augment, reset_pool=ec.reset_pool)
    from . import mix
    gen = torch.Generator(device=device).manual_seed(mix(seed, 1))
    return env, env.reset(gen, n_envs)


# ---- the reference -------------------------------------------------------
def policy_ref(config: dict):
    from cellbench.reference.mlp import MLPRef, observe
    ref = MLPRef(config["policy"])
    ref.observe = observe
    return ref


def env_spec(config: dict):
    from cellbench.reference import engine as E
    e = config["env"]
    if e["family"] != "o2arc_crop33":
        raise ValueError(f"env family {e['family']!r}")
    return E.EnvSpec(table=E.o2arc_table(e["max_trial"], crop_at_33=True),
                     episode_limit=e["episode_limit"],
                     dense_reward=e["dense_reward"],
                     max_trial=e["max_trial"])


def bank(config: dict, seed: int = 0, n_tasks=None):
    from cellbench.reference.tasks import Bank, synthetic_tasks
    e = config["env"]
    H, W = e["grid"]
    return Bank(synthetic_tasks(e["n_synthetic_tasks"], e["synthetic_seed"]),
                H, W, augment=e["augment"])

