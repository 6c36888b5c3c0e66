"""The answer-given configurations (ARCLE paper §4.1): the
colour-equivariant GPT policy on lockstep 5x5 envs with colour ops alone,
trained by PPO with the three auxiliary losses, or evaluated."""

from __future__ import annotations

import argparse
import math
from typing import List

import torch

from . import ParamSpec, mix

DIGEST_OBS = False        # the observation is small: keep it whole


def param_specs(config: dict) -> List[ParamSpec]:
    """The port's ``GPTPolicy`` leaves with the scale of its init: dense
    kernels lecun-normal, head kernels at the orthogonal init's entry
    scale, embeddings N(0, 1/width), the free tokens N(0, 0.02), the
    Fourier frequencies N(0, 0.15), LayerNorm 1 and 0, zero biases; but
    each head's last layer at unit gain (the port's init uses 0.01), so
    that the policy is far from uniform and a log-probability or a greedy
    action that is off shows."""
    p = config["policy"]
    C, nc, na = p["n_embd"], p["num_colors"], p["num_actions"]
    h, w = p["grid"]
    P = h * w
    nf = max(C // 8, 1)
    out: List[ParamSpec] = []

    def dense(name, d_in, d_out, gain=None):
        std = 1.0 / math.sqrt(d_in) if gain is None \
            else gain / math.sqrt(max(d_in, d_out))
        out.append((f"{name}.weight", (d_out, d_in), "normal", std))
        out.append((f"{name}.bias", (d_out,), "const", 0.0))

    def ln(name):
        out.append((f"{name}.weight", (C,), "const", 1.0))
        out.append((f"{name}.bias", (C,), "const", 0.0))

    emb = 1.0 / math.sqrt(C)
    out += [("color_encoder.weight", (nc, C), "normal", emb),
            ("operation_encoder.weight", (na, C), "normal", emb),
            ("trials_encoder.weight", (4, C), "normal", emb),
            ("active_encoder.weight", (2, C), "normal", emb),
            ("pos_emb", (1, P, C), "normal", 0.02),
            ("state_emb", (8, 1, C), "normal", 0.02),
            ("cls_tkn", (1, 1, C), "normal", 0.02),
            ("color_action_tkn", (1, 1, C), "normal", 0.02),
            ("bbox_encoder.coefficients", (4, nf), "normal", 0.15)]
    dense("bbox_encoder.encoder", 4 * 2 * nf, C)
    for i in range(p["n_layer"]):
        b = f"block_{i}"
        ln(f"{b}.LayerNorm_0")
        dense(f"{b}.SelfAttention_0.qkv", C, 3 * C)
        dense(f"{b}.SelfAttention_0.proj", C, C)
        ln(f"{b}.LayerNorm_1")
        dense(f"{b}.Dense_0", C, 4 * C)
        dense(f"{b}.Dense_1", 4 * C, C)
    ln("ln_f")
    heads = {"operation": 1, "bbox_mean": 4, "bbox_std": 4,
             "bbox_logits": 4 * p["bbox_bins"], "critic": 1, "aux_rtm1": 1,
             "aux_reward": 1, "aux_transition": nc}
    for name, n in heads.items():
        dense(f"head_{name}.Dense_0", C, C, math.sqrt(2))
        dense(f"head_{name}.Dense_1", C, C, math.sqrt(2))
        dense(f"head_{name}.Dense_2", C, n, 1.0)
    return out


def _args(config: dict, n_envs: int, rollout: int, seed: int,
          device) -> argparse.Namespace:
    """``train_answer_given.parse_args`` with the configuration's values."""
    from arcle_tpu_torch.training.train_answer_given import parse_args
    p, e, L = config["policy"], config["env"], config["learner"]
    argv = ["--setting", e["setting"], "--size", str(e["size"]),
            "--colors", str(e["colors"]), "--n-tasks", str(e["n_tasks"]),
            "--episode-limit", str(e["episode_limit"]),
            "--arch", p["arch"], "--aux", L["aux_terms"],
            "--aux-coeff", repr(L["aux_coeff"]),
            "--n-layer", str(p["n_layer"]), "--n-head", str(p["n_head"]),
            "--n-embd", str(p["n_embd"]), "--n-envs", str(n_envs),
            "--rollout", str(rollout), "--lr", repr(L["lr"]),
            "--gamma", repr(L["gamma"]), "--bbox-dist", p["bbox_dist"],
            "--min-log-std", repr(p["min_log_std"]),
            "--gae-lambda", repr(L["gae_lambda"]),
            "--clip", repr(L["clip_eps"]), "--vf-coeff", repr(L["vf_coeff"]),
            "--ent-coeff-start", repr(L["entropy_coeff"]),
            "--epochs", str(L["n_epochs"]),
            "--minibatches", str(L["n_minibatches"]),
            "--seed", str(seed), "--device", str(device)]
    if not L["potential_shaping"]:
        argv.append("--no-potential-shaping")
    return parse_args(argv)


def task_seed(seed: int) -> int:
    """The seed of the run's task bank: the random setting's numpy draws
    take 32 bits."""
    return mix(seed, 2) % (1 << 32)


def program_ppo(config: dict, traffic: dict, seed: int, device):
    """``training/train_answer_given.py``: ``setup`` and ``iteration`` at
    the entropy coefficient of iteration 0."""
    from arcle_tpu_torch.training import train_answer_given as tag
    args = _args(config, traffic["n_envs"], traffic["rollout_steps"],
                 task_seed(seed), device)
    run = tag.setup(args)
    ent = tag.ent_schedule(args, 0)
    return run, lambda: tag.iteration(run, ent)


def program_eval(config: dict, traffic: dict, seed: int, device):
    """The evaluator's policy and env (``benchmarks/eval_answer_given.py``):
    ``make_policy``, ``answer_given_agent``, and ``answer_given_env`` on
    ``traffic["n_tasks"]`` fresh tasks without auto-reset."""
    import dataclasses
    from arcle_tpu_torch.benchmarks.answer_given import (
        answer_given_agent, answer_given_env, make_policy)
    p, e = config["policy"], config["env"]
    model = make_policy(h=e["size"], w=e["size"], colors=e["colors"],
                        n_layer=p["n_layer"], n_head=p["n_head"],
                        n_embd=p["n_embd"], factorized=False,
                        color_equivariant=True,
                        bbox_dist_kind=p["bbox_dist"]).to(device)
    agent = answer_given_agent(model, min_log_std=p["min_log_std"])
    env = dataclasses.replace(
        answer_given_env(n_tasks=traffic["n_tasks"], h=e["size"],
                         w=e["size"], colors=e["colors"],
                         seed=task_seed(seed),
                         episode_limit=traffic["episode_steps"],
                         setting=e["setting"], device=device),
        auto_reset=False)
    return model, agent, env


# ---- the reference -------------------------------------------------------
def policy_ref(config: dict):
    from cellbench.reference.gpt import GPTRef, observe
    ref = GPTRef(config["policy"])
    ref.observe = observe
    return ref


def env_spec(config: dict, episode_limit=None):
    from cellbench.reference import engine as E
    e = config["env"]
    return E.EnvSpec(table=E.color_table(e["colors"]),
                     episode_limit=e["episode_limit"] if episode_limit
                     is None else episode_limit,
                     pixel_reward=e["pixel_reward"],
                     terminate_on_match=e["terminate_on_match"],
                     max_trial=-1)


def bank(config: dict, seed: int, n_tasks=None):
    from cellbench.reference.tasks import Bank, random_pairs
    e = config["env"]
    if e["setting"] != "random":
        raise ValueError(f"setting {e['setting']!r}")
    n = e["n_tasks"] if n_tasks is None else n_tasks
    return Bank(random_pairs(n, e["size"], e["size"], e["colors"],
                             task_seed(seed)), e["size"], e["size"],
                augment=False)

