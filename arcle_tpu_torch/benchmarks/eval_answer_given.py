"""Offline evaluator for answer-given benchmark checkpoints.

Counterpart of ``scripts/eval_answer_given.py``.  Runs deterministic
(argmax) and stochastic episodes from a checkpoint directory on fresh
tasks and reports the per-episode success rate, the paper's §4.1 headline
metric, without touching a live training run.

Usage::

    python -m arcle_tpu_torch.benchmarks.eval_answer_given \\
        --ckpt-dir ckpts_answer_given [--colors 10] [--n-envs 512] \\
        [--steps 50] [--device cuda]

``--device cuda`` (the default) without a CUDA card raises.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..training.rollout import decode_bbox_actions
from ..training.train import resolve_device
from ..utils.checkpoint import Checkpointer
from .answer_given import answer_given_agent, answer_given_env, make_policy


@torch.no_grad()
def evaluate(ckpt_dir: str, step: Optional[int] = None, n_envs: int = 512,
             steps: int = 50, colors: int = 10, size: int = 5,
             seed: int = 1234, arch: str = "color_eq", n_layer: int = 4,
             n_head: int = 4, n_embd: int = 128,
             bbox_dist: str = "categorical", setting: str = "random",
             env_seed: Optional[int] = None, device="cuda"
             ) -> Tuple[int, Dict[str, Dict[str, float]]]:
    """Evaluate the checkpoint of ``step`` (default: the latest) on
    ``n_envs`` episodes of at most ``steps`` steps without auto-reset, once
    with argmax actions and once sampling.  Returns ``(step, {mode:
    {"success_rate", "mean_final_wrong", "mean_solve_len"}})``.

    ``env_seed`` seeds the eval task bank.  It defaults to ``seed +
    900001``, a fixed offset, so that evaluating with the ``--seed`` of a
    training run still draws a *disjoint* task set (in the finite ARC
    setting the offset is what realises the train / eval split)."""
    dev = resolve_device(device)
    if env_seed is None:
        env_seed = seed + 900001
    ck = Checkpointer(ckpt_dir)
    it = ck.latest_step() if step is None else step
    if it is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    model = make_policy(h=size, w=size, colors=colors, n_layer=n_layer,
                        n_head=n_head, n_embd=n_embd,
                        factorized=(arch == "nonseq"),
                        color_equivariant=(arch == "color_eq"),
                        bbox_dist_kind=bbox_dist)
    model.load_state_dict(ck.restore(it, map_location="cpu")["params"])
    model.to(dev)
    agent = answer_given_agent(model, sequential=(arch == "sequential"))
    env = dataclasses.replace(
        answer_given_env(n_tasks=4096, h=size, w=size, colors=colors,
                         seed=env_seed, episode_limit=steps, setting=setting,
                         device=dev),
        auto_reset=False)

    out = {}
    for mode, det in (("deterministic", True), ("stochastic", False)):
        b = env.reset(torch.Generator(device=dev).manual_seed(seed + 1),
                      n_envs)
        act_gen = torch.Generator(device=dev).manual_seed(seed + 2)
        solved = torch.zeros(n_envs, dtype=torch.bool, device=dev)
        lens = torch.full((n_envs,), steps, dtype=torch.int32, device=dev)
        for t in range(steps):
            acts, _, _ = agent.sample_fn(model, agent.obs_fn(b.env), act_gen,
                                         det)
            b, _, _, term, _ = env.step(
                b, decode_bbox_actions(acts, size, size))
            lens = torch.where(term & ~solved, lens.clamp(max=t + 1), lens)
            solved |= term
        wrong = (b.env.grid != b.env.answer).sum(dim=(1, 2)).to(torch.float32)
        n_solved = int(solved.sum())
        out[mode] = {
            "success_rate": n_solved / n_envs,
            "mean_final_wrong": float(wrong[~solved].mean())
            if n_solved < n_envs else 0.0,
            "mean_solve_len": float(lens[solved].to(torch.float32).mean())
            if n_solved else float("nan"),
        }
        print(f"[iter {it}] {mode}: success {out[mode]['success_rate']:.3f}  "
              f"final-wrong(unsolved) {out[mode]['mean_final_wrong']:.2f}  "
              f"solve-len {out[mode]['mean_solve_len']:.1f}")
    return it, out


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m arcle_tpu_torch.benchmarks.eval_answer_given")
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--step", type=int, default=None)
    ap.add_argument("--n-envs", type=int, default=512)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--colors", type=int, default=10)
    ap.add_argument("--size", type=int, default=5)
    ap.add_argument("--arch", default="color_eq",
                    choices=["color_eq", "nonseq", "sequential"])
    ap.add_argument("--n-layer", type=int, default=4)
    ap.add_argument("--n-head", type=int, default=4)
    ap.add_argument("--n-embd", type=int, default=128)
    ap.add_argument("--bbox-dist", default="categorical",
                    choices=["categorical", "truncnorm"])
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--env-seed", type=int, default=None,
                    help="eval task-bank seed; default seed+900001 so "
                         "reusing the training --seed still evaluates "
                         "on a disjoint bank")
    ap.add_argument("--setting", default="random",
                    choices=["random", "arc"])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine and the policy")
    a = ap.parse_args(argv)
    return evaluate(a.ckpt_dir, a.step, a.n_envs, a.steps, a.colors, a.size,
                    a.seed, a.arch, a.n_layer, a.n_head, a.n_embd,
                    bbox_dist=a.bbox_dist, setting=a.setting,
                    env_seed=a.env_seed, device=a.device)


if __name__ == "__main__":
    main()
