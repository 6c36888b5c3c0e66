"""GPT training entry point.

Counterpart of ``arcle_tpu/training/train_gpt.py`` (the reference's
train_gpt.py): the trainer of ``train.py`` with the transformer policy (8
layers / 16 heads / 128 embd, train_gpt.py:65-80 == gptconfig.yaml), the
full flattened observation and the autoregressive operation + bbox action
head; E-MAML by default, in the reference's envelope (2 tasks x 1 env x
100-step rollouts, 20 inner / 5 meta-opt steps), first-order, with the
decomposed step, the cached chain and the KL read off the surrogate pass.

Run:  python -m arcle_tpu_torch.training.train_gpt --device cuda \\
          --iterations 100

``--device cuda`` without a CUDA card raises.
"""

from __future__ import annotations

import argparse

from torch import nn

from ..models.gpt import GPTConfig
from ..utils.config import RunConfig, EnvConfig
from .emaml import EMAMLConfig
from .ppo import PPOConfig
from .train import run_config


def parse_config(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m arcle_tpu_torch.training.train_gpt")
    ap.add_argument("--algo", default="emaml", choices=["ppo", "emaml"])
    ap.add_argument("--iterations", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dataset", default="synthetic")
    ap.add_argument("--log-file", default="train_gpt_log.jsonl")
    ap.add_argument("--ckpt-dir", default="./ckpts_gpt")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine and the learner")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--inner-steps", type=int, default=20,
                    help="inner-adaptation steps per task (reference: 20, "
                         "train_gpt.py:54)")
    ap.add_argument("--meta-steps", type=int, default=5,
                    help="meta-optimizer steps per iteration (reference: 5)")
    ap.add_argument("--envs-per-task", type=int, default=1,
                    help="lockstep envs per task (reference: 1 env/worker)")
    ap.add_argument("--rollout-steps", type=int, default=100,
                    help="rollout fragment length (reference: 100)")
    ap.add_argument("--n-micro", type=int, default=None,
                    help="gradient-accumulation chunks per per-task batch; "
                         "default keeps ~50-sample micro-batches")
    ap.add_argument("--no-remat", action="store_true",
                    help="disable per-block recomputation in the GPT "
                         "(faster backward, more activation memory)")
    ap.add_argument("--kl-ladder-grads", action="store_true",
                    help="backprop the inner-KL ladder term through its "
                         "own pass (reference MAMLLoss parity); default "
                         "reads the KL value off the surrogate pass and "
                         "drops the ~1e-7-weight gradient term "
                         "(EMAMLConfig.kl_ladder_grads)")
    ap.add_argument("--exact-chain", action="store_true",
                    help="re-replay the FOMAML inner chain at every "
                         "meta-opt step (the reference's replay semantics); "
                         "default caches the chain from the inner-"
                         "adaptation pass and transports deltas "
                         "(EMAMLConfig.cache_chain)")
    ap.add_argument("--aux-coeff", type=float, default=0.0,
                    help="weight of the action-conditioned auxiliary "
                         "losses (r_{t-1}/r_t/next-grid, paper §4.1.1); "
                         "0 = off (shipped-reference parity)")
    args = ap.parse_args(argv)

    # the aux losses need aux-target batches, which only the PPO trainer
    # builds, and they don't decompose over the E-MAML micro-batches
    if args.aux_coeff > 0.0 and args.algo != "ppo":
        ap.error("--aux-coeff > 0 requires --algo ppo (E-MAML batches "
                 "carry no aux targets, and aux terms don't decompose "
                 "over n_micro gradient accumulation)")

    gpt = GPTConfig(attn_chunk=256, remat=not args.no_remat) \
        if not args.smoke else GPTConfig(n_layer=2, n_head=4, n_embd=32)
    cfg = RunConfig(
        seed=args.seed, algo=args.algo, model="gpt",
        total_iterations=args.iterations,
        # every iteration: the supervisor (training/supervise.py) resumes
        # from the last one
        checkpoint_every=0 if args.smoke else 1,
        checkpoint_dir=args.ckpt_dir, device=args.device,
        env=EnvConfig(family="o2arc_crop33", max_trial=7,
                      episode_limit=10 if args.smoke else 100,
                      n_envs=8 if args.smoke else 64,
                      dataset=args.dataset,
                      n_synthetic_tasks=8 if args.smoke else 32),
        # 64-sample minibatches over the 6400-sample batch
        ppo=PPOConfig(n_epochs=1,
                      n_minibatches=1 if args.smoke else 100,
                      vf_coeff=0.5,       # train_gpt.py:61 (GPT uses 0.5)
                      aux_coeff=args.aux_coeff),
        # the reference envelope (train_gpt.py:47-55): 2 workers x (1 env x
        # 100-step rollouts) = 100 samples per task per inner step, 20
        # inner / 5 meta steps, first-order
        emaml=EMAMLConfig(
            n_tasks=2,
            envs_per_task=4 if args.smoke else args.envs_per_task,
            rollout_steps=10 if args.smoke else args.rollout_steps,
            inner_steps=1 if args.smoke else args.inner_steps,
            maml_opt_steps=1 if args.smoke else args.meta_steps,
            first_order=True,
            n_micro=1 if args.smoke else (
                args.n_micro if args.n_micro
                else max(2, (args.envs_per_task * args.rollout_steps)
                         // 50)),
            kl_ladder_grads=args.smoke or args.kl_ladder_grads,
            chunked=not args.smoke,
            cache_chain=not args.smoke and not args.exact_chain,
            ppo=PPOConfig(vf_coeff=0.5, aux_coeff=args.aux_coeff)),
        gpt=gpt)
    return cfg, args


def main(argv=None) -> nn.Module:
    cfg, args = parse_config(argv)
    return run_config(cfg, args, argv)


if __name__ == "__main__":
    main()
