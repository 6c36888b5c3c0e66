"""E-MAML meta-training through the library API (the counterpart of
running the reference's agents/train.py, scaled to run anywhere in
seconds), on the card.  For full-scale runs use the drivers:

    python -m arcle_tpu_torch.training.train --algo emaml     # MLP
    python -m arcle_tpu_torch.training.supervise --log run.out -- \\
        python -m arcle_tpu_torch.training.train_gpt          # GPT

    python -m examples_torch.example_train_emaml [--device cuda|cpu]   # from the repo root
"""
import argparse

import torch

from arcle_tpu_torch.envs import BatchedEnv, ResetOptions
from arcle_tpu_torch.loaders import SyntheticLoader
from arcle_tpu_torch.models import FCPolicy
from arcle_tpu_torch.ops import o2arc_table
from arcle_tpu_torch.training import (
    EMAMLConfig, emaml_train_step, init_emaml, mlp_agent,
    sample_task_assignment,
)


def main(argv=None, iterations: int = 3):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda")
    dev = torch.device(p.parse_args(argv).device)
    bank = SyntheticLoader(8, seed=0).bank(device=dev)
    agent = mlp_agent(FCPolicy(hidden=(64, 32), n_ops=35))
    cfg = EMAMLConfig(n_tasks=2, envs_per_task=4, rollout_steps=10,
                      inner_steps=2, maml_opt_steps=2, first_order=True)
    st = init_emaml(agent, cfg, 0, n_bank_tasks=bank.n_tasks, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    metrics = []
    for it in range(iterations):
        # a fresh task sample per meta-iteration (reference emaml.py:349-361)
        assign = sample_task_assignment(gen, bank.n_tasks, cfg)
        env = BatchedEnv(table=o2arc_table(7, crop_at_33=True), bank=bank,
                         max_trial=7, episode_limit=10, auto_reset=True,
                         dense_reward=True, augment=True, reset_pool=4,
                         opts=ResetOptions.make(prob_index=assign,
                                                device=dev))
        bs = env.reset(gen, cfg.n_tasks * cfg.envs_per_task)
        st, bs, m = emaml_train_step(st, env, bs, agent, cfg)
        metrics.append(m)
        print(f"iter {it}: meta_loss={float(m['meta_loss']):.4f} "
              f"post_eprew={float(m['post_eprew_mean']):.3f} "
              f"covered={int(m['num_covered_tasks'])}")
    print("ok")
    return metrics


if __name__ == "__main__":
    main()
