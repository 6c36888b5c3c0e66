"""1024 lockstep O2ARCv2 envs on the card (the port's main surface; no
reference counterpart).  ``--device cpu`` runs the plain transition.

    python -m examples_torch.example_batched [--device cuda|cpu]   # from the repo root
"""
import argparse

import numpy as np
import torch

from arcle_tpu_torch.core import Action
from arcle_tpu_torch.envs import BatchedEnv
from arcle_tpu_torch.loaders import SyntheticLoader
from arcle_tpu_torch.ops import o2arc_table


def main(argv=None, batch: int = 1024, steps: int = 20):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda")
    dev = torch.device(p.parse_args(argv).device)
    env = BatchedEnv(table=o2arc_table(max_trial=3),
                     bank=SyntheticLoader(16).bank(device=dev),
                     max_trial=3, episode_limit=100, auto_reset=True)
    bs = env.reset(torch.Generator(device=dev).manual_seed(0), batch)
    rng = np.random.default_rng(0)
    for _ in range(steps):
        act = Action(
            selection=torch.from_numpy(rng.integers(
                0, 2, (batch, 30, 30)).astype(np.int8)).to(dev),
            operation=torch.from_numpy(rng.integers(
                0, 35, (batch,)).astype(np.int32)).to(dev))
        bs, obs, rew, term, trunc = env.step(bs, act)
    print("total reward:", float(rew.sum()))
    return float(rew.sum())


if __name__ == "__main__":
    main()
