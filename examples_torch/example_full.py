"""Full-featured usage (counterpart of the reference's
examples/example_full.py): ``gym.make`` an O2ARC env with all options and
take random actions, on the card.

    python -m examples_torch.example_full [--device cuda|cpu]   # from the repo root
"""
import argparse

import gymnasium as gym

import arcle_tpu_torch  # noqa: F401  (registers ARCLE-CUDA/*)
from arcle_tpu_torch.loaders import SyntheticLoader


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    env = gym.make("ARCLE-CUDA/O2ARCv2Env-v0",
                   data_loader=SyntheticLoader(8), max_grid_size=(30, 30),
                   colors=10, max_trial=3, device=args.device)
    env.action_space.seed(0)
    obs, info = env.reset(seed=0, options={"adaptation": True,
                                           "prob_index": 1})
    for _ in range(20):
        obs, reward, term, trunc, info = env.step(env.action_space.sample())
        if term or trunc:
            obs, info = env.reset()
    print("ok, steps:", info["steps"])
    return info


if __name__ == "__main__":
    main()
