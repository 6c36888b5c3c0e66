"""RawARCEnv at 5x5 with Mini-ARC-style tasks (counterpart of the
reference's examples/example_bbox_mini.py), stepped on the card.

    python -m examples_torch.example_bbox_mini [--device cuda|cpu]   # from the repo root
"""
import argparse

import gymnasium as gym

import arcle_tpu_torch  # noqa: F401  (registers ARCLE-CUDA/*)
from arcle_tpu_torch.loaders import SyntheticLoader
from arcle_tpu_torch.wrappers import BBoxWrapper


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    loader = SyntheticLoader(8, min_size=5, max_size=5)
    env = BBoxWrapper(gym.make("ARCLE-CUDA/RawARCEnv-v0", data_loader=loader,
                               max_grid_size=(5, 5), device=args.device))
    env.action_space.seed(0)
    obs, info = env.reset(options={"prob_index": 0})
    for _ in range(10):
        obs, reward, term, trunc, info = env.step(env.action_space.sample())
    print("ok")
    return obs


if __name__ == "__main__":
    main()
