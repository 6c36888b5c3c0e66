"""A BBox-wrapped O2ARCv2 env through ``gym.make`` (counterpart of the
reference's examples/example_bbox.py), stepped on the card.

    python -m examples_torch.example_bbox [--device cuda|cpu]   # from the repo root
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
    env = BBoxWrapper(gym.make("ARCLE-CUDA/O2ARCv2Env-v0",
                               data_loader=SyntheticLoader(8),
                               device=args.device))
    env.action_space.seed(0)
    obs, info = env.reset(options={"prob_index": 0})
    for _ in range(10):
        obs, reward, term, trunc, info = env.step(env.action_space.sample())
    print("ok")
    return info


if __name__ == "__main__":
    main()
