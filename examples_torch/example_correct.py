"""A scripted correct solve (counterpart of the reference's
examples/example_correct.py): colour the grid to match the answer, then
submit -> reward 1.

    python -m examples_torch.example_correct [--device cuda|cpu]   # from the repo root
"""
import argparse

import gymnasium as gym
import numpy as np

import arcle_tpu_torch  # noqa: F401  (registers ARCLE-CUDA/*)
from arcle_tpu_torch.loaders import ListLoader


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    inp = np.zeros((3, 3), np.int8)
    ans = np.full((3, 3), 4, np.int8)
    env = gym.make("ARCLE-CUDA/O2ARCv2Env-v0",
                   data_loader=ListLoader([([inp], [ans], [inp], [ans], {})]),
                   device=args.device)
    obs, info = env.reset(options={"prob_index": 0, "subprob_index": 0})
    sel = np.zeros((30, 30), np.int8)
    sel[:3, :3] = 1
    obs, r, term, *_ = env.step({"selection": sel, "operation": 4})  # Color4
    obs, r, term, *_ = env.step({"selection": np.zeros((30, 30), np.int8),
                                 "operation": 34})                   # Submit
    if not (r == 1.0 and term):
        raise AssertionError(f"not solved: reward {r}, terminated {term}")
    print("solved, reward", r)
    return r


if __name__ == "__main__":
    main()
