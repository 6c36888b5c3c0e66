"""Synthetic ARC-like task generation (numpy).

Counterpart of ``arcle_tpu/loaders/synthetic.py``: each task applies one
hidden transformation (recolor / flip / rotate / translate) across its
pairs.  The draws are the same, in the same order, so a seed gives a bank
bit-identical to the JAX package's.
"""

from __future__ import annotations

import json
import os
from typing import List

import numpy as np

from .loader import Loader, TaskTuple


def _random_sprite(rng: np.random.Generator, h: int, w: int,
                   colors: int) -> np.ndarray:
    g = rng.integers(0, colors, size=(h, w)).astype(np.int8)
    # sparsify so flood fill / object ops have structure to bite on
    g[rng.random((h, w)) < 0.4] = 0
    return g


def _apply_rule(grid: np.ndarray, rule: int, perm: np.ndarray) -> np.ndarray:
    if rule == 0:                      # color permutation
        return perm[grid].astype(np.int8)
    if rule == 1:                      # horizontal flip
        return np.fliplr(grid).copy()
    if rule == 2:                      # vertical flip
        return np.flipud(grid).copy()
    if rule == 3:                      # rotate 90 CCW
        return np.rot90(grid).copy()
    if rule == 4:                      # rotate 180
        return np.rot90(grid, 2).copy()
    return grid.copy()                 # identity


def make_task(rng: np.random.Generator, min_size: int = 3,
              max_size: int = 12, n_train: int = 3, n_test: int = 1,
              colors: int = 10) -> TaskTuple:
    rule = int(rng.integers(0, 6))
    perm = np.concatenate([[0], rng.permutation(np.arange(1, colors))])
    ti, to, ei, eo = [], [], [], []
    for k in range(n_train + n_test):
        h = int(rng.integers(min_size, max_size + 1))
        w = int(rng.integers(min_size, max_size + 1))
        i = _random_sprite(rng, h, w, colors)
        o = _apply_rule(i, rule, perm)
        (ti if k < n_train else ei).append(i)
        (to if k < n_train else eo).append(o)
    return ti, to, ei, eo, {"id": f"synth{rng.integers(0, 1 << 30):08x}",
                            "rule": rule}


def make_tasks(n_tasks: int, seed: int = 0, **kw) -> List[TaskTuple]:
    rng = np.random.default_rng(seed)
    return [make_task(rng, **kw) for _ in range(n_tasks)]


class SyntheticLoader(Loader):
    """In-memory synthetic dataset."""

    def __init__(self, n_tasks: int = 32, seed: int = 0, **task_kw):
        self._n_tasks = n_tasks
        self._seed = seed
        self._task_kw = task_kw
        super().__init__()

    def get_path(self, **kwargs):
        return ["<synthetic>"] * self._n_tasks

    def parse(self, **kwargs):
        return make_tasks(self._n_tasks, self._seed, **self._task_kw)


def write_corpus(root: str, n_tasks: int = 400, n_train: int = 6,
                 n_test: int = 2, seed: int = 11,
                 max_size: int = 30) -> int:
    """Write an ARC-layout corpus of ``n_tasks`` tasks under
    ``<root>/training``; returns the pair count."""
    rng = np.random.default_rng(seed)
    sub = os.path.join(root, "training")
    os.makedirs(sub, exist_ok=True)
    pairs = 0
    for k in range(n_tasks):
        ti, to, ei, eo, _ = make_task(rng, min_size=3, max_size=max_size,
                                      n_train=n_train, n_test=n_test)
        payload = {
            "train": [{"input": i.tolist(), "output": o.tolist()}
                      for i, o in zip(ti, to)],
            "test": [{"input": i.tolist(), "output": o.tolist()}
                     for i, o in zip(ei, eo)],
        }
        with open(os.path.join(sub, f"corpus{k:04d}.json"), "w") as fp:
            json.dump(payload, fp)
        pairs += len(ti) + len(ei)
    return pairs
