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


def _task_json(task: TaskTuple) -> str:
    ti, to, ei, eo, _ = task
    return json.dumps({
        "train": [{"input": i.tolist(), "output": o.tolist()}
                  for i, o in zip(ti, to)],
        "test": [{"input": i.tolist(), "output": o.tolist()}
                 for i, o in zip(ei, eo)],
    })


def write_real_layout_fixture(root: str, n_train: int = 400,
                              n_eval: int = 400, n_mini: int = 149,
                              seed: int = 23) -> dict:
    """Write a tree in the real corpora's layouts (reference
    loader.py:72-87,116-157), byte for byte the JAX package's for a seed:

    * ARC: ``<root>/ARC/data/{training|evaluation}/<8-hex-id>.json``,
      400/400 tasks of 2-10 train and 1-3 test pairs, grids 1x1..30x30;
    * Mini-ARC: ``<root>/Mini-ARC/data/MiniARC/<description>_<id>.json``,
      5x5 grids, human file names (spaces, apostrophes, several
      underscores, none) and literal ``null`` cells in every third file.

    Returns ``{"arc_training", "arc_evaluation", "arc_root",
    "miniarc_dir", "n_null_files", "expected_mini_order"}``, the last the
    Mini-ARC paths in the loader's order."""
    rng = np.random.default_rng(seed)

    def dump(task: TaskTuple, path: str, with_null: bool = False):
        text = _task_json(task)
        if with_null:
            text = text.replace("0", "null")
        with open(path, "w") as fp:
            fp.write(text)

    arc_root = os.path.join(root, "ARC", "data")
    for sub, n in (("training", n_train), ("evaluation", n_eval)):
        d = os.path.join(arc_root, sub)
        os.makedirs(d, exist_ok=True)
        for _ in range(n):
            tid = "".join(rng.choice(list("0123456789abcdef"), 8))
            task = make_task(rng, min_size=1, max_size=30,
                             n_train=int(rng.integers(2, 11)),
                             n_test=int(rng.integers(1, 4)))
            dump(task, os.path.join(d, f"{tid}.json"))

    mini_dir = os.path.join(root, "Mini-ARC", "data", "MiniARC")
    os.makedirs(mini_dir, exist_ok=True)
    descs = ["Make a pattern symmetric", "Deleting left object",
             "color the largest shape", "move object down",
             "fill holes", "rotate the grid's shape",
             "count_and_paint objects", ""]
    n_null_files, names = 0, []
    for k in range(n_mini):
        tid = "".join(rng.choice(list(
            "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789"
        ), 20))
        desc = descs[k % len(descs)]
        fname = f"{desc}_{tid}.json" if desc else f"{tid}.json"
        task = make_task(rng, min_size=5, max_size=5,
                         n_train=int(rng.integers(2, 5)), n_test=1)
        with_null = k % 3 == 0
        n_null_files += int(with_null)
        dump(task, os.path.join(mini_dir, fname), with_null)
        names.append(fname)
    # the loader sorts full paths by their last '_'-separated segment
    expected = sorted((os.path.join(mini_dir, n) for n in names),
                      key=lambda fn: fn.split("_")[-1])
    return {"arc_training": os.path.join(arc_root, "training"),
            "arc_evaluation": os.path.join(arc_root, "evaluation"),
            "arc_root": arc_root, "miniarc_dir": mini_dir,
            "n_null_files": n_null_files,
            "expected_mini_order": expected}


def write_sample_dataset(root: str, n_train_tasks: int = 16,
                         n_eval_tasks: int = 8, n_mini: int = 8,
                         seed: int = 7) -> None:
    """Write a small ARC-layout sample (``<root>/sample_arc/{training|
    evaluation}``) and Mini-ARC sample (``<root>/sample_miniarc``), byte
    for byte the JAX package's for a seed."""
    rng = np.random.default_rng(seed)

    def dump(task: TaskTuple, path: str):
        with open(path, "w") as fp:
            fp.write(_task_json(task))

    arc = os.path.join(root, "sample_arc")
    for sub, n in (("training", n_train_tasks), ("evaluation", n_eval_tasks)):
        os.makedirs(os.path.join(arc, sub), exist_ok=True)
        for k in range(n):
            dump(make_task(rng), os.path.join(arc, sub, f"synth{k:03d}.json"))

    mini = os.path.join(root, "sample_miniarc")
    os.makedirs(mini, exist_ok=True)
    for k in range(n_mini):
        task = make_task(rng, min_size=5, max_size=5, n_train=2)
        dump(task, os.path.join(mini, f"sample task {k}_m{k:03d}.json"))
