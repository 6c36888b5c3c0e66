"""The task banks, made again from their seeds, and the check that a
fresh episode is one of them.

``synthetic_tasks`` is a copy of the port's ``loaders/synthetic.py``
generator (the same numpy draws in the same order) and ``random_pairs``
of the answer-given setting's ``RandomPairLoader``.  ``Bank`` holds every
(input, answer) pair of a task list as padded grids, and ``Bank.members``
says which rows of a batch of episodes start from one of its pairs: with
``augment`` up to a rotation of both grids and one colour permutation
shared by them (the reset-time augmentation), else exactly.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

Pair = Tuple[np.ndarray, np.ndarray]


def _sprite(rng: np.random.Generator, h: int, w: int, colors: int
            ) -> np.ndarray:
    g = rng.integers(0, colors, size=(h, w)).astype(np.int8)
    g[rng.random((h, w)) < 0.4] = 0
    return g


def _rule(grid: np.ndarray, rule: int, perm: np.ndarray) -> np.ndarray:
    if rule == 0:
        return perm[grid].astype(np.int8)
    if rule == 1:
        return np.fliplr(grid).copy()
    if rule == 2:
        return np.flipud(grid).copy()
    if rule == 3:
        return np.rot90(grid).copy()
    if rule == 4:
        return np.rot90(grid, 2).copy()
    return grid.copy()


def synthetic_tasks(n_tasks: int, seed: int, min_size: int = 3,
                    max_size: int = 12, n_train: int = 3, n_test: int = 1,
                    colors: int = 10) -> List[Pair]:
    """Every (input, output) pair, train and test, of ``n_tasks``
    synthetic tasks."""
    rng = np.random.default_rng(seed)
    pairs: List[Pair] = []
    for _ in range(n_tasks):
        rule = int(rng.integers(0, 6))
        perm = np.concatenate([[0], rng.permutation(np.arange(1, colors))])
        for _k in range(n_train + n_test):
            h = int(rng.integers(min_size, max_size + 1))
            w = int(rng.integers(min_size, max_size + 1))
            i = _sprite(rng, h, w, colors)
            pairs.append((i, _rule(i, rule, perm)))
        rng.integers(0, 1 << 30)            # the task id's draw
    return pairs


def random_pairs(n_tasks: int, h: int, w: int, colors: int, seed: int
                 ) -> List[Pair]:
    """The random setting: independent uniform initial grid and goal."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_tasks):
        g = rng.integers(0, colors, (h, w)).astype(np.int8)
        a = rng.integers(0, colors, (h, w)).astype(np.int8)
        out.append((g, a))
    return out


def _canon(cells: np.ndarray, relabel: bool) -> np.ndarray:
    """Rows of cell values (-1: outside the grids) with the colours
    renamed in order of first appearance when ``relabel``."""
    if not relabel:
        return cells
    n, L = cells.shape
    first = np.full((n, 10), L, np.int64)
    for c in range(10):
        hit = cells == c
        first[:, c] = np.where(hit.any(1), hit.argmax(1), L)
    rank = np.argsort(np.argsort(first, axis=1, kind="stable"), axis=1)
    out = np.take_along_axis(rank, np.clip(cells, 0, 9).astype(np.int64),
                             axis=1)
    return np.where(cells >= 0, out, -1)


def _rows(grid: np.ndarray, dim: np.ndarray, ans: np.ndarray,
          ans_dim: np.ndarray) -> np.ndarray:
    """``[N, 4 + 2*H*W]`` int64: the dims and both grids, cells outside
    their own dims set to -1."""
    n, H, W = grid.shape
    r = np.arange(H).reshape(1, H, 1)
    c = np.arange(W).reshape(1, 1, W)

    def masked(g, d):
        inside = (r < d[:, 0].reshape(-1, 1, 1)) & \
            (c < d[:, 1].reshape(-1, 1, 1))
        return np.where(inside, g.astype(np.int64), -1).reshape(n, -1)

    return np.concatenate([dim.astype(np.int64), ans_dim.astype(np.int64),
                           masked(grid, dim), masked(ans, ans_dim)], axis=1)


class Bank:
    """The pairs of a task list, on ``H x W`` grids."""

    def __init__(self, pairs: Sequence[Pair], H: int, W: int,
                 augment: bool):
        self.H, self.W, self.augment = H, W, augment
        keys = set()
        for i, o in pairs:
            for k in (range(4) if augment else (0,)):
                ri, ro = np.rot90(i, k), np.rot90(o, k)
                g, a = self._pad(ri), self._pad(ro)
                rows = _rows(g[None], np.array([ri.shape]), a[None],
                             np.array([ro.shape]))
                keys.add(self._key(rows)[0])
        self.keys = keys

    def _pad(self, g: np.ndarray) -> np.ndarray:
        out = np.zeros((self.H, self.W), np.int8)
        out[:g.shape[0], :g.shape[1]] = g
        return out

    def _key(self, rows: np.ndarray) -> List[bytes]:
        head, cells = rows[:, :4], rows[:, 4:]
        canon = np.concatenate([head, _canon(cells, self.augment)], axis=1)
        return [r.tobytes() for r in canon.astype(np.int8)]

    def members(self, grid: torch.Tensor, dim: torch.Tensor,
                ans: torch.Tensor, ans_dim: torch.Tensor) -> np.ndarray:
        """Bool ``[N]``: row ``n`` is a pair of the bank (augmented when
        the bank is)."""
        t = lambda x: x.detach().cpu().numpy()
        rows = _rows(t(grid), t(dim), t(ans), t(ans_dim))
        return np.array([k in self.keys for k in self._key(rows)], bool)
