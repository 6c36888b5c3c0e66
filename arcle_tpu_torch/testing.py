"""Adversarial inputs for the step, made with numpy from a seed.

They aim at what a kernel of the step can get wrong where random actions
rarely go: floods whose component is a long corridor, selections whose
int8 values are not 0/1, object ops on envs that already hold an object,
and Submits on reset-on-submit rows.  The CPU tests feed them to the plain
transition and to the JAX package; on the card they hold the kernel to
its plain version.

:func:`step_cases` turns a batch of fresh states (a numpy dict of the
``EnvState`` fields, any ``H x W``) into named cases: a start state and
the actions of each step, which do not depend on the states reached.
"""

from __future__ import annotations

import functools
from collections import deque
from typing import Dict, List, Tuple

import numpy as np

from .ops.groups import G

Case = Tuple[str, Dict[str, np.ndarray], List[Tuple[np.ndarray, np.ndarray]]]


def _far_end(path: np.ndarray, start: Tuple[int, int]) -> Tuple[int, int]:
    """The cell of ``path`` farthest from ``start`` through 4-neighbours."""
    H, W = path.shape
    dist = np.full((H, W), -1, np.int64)
    dist[start] = 0
    queue, last = deque([start]), start
    while queue:
        r, c = last = queue.popleft()
        for nr, nc in ((r - 1, c), (r + 1, c), (r, c - 1), (r, c + 1)):
            if 0 <= nr < H and 0 <= nc < W and path[nr, nc] and \
                    dist[nr, nc] < 0:
                dist[nr, nc] = dist[r, c] + 1
                queue.append((nr, nc))
    return last


@functools.lru_cache(maxsize=None)
def corridor(kind: str, H: int, W: int) -> Tuple[np.ndarray, Tuple[int, int]]:
    """An ``H x W`` grid whose colour-1 cells form one corridor, and the
    corridor's far end from (0, 0), where a flood is seeded.  The grid is
    cached and read-only.

    ``serpentine``: full rows joined at alternating ends; ``spiral``: a
    corridor winding inwards with one-cell walls; ``full``: one colour
    everywhere (the seed in the far corner).
    """
    if kind == "full":
        grid = np.full((H, W), 1, np.int8)
        grid.setflags(write=False)
        return grid, (H - 1, W - 1)
    path = np.zeros((H, W), bool)
    if kind == "serpentine":
        path[0::2, :] = True
        for i, r in enumerate(range(1, H - 1, 2)):
            path[r, W - 1 if i % 2 == 0 else 0] = True
    elif kind == "spiral":
        r = c = 0
        dr, dc = 0, 1
        path[0, 0] = True

        def free(r, c, dr, dc):
            nr, nc, ar, ac = r + dr, c + dc, r + 2 * dr, c + 2 * dc
            inside = 0 <= nr < H and 0 <= nc < W
            after = 0 <= ar < H and 0 <= ac < W
            return inside and not path[nr, nc] and \
                not (after and path[ar, ac])
        while True:
            if not free(r, c, dr, dc):
                dr, dc = dc, -dr            # turn clockwise
                if not free(r, c, dr, dc):
                    break
            r, c = r + dr, c + dc
            path[r, c] = True
    else:
        raise ValueError(f"unknown corridor {kind!r}")
    grid = np.where(path, 1, 2).astype(np.int8)
    grid.setflags(write=False)
    return grid, _far_end(path, (0, 0))


CORRIDORS = ("serpentine", "spiral", "full")


def odd_selections(rng: np.random.Generator, grid_dim: np.ndarray, H: int,
                   W: int) -> np.ndarray:
    """int8 selections whose values are not 0/1: sums of 1 from 2 and -1,
    maxima after the first non-zero cell, negative-only masks (whose max
    is a 0), and sparse values over the whole int8 range.  The marked
    cells lie inside each env's ``grid_dim``, where a flood seed counts."""
    B = grid_dim.shape[0]
    sel = np.zeros((B, H * W), np.int8)
    for b in range(B):
        h, w = (min(max(int(v), 0), n) for v, n in zip(grid_dim[b], (H, W)))
        if h * w < 3:
            h, w = H, W
        inside = (np.arange(h)[:, None] * W + np.arange(w)[None, :]).ravel()
        cells = np.sort(rng.choice(inside, 3, replace=False))
        kind = b % 5
        if kind == 0:                       # sum 1, max at the later cell
            sel[b, cells[0]], sel[b, cells[1]] = -1, 2
        elif kind == 1:                     # max after the first non-zero
            sel[b, cells[0]], sel[b, cells[2]] = 1, 5
        elif kind == 2:                     # negative only
            sel[b, cells[0]], sel[b, cells[1]] = -3, -1
        elif kind == 3:                     # sparse, the whole int8 range
            hit = rng.random(H * W) < 0.05
            sel[b, hit] = rng.integers(-128, 128, int(hit.sum()))
            sel[b, cells[0]] = 127
            sel[b, cells[1]] = -128
        else:                               # sum 1 over a wide bbox
            sel[b, cells] = (1, 1, -1)
    return sel.reshape(B, H, W)


def _bbox_selections(rng: np.random.Generator, B: int, H: int,
                     W: int) -> np.ndarray:
    sel = np.zeros((B, H, W), np.int8)
    for b in range(B):
        r0, r1 = np.sort(rng.integers(0, H, 2))
        c0, c1 = np.sort(rng.integers(0, W, 2))
        sel[b, r0:r1 + 1, c0:c1 + 1] = 1
    return sel


def step_cases(st: Dict[str, np.ndarray], table, rng: np.random.Generator,
               steps: int = 4) -> List[Case]:
    """Named adversarial cases built on the fresh states ``st`` for an op
    table with ``group`` / ``param`` rows (either package's)."""
    B, H, W = st["grid"].shape
    groups = list(table.group)
    n_ops = len(groups)
    ops_of = lambda g: np.array([i for i, x in enumerate(groups) if x == g])
    uniform = lambda: rng.integers(-1, n_ops + 1, B).astype(np.int32)
    cases: List[Case] = []

    flood = ops_of(G.FLOOD)
    if len(flood):
        s = {k: v.copy() for k, v in st.items()}
        sel = np.zeros((B, H, W), np.int8)
        for b in range(B):
            grid, (r, c) = corridor(CORRIDORS[b % 3], H, W)
            s["grid"][b] = s["input"][b] = grid
            s["grid_dim"][b] = s["input_dim"][b] = (H, W)
            sel[b, r, c] = 1
            if b % 4 == 1:          # the seed is the 2, not the first cell
                sel[b, r, c] = 2
                sel[b].flat[0] = -1
            elif b % 4 == 3:
                # two 1s side by side in one 4-cell word, on two colours:
                # the seed is the first of them
                flat = grid.ravel()
                edge = np.flatnonzero((flat[:-1] != flat[1:]) &
                                      (np.arange(H * W - 1) % 4 != 3))
                first = int(edge[0]) if len(edge) else 0
                spare = next(i for i in range(H * W - 1, -1, -1)
                             if i not in (first, first + 1))
                sel[b] = 0
                sel[b].flat[[first, first + 1, spare]] = (1, 1, -1)
        # colours other than the corridors' own
        ops = rng.choice(flood[3:], B).astype(np.int32)
        cases.append(("flood_corridors", s, [(sel, ops)]))

    cases.append(("odd_selections", {k: v.copy() for k, v in st.items()},
                  [(odd_selections(rng, st["grid_dim"], H, W), uniform())
                   for _ in range(steps)]))

    obj = ops_of(G.OBJECT)
    if len(obj):
        acts = [(_bbox_selections(rng, B, H, W),
                 rng.choice(obj, B).astype(np.int32))]
        for _ in range(steps):
            sel = _bbox_selections(rng, B, H, W)
            sel[rng.random(B) < 0.7] = 0    # the stored object moves on
            acts.append((sel, rng.choice(obj, B).astype(np.int32)))
        cases.append(("active_objects", {k: v.copy() for k, v in st.items()},
                      acts))

    submit = ops_of(G.SUBMIT)
    if len(submit):
        s = {k: v.copy() for k, v in st.items()}
        s["reset_on_submit"] = (np.arange(B) % 2).astype(np.int8)
        acts = []
        for _ in range(steps):
            ops = np.where(rng.random(B) < 0.4, submit[0],
                           uniform()).astype(np.int32)
            acts.append((_bbox_selections(rng, B, H, W), ops))
        cases.append(("reset_on_submit", s, acts))
    return cases
