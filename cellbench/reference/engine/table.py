"""Per-family op tables and the plain PyTorch transition.

Counterpart of ``arcle_tpu/ops/table.py``.  An :class:`OpTable` maps each
op index to (group, param, reset_sel); ``transition_deferred`` evaluates
every group for every env of the batch and folds the candidates by the
per-env group index.  This is the CPU path of the port and the spec that
the CUDA step kernel (``ops/step_kernel.py``) is held against.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .state import EnvState, Action, I8, I32, F32
from . import groups as g
from .groups import (
    G, OBJ, precompute_selection, precompute_shared, answers_match,
    flood_analysis, full_component,
)


@dataclasses.dataclass(frozen=True)
class OpTable:
    """Static op table for one env family."""

    name: str
    group: Tuple[int, ...]
    param: Tuple[int, ...]
    reset_sel: Tuple[bool, ...]
    max_trial: int = -1
    submit_op: int = -1  # the op whose match gives the sparse reward

    @property
    def n_ops(self) -> int:
        return len(self.group)

    def replace(self, **kw) -> "OpTable":
        return dataclasses.replace(self, **kw)

    def op_names(self) -> Tuple[str, ...]:
        """Capitalised names in the reference's ``op_names`` convention
        (base.py:66)."""
        obj = ("MoveU", "MoveD", "MoveR", "MoveL", "Rotate90", "Rotate270",
               "FlipH", "FlipV", "FlipD0", "FlipD1")
        fixed = {G.PASTE: "Paste", G.COPY_FROM_INPUT: "CopyFromInput",
                 G.RESET_GRID: "ResetGrid", G.RESIZE_GRID: "ResizeGrid",
                 G.CROP_GRID: "CropGrid", G.SUBMIT: "Submit",
                 G.RESIZE_TO_ANSWER: "ResizeToAnswer"}
        out = []
        for grp, par in zip(self.group, self.param):
            if grp == G.COLOR:
                out.append(f"Color{par}")
            elif grp == G.FLOOD:
                out.append(f"FloodFill{par}")
            elif grp == G.OBJECT:
                out.append(obj[par])
            elif grp == G.COPY:
                out.append("CopyI" if par == 0 else "CopyO")
            else:
                out.append(fixed.get(grp, "Noop"))
        return tuple(out)

    def rows(self, device) -> torch.Tensor:
        """int32 ``[3, n_ops]``: group, param and reset_sel per op."""
        return torch.tensor([self.group, self.param,
                             [int(r) for r in self.reset_sel]],
                            dtype=I32, device=device)


def _table(rows, name, max_trial):
    grp, par, rs = zip(*rows)
    sub = grp.index(G.SUBMIT) if G.SUBMIT in grp else -1
    return OpTable(name=name, group=tuple(grp), param=tuple(par),
                   reset_sel=tuple(rs), max_trial=max_trial, submit_op=sub)


def raw_table(max_trial: int = -1) -> OpTable:
    """RawARCEnv: Color0-9, ResizeToAnswer, Submit."""
    rows = [(G.COLOR, c, False) for c in range(10)]
    rows.append((G.RESIZE_TO_ANSWER, 0, False))
    rows.append((G.SUBMIT, 0, False))
    return _table(rows, "RawARCEnv", max_trial)


def arc_table(max_trial: int = 3) -> OpTable:
    """ARCEnv, 27 ops with Submit at 26."""
    rows = [(G.COLOR, c, False) for c in range(10)]
    rows += [(G.FLOOD, c, False) for c in range(10)]
    rows += [(G.COPY, 0, False), (G.COPY, 1, False), (G.PASTE, 1, False)]
    rows += [(G.COPY_FROM_INPUT, 0, False), (G.RESET_GRID, 0, False),
             (G.RESIZE_GRID, 0, False)]
    rows.append((G.SUBMIT, 0, False))
    return _table(rows, "ARCEnv", max_trial)


def o2arc_table(max_trial: int = -1, crop_at_33: bool = False,
                no_fill: bool = False) -> OpTable:
    """O2ARCv2Env, 35 ops.  ``crop_at_33`` makes op 33 CropGrid,
    ``no_fill`` drops the 10 FloodFill ops (25 ops)."""
    rows = [(G.COLOR, c, True) for c in range(10)]
    if not no_fill:
        rows += [(G.FLOOD, c, True) for c in range(10)]
    rows += [(G.OBJECT, d, False) for d in
             (OBJ.MOVE_U, OBJ.MOVE_D, OBJ.MOVE_R, OBJ.MOVE_L)]
    rows += [(G.OBJECT, OBJ.ROT_90, False), (G.OBJECT, OBJ.ROT_270, False)]
    rows += [(G.OBJECT, OBJ.FLIP_H, False), (G.OBJECT, OBJ.FLIP_V, False)]
    rows += [(G.COPY, 0, True), (G.COPY, 1, True), (G.PASTE, 1, True)]
    rows += [(G.COPY_FROM_INPUT, 0, True), (G.RESET_GRID, 0, True)]
    rows.append((G.CROP_GRID if crop_at_33 else G.RESIZE_GRID, 0, True))
    rows.append((G.SUBMIT, 0, False))
    name = "O2ARCNoFillEnv" if no_fill else (
        "CustomO2ARCEnv" if crop_at_33 else "O2ARCv2Env")
    return _table(rows, name, max_trial)


# Group index -> implementation, in G.* order.
_GROUP_FNS = (
    g.noop,             # 0 NOOP
    g.color_fill,       # 1
    g.flood_fill,       # 2 FLOOD (reads shared.flood)
    g.object_op,        # 3
    g.copy_to_clip,     # 4
    g.paste_from_clip,  # 5
    g.copy_from_input,  # 6
    g.reset_grid,       # 7
    g.resize_grid,      # 8
    g.crop_grid,        # 9
    g.submit,           # 10
    g.resize_to_answer, # 11
)

FLOOD_UNROLL = 2


def lookup(action: Action, table: OpTable):
    """(op, grp, par, reset_sel) per env, the op clipped to the table."""
    op = action.operation.to(I32).clamp(0, table.n_ops - 1)
    rows = table.rows(op.device)
    grp, par, rs = rows[:, op.long()]
    return op, grp, par, rs != 0


def transition_deferred(state: EnvState, action: Action, table: OpTable):
    """Batched transition with *deferred* flood fill.

    Returns ``(state', pending, reward_match)``: ``pending`` is True where
    the op is a flood fill whose component did not converge within
    ``FLOOD_UNROLL`` sweeps (the grid is left for :func:`finish_flood`);
    ``reward_match`` is answers_match as the sparse reward sees it.
    """
    _, grp, par, do_reset = lookup(action, table)

    # reset_sel decorator (object.py:10-26), applied before the op
    state0 = state.replace(
        selected=g._where(do_reset, torch.zeros_like(state.selected),
                          state.selected),
        active=torch.where(do_reset, torch.zeros_like(state.active),
                           state.active),
    )

    sel = action.selection
    pre = precompute_selection(sel)
    has_flood = G.FLOOD in table.group
    flood = flood_analysis(state0, pre, FLOOD_UNROLL) if has_flood else None
    shared = precompute_shared(state0, sel, pre, flood)
    present = set(table.group)
    cands = [(i, fn(state0, sel, pre, par, table, shared))
             for i, fn in enumerate(_GROUP_FNS)
             if i in present and fn is not g.noop]

    # fold: a field a candidate left as state0's tensor needs no select
    out = {}
    for f in dataclasses.fields(EnvState):
        base = getattr(state0, f.name)
        acc = base
        for i, cand in cands:
            v = getattr(cand, f.name)
            if v is not base:
                acc = g._where(grp == i, v, acc)
        out[f.name] = acc
    new = EnvState(**out)

    if has_flood:
        pending = (grp == G.FLOOD) & flood.valid & ~flood.converged
    else:
        pending = torch.zeros_like(grp, dtype=torch.bool)

    # sparse-reward match on the post-op state: a Submit with
    # reset_on_submit re-inits, so the fresh grid (= input) is compared
    ros_applied = (state.trials_remain != 0) & (state.reset_on_submit != 0)
    fresh_match = answers_match(state.replace(grid=state.input,
                                              grid_dim=state.input_dim))
    reward_match = torch.where(ros_applied, fresh_match, shared.match)
    return new, pending, reward_match


def finish_flood(state: EnvState, action: Action, table: OpTable,
                 pending: torch.Tensor) -> EnvState:
    """Complete deferred flood fills: the fixpoint component and a masked
    color write where ``pending``.  Flood ops never change reward or
    termination, so this may run after both."""
    _, _, par, _ = lookup(action, table)
    pre = precompute_selection(action.selection)
    comp = full_component(state.grid, state.grid_dim, pre.px, pre.py)
    grid = torch.where(comp & g._bc(pending, comp), par.to(I8).view(-1, 1, 1),
                       state.grid)
    return state.replace(grid=grid)


def transition(state: EnvState, action: Action, table: OpTable) -> EnvState:
    """Transition with every flood fill completed: the counterpart of the
    reference's ``transition(state, action)`` hook (o2arcenv.py:149-151)
    and of the JAX package's single-env ``transition`` (a single env is a
    batch of one).  The fix-up runs only when an env is pending, which asks
    the host."""
    new, pending, _ = transition_deferred(state, action, table)
    if bool(pending.any()):
        new = finish_flood(new, action, table, pending)
    return new


def _finish_step(state: EnvState, s2: EnvState, op, match, table: OpTable):
    reward = ((op == table.submit_op) & match).to(F32)
    s2 = s2.replace(steps=state.steps + 1, last_action_op=op,
                    last_reward=reward)
    return s2, reward, s2.terminated != 0


def step_deferred(state: EnvState, action: Action, table: OpTable):
    """Transition + sparse reward + bookkeeping, flood deferred: returns
    ``(state, reward, terminated, pending)``.  Reward and termination are
    exact before the flood patch."""
    op = action.operation.to(I32).clamp(0, table.n_ops - 1)
    s2, pending, match = transition_deferred(state, action, table)
    s2, reward, term = _finish_step(state, s2, op, match, table)
    return s2, reward, term, pending


def step(state: EnvState, action: Action, table: OpTable):
    """Complete step: :func:`step_deferred` with the flood finished.
    Returns ``(state, reward, terminated)``.  The fix-up runs only when an
    env is pending, which asks the host: this is the plain path's step."""
    s2, reward, term, pending = step_deferred(state, action, table)
    if bool(pending.any()):
        s2 = finish_flood(s2, action, table, pending)
    return s2, reward, term


def _grid_rowcol(grid: torch.Tensor, w: int = 30):
    """Row/col indices for square ``[B,H,W]`` or flat ``[B,P]`` grids
    (``w`` is the flat layout's row width)."""
    if grid.ndim == 3:
        _, H, W = grid.shape
        rows = torch.arange(H, dtype=I32, device=grid.device).view(1, H, 1)
        cols = torch.arange(W, dtype=I32, device=grid.device).view(1, 1, W)
        return rows, cols
    lane = torch.arange(grid.shape[-1], dtype=I32,
                        device=grid.device).view(1, -1)
    return lane // w, lane % w


def _per_env(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return v.view((-1,) + (1,) * (like.ndim - 1))


def answers_match_any(state: EnvState, w: int = 30) -> torch.Tensor:
    """``answers_match`` for square or flat grids (bool ``[B]``)."""
    rows, cols = _grid_rowcol(state.grid, w)
    ad = state.answer_dim.to(I32)
    dims_eq = (state.grid_dim == state.answer_dim).all(dim=1)
    inside = (rows < _per_env(ad[:, 0], state.grid)) & \
        (cols < _per_env(ad[:, 1], state.grid))
    wrong = inside & (state.grid != state.answer)
    return dims_eq & ~wrong.reshape(wrong.shape[0], -1).any(dim=1)


def pixel_reward(state_after: EnvState, w: int = 30) -> torch.Tensor:
    """Dense reward ``-(incorrect pixels)/(total)`` inside the answer dims,
    in [-1, 0] (paper §4.1); float32 ``[B]``."""
    grid = state_after.grid
    rows, cols = _grid_rowcol(grid, w)
    ad = state_after.answer_dim.to(I32)
    inside = (rows < _per_env(ad[:, 0], grid)) & \
        (cols < _per_env(ad[:, 1], grid))
    wrong = (inside & (grid != state_after.answer)).reshape(
        grid.shape[0], -1).sum(dim=1).to(F32)
    total = torch.clamp(ad[:, 0] * ad[:, 1], min=1).to(F32)
    return -(wrong / total)


def dense_reward(state_after: EnvState, sparse: torch.Tensor) -> torch.Tensor:
    """CustomO2ARCEnv shaped reward (agents/env.py:44-58):
    ``100*sparse - 1 + correct/total`` with the size-mismatch penalty in
    the denominator.  Square ``[B,30,30]`` or flat ``[B,900]`` grids."""
    grid, answer = state_after.grid, state_after.answer
    gd = state_after.grid_dim.to(I32)
    ad = state_after.answer_dim.to(I32)
    h, w = gd[:, 0], gd[:, 1]
    Ha, Wa = ad[:, 0], ad[:, 1]
    minh = torch.minimum(h, Ha)
    minw = torch.minimum(w, Wa)
    rows, cols = _grid_rowcol(grid, 30)
    region = (rows < _per_env(minh, grid)) & (cols < _per_env(minw, grid))
    correct = (region & (grid == answer)).reshape(
        grid.shape[0], -1).sum(dim=1).to(F32)
    total = (minh * minw).to(F32)
    both = (h <= Ha) == (w <= Wa)
    pen_a = torch.abs(Ha * Wa - h * w).to(F32)
    pen_b = (torch.abs(h - Ha) * minw + torch.abs(w - Wa) * minh).to(F32)
    total = total + torch.where(both, pen_a, pen_b)
    return sparse * 100.0 - 1.0 + correct / total
