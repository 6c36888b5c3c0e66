"""The grid-operator library on batched tensors.

Counterpart of ``arcle_tpu/ops/groups.py``.  Each *group* function has the
signature

    group(state, sel, pre, param, table, shared) -> EnvState

over a batch: ``sel`` is the int8 ``[B,H,W]`` selection, ``param`` the
int32 ``[B]`` op parameter, ``pre`` and ``shared`` the per-env
precomputations.  ``ops.table.transition_deferred`` evaluates every group
for every env and folds the candidates by the per-env group index, as the
JAX package does under ``vmap``.

Integer arithmetic on int8 fields is done in int32 (``_d32``) and cast back
to int8 only on the store, so positions and trial counters wrap exactly
where the JAX package's do.  Floor division and modulo of possibly
negative values use ``torch.div(..., rounding_mode="floor")`` and
``torch.remainder``, which are floor operations like ``jnp``'s.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .state import EnvState, I8, I32, init_state
from .geometry import (
    bbox, inside_dims, row_col_iota, shift2d, place_patch, roll_axis,
)
from .floodfill import connected_component, connected_component_partial


class G:
    """Group codes (as ``arcle_tpu.ops.groups.G``)."""
    NOOP = 0
    COLOR = 1
    FLOOD = 2
    OBJECT = 3
    COPY = 4
    PASTE = 5
    COPY_FROM_INPUT = 6
    RESET_GRID = 7
    RESIZE_GRID = 8
    CROP_GRID = 9
    SUBMIT = 10
    RESIZE_TO_ANSWER = 11
    COUNT = 12


class OBJ:
    """Object-group sub-kinds (the param of ``G.OBJECT`` rows)."""
    MOVE_U = 0
    MOVE_D = 1
    MOVE_R = 2
    MOVE_L = 3
    ROT_90 = 4    # CCW
    ROT_270 = 5   # CW
    FLIP_H = 6
    FLIP_V = 7
    FLIP_D0 = 8   # transpose
    FLIP_D1 = 9   # anti-transpose


def _d32(v: torch.Tensor) -> torch.Tensor:
    return v.to(I32)


def _bc(cond: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-env ``[B]`` condition shaped to broadcast against ``like``."""
    return cond.view((-1,) + (1,) * (like.ndim - 1))


def _where(cond: torch.Tensor, a: torch.Tensor,
           b: torch.Tensor) -> torch.Tensor:
    """Per-env select between same-shaped ``a`` and ``b`` by ``cond[B]``."""
    return torch.where(_bc(cond, b), a, b)


def _floordiv2(v: torch.Tensor) -> torch.Tensor:
    return torch.div(v, 2, rounding_mode="floor")


def _stack2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two int32 ``[B]`` values as an int8 ``[B,2]`` dim (wraps on store)."""
    return torch.stack([a, b], dim=1).to(I8)


@dataclasses.dataclass(frozen=True)
class SelPre:
    """Per-env reductions over the action's selection mask."""

    any: torch.Tensor    # bool [B]
    rmin: torch.Tensor   # i32 [B]
    rmax: torch.Tensor
    cmin: torch.Tensor
    cmax: torch.Tensor
    total: torch.Tensor  # i32 [B]  sum of the int8 values
    px: torch.Tensor     # i32 [B]  argmax row (flood seed)
    py: torch.Tensor     # i32 [B]  argmax col


def precompute_selection(sel: torch.Tensor) -> SelPre:
    nonempty, rmin, rmax, cmin, cmax = bbox(sel)
    B, H, W = sel.shape
    flat = sel.reshape(B, H * W)
    total = flat.to(I32).sum(dim=1, dtype=I32)
    # argmax of the int8 values, first index of the max (jnp.argmax)
    lane = torch.arange(H * W, dtype=I32, device=sel.device).view(1, -1)
    is_max = flat == flat.amax(dim=1, keepdim=True)
    idx = torch.where(is_max, lane, torch.full_like(lane, H * W)).amin(dim=1)
    return SelPre(any=nonempty, rmin=rmin, rmax=rmax, cmin=cmin, cmax=cmax,
                  total=total, px=idx // W, py=idx % W)


@dataclasses.dataclass(frozen=True)
class FloodInfo:
    """FloodFill preconditions and the (possibly partial) component."""

    valid: torch.Tensor      # bool [B]
    comp: torch.Tensor       # bool [B,H,W]
    converged: torch.Tensor  # bool [B]


@dataclasses.dataclass(frozen=True)
class Shared:
    """Sub-computations shared across the group candidates: the grid,
    truthy selection and input shifted so that the selection's bbox corner
    sits at the origin, and ``answers_match`` of the pre-op state."""

    grid_sh: torch.Tensor   # i8 [B,H,W]
    selp_sh: torch.Tensor   # bool [B,H,W]
    input_sh: torch.Tensor  # i8 [B,H,W]
    match: torch.Tensor     # bool [B]
    flood: Optional[FloodInfo]


def precompute_shared(state: EnvState, sel: torch.Tensor, pre: SelPre,
                      flood: Optional[FloodInfo]) -> Shared:
    return Shared(
        grid_sh=shift2d(state.grid, -pre.rmin, -pre.cmin),
        selp_sh=shift2d((sel != 0).to(I8), -pre.rmin, -pre.cmin) != 0,
        input_sh=shift2d(state.input, -pre.rmin, -pre.cmin),
        match=answers_match(state),
        flood=flood,
    )


def _window(h: torch.Tensor, w: torch.Tensor, H: int, W: int, device):
    """Bool ``[B,H,W]``: row < h[b] and col < w[b]."""
    rows, cols = row_col_iota(H, W, device)
    return (rows < h.view(-1, 1, 1)) & (cols < w.view(-1, 1, 1))


# --------------------------------------------------------------------------
# Simple groups
# --------------------------------------------------------------------------
def noop(state: EnvState, sel, pre, param, table, shared) -> EnvState:
    return state


def color_fill(state: EnvState, sel, pre, param, table, shared) -> EnvState:
    """Color0..9: masked fill, not clipped to grid_dim."""
    grid = torch.where(sel != 0, param.to(I8).view(-1, 1, 1), state.grid)
    return state.replace(grid=grid)


def flood_analysis(state: EnvState, pre: SelPre, unroll: int = 2) -> FloodInfo:
    """FloodFill preconditions (one selected pixel, inside grid_dim) and
    the component after ``unroll`` sweeps, with its exact convergence."""
    B, H, W = state.grid.shape
    gd = _d32(state.grid_dim)
    valid = (pre.total == 1) & (pre.px < gd[:, 0]) & (pre.py < gd[:, 1])
    ar = torch.arange(B, device=state.grid.device)
    seed_color = state.grid[ar, pre.px.long(), pre.py.long()]
    region = (state.grid == seed_color.view(B, 1, 1)) & \
        inside_dims(state.grid_dim, H, W)
    rows, cols = row_col_iota(H, W, state.grid.device)
    seed = (rows == pre.px.view(B, 1, 1)) & (cols == pre.py.view(B, 1, 1))
    comp, conv = connected_component_partial(region, seed, unroll)
    return FloodInfo(valid=valid, comp=comp, converged=conv)


def full_component(grid: torch.Tensor, grid_dim: torch.Tensor,
                   px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """The fixpoint component of seed (px, py) (the reference ``dfs``)."""
    B, H, W = grid.shape
    ar = torch.arange(B, device=grid.device)
    seed_color = grid[ar, px.long(), py.long()]
    region = (grid == seed_color.view(B, 1, 1)) & inside_dims(grid_dim, H, W)
    rows, cols = row_col_iota(H, W, grid.device)
    seed = (rows == px.view(B, 1, 1)) & (cols == py.view(B, 1, 1))
    return connected_component(region, seed)


def flood_fill(state: EnvState, sel, pre, param, table, shared) -> EnvState:
    """FloodFill0..9: writes only where the component already converged; a
    deferred env keeps its grid for ``ops.table.finish_flood``."""
    flood = shared.flood
    write = _bc(flood.valid & flood.converged, state.grid)
    grid = torch.where(flood.comp & write, param.to(I8).view(-1, 1, 1),
                       state.grid)
    return state.replace(grid=grid)


def copy_from_input(state: EnvState, sel, pre, param, table,
                    shared) -> EnvState:
    return state.replace(grid=state.input, grid_dim=state.input_dim)


def reset_grid(state: EnvState, sel, pre, param, table, shared) -> EnvState:
    return state.replace(grid=torch.zeros_like(state.grid))


def resize_grid(state: EnvState, sel, pre, param, table, shared) -> EnvState:
    """grid_dim <- bbox(sel) size, grid zeroed (when anything is selected)."""
    new_dim = _stack2(pre.rmax - pre.rmin + 1, pre.cmax - pre.cmin + 1)
    return state.replace(
        grid=_where(pre.any, torch.zeros_like(state.grid), state.grid),
        grid_dim=_where(pre.any, new_dim, state.grid_dim),
    )


def crop_grid(state: EnvState, sel, pre, param, table, shared) -> EnvState:
    """Selected nonzero cells of bbox(sel) moved to the origin; dims shrink."""
    _, H, W = state.grid.shape
    h = pre.rmax - pre.rmin + 1
    w = pre.cmax - pre.cmin + 1
    keep = _window(h, w, H, W, state.grid.device) & shared.selp_sh & \
        (shared.grid_sh != 0)
    patch = torch.where(keep, shared.grid_sh, torch.zeros_like(state.grid))
    return state.replace(
        grid=_where(pre.any, patch, state.grid),
        grid_dim=_where(pre.any, _stack2(h, w), state.grid_dim),
    )


def resize_to_answer(state: EnvState, sel, pre, param, table,
                     shared) -> EnvState:
    """dims <- answer dims, grid zeroed outside them."""
    _, H, W = state.grid.shape
    grid = torch.where(inside_dims(state.answer_dim, H, W), state.grid,
                       torch.zeros_like(state.grid))
    return state.replace(grid=grid, grid_dim=state.answer_dim)


# --------------------------------------------------------------------------
# Clipboard
# --------------------------------------------------------------------------
def copy_to_clip(state: EnvState, sel, pre, param, table, shared) -> EnvState:
    """Copy_I (param 0) / Copy_O (param 1)."""
    _, H, W = state.grid.shape
    from_input = param == 0
    src_dim = torch.where(from_input.view(-1, 1), _d32(state.input_dim),
                          _d32(state.grid_dim))
    # strictly-greater bound, as in the reference (object.py:301)
    oob = (pre.rmax > src_dim[:, 0]) | (pre.cmax > src_dim[:, 1])
    valid = pre.any & ~oob
    h = pre.rmax - pre.rmin + 1
    w = pre.cmax - pre.cmin + 1
    src_sh = _where(from_input, shared.input_sh, shared.grid_sh)
    keep = _window(h, w, H, W, state.grid.device) & (src_sh != 0) & \
        shared.selp_sh
    new_clip = torch.where(keep, src_sh, torch.zeros_like(src_sh))
    return state.replace(
        clip=_where(valid, new_clip, state.clip),
        clip_dim=_where(valid, _stack2(h, w), state.clip_dim),
    )


def paste_from_clip(state: EnvState, sel, pre, param, table,
                    shared) -> EnvState:
    """Paste; param != 0 is paste_blank (zeros overwrite the grid).
    Clipped to the full HxW frame, not to grid_dim."""
    _, H, W = state.grid.shape
    cd = _d32(state.clip_dim)
    h, w = cd[:, 0], cd[:, 1]
    valid = pre.any & (h != 0) & (w != 0)
    vals, win = place_patch(state.clip, h, w, pre.rmin, pre.cmin,
                            torch.full_like(h, H), torch.full_like(w, W))
    blank = _bc(param != 0, vals)
    write = win & _bc(valid, win) & (blank | (vals != 0))
    return state.replace(grid=torch.where(write, vals, state.grid))


# --------------------------------------------------------------------------
# The object-selection state machine (Move / Rotate / Flip)
# --------------------------------------------------------------------------
def _transform_buffer(buf: torch.Tensor, kind: torch.Tensor,
                      h: torch.Tensor, w: torch.Tensor,
                      kinds_present: frozenset) -> torch.Tensor:
    """Transform the origin-anchored h x w patch of a full ``[B,H,W]``
    buffer by ``kind`` and roll it back to the origin.

    Reproduces the JAX package's whole-buffer result cell for cell (the
    roll amounts ``w - W`` and ``h - H`` are taken mod H or W), so the
    stored buffer matches outside the patch as well.
    """
    _, H, W = buf.shape
    out = buf
    for k in sorted(kinds_present):
        if k == OBJ.ROT_90:
            v = roll_axis(torch.rot90(buf, 1, dims=(1, 2)), w - W, 1)
        elif k == OBJ.ROT_270:
            v = roll_axis(torch.rot90(buf, 3, dims=(1, 2)), h - H, 2)
        elif k == OBJ.FLIP_H:
            v = roll_axis(torch.flip(buf, dims=(2,)), w - W, 2)
        elif k == OBJ.FLIP_V:
            v = roll_axis(torch.flip(buf, dims=(1,)), h - H, 1)
        elif k == OBJ.FLIP_D0:
            v = buf.transpose(1, 2)
        elif k == OBJ.FLIP_D1:
            v = torch.rot90(buf, 2, dims=(1, 2)).transpose(1, 2)
            v = roll_axis(roll_axis(v, w - W, 1), h - H, 2)
        else:       # moves keep the buffer
            continue
        out = _where(kind == k, v, out)
    return out


def object_op(state: EnvState, sel, pre, param, table, shared) -> EnvState:
    """Move_U/D/R/L, Rotate_90/270, Flip_H/V/D0/D1.

    ``_init_objsel`` (object.py:60-111) -> per-kind transform ->
    ``_apply_patch`` (113-138) -> ``_apply_sel`` (140-165).
    """
    _, H, W = state.grid.shape
    dev = state.grid.device
    kind = param

    has_sel = pre.any
    cont = (~has_sel) & (state.active != 0)
    valid = has_sel | cont

    h_a = pre.rmax - pre.rmin + 1
    w_a = pre.cmax - pre.cmin + 1
    win_a = _window(h_a, w_a, H, W, dev) & shared.selp_sh
    zero = torch.zeros_like(state.grid)
    obj_a = torch.where(win_a, shared.grid_sh, zero)
    osel_a = win_a.to(I8)
    bg_a = torch.where(sel != 0, zero, state.grid)

    obj = _where(has_sel, obj_a, state.object)
    osel = _where(has_sel, osel_a, state.object_sel)
    bg = _where(has_sel, bg_a, state.background)
    pos, dim = _d32(state.object_pos), _d32(state.object_dim)
    x = torch.where(has_sel, pre.rmin, pos[:, 0])
    y = torch.where(has_sel, pre.cmin, pos[:, 1])
    h = torch.where(has_sel, h_a, dim[:, 0])
    w = torch.where(has_sel, w_a, dim[:, 1])
    parity = torch.where(has_sel, torch.zeros_like(x),
                         _d32(state.rotation_parity))

    is_move = kind <= OBJ.MOVE_L
    is_rot = (kind == OBJ.ROT_90) | (kind == OBJ.ROT_270)
    one = torch.ones_like(x)
    dx = torch.where(kind == OBJ.MOVE_U, -one,
                     torch.where(kind == OBJ.MOVE_D, one, 0 * one))
    dy = torch.where(kind == OBJ.MOVE_R, one,
                     torch.where(kind == OBJ.MOVE_L, -one, 0 * one))

    # rotation anchor in doubled integers (object.py:186-207): floor
    # division, since the object may sit off-grid at negative positions
    same_par = torch.remainder(h, 2) == torch.remainder(w, 2)
    parity_rot = torch.where(same_par, parity, torch.remainder(parity + 1, 2))
    mod = 1 - parity_rot
    x_rot = torch.where(same_par, _floordiv2(2 * x + h - w),
                        _floordiv2(2 * x + h - w - 1) + mod)
    y_rot = torch.where(same_par, _floordiv2(2 * y + w - h),
                        _floordiv2(2 * y + w - h - 1) + mod)

    x2 = torch.where(is_move, x + dx, torch.where(is_rot, x_rot, x))
    y2 = torch.where(is_move, y + dy, torch.where(is_rot, y_rot, y))
    h2 = torch.where(is_rot, w, h)
    w2 = torch.where(is_rot, h, w)
    parity2 = torch.where(is_rot, parity_rot, parity)

    kinds_present = frozenset(
        p for g_, p in zip(table.group, table.param) if g_ == G.OBJECT)
    obj2 = _transform_buffer(obj, kind, h, w, kinds_present)
    osel2 = _transform_buffer(osel, kind, h, w, kinds_present)

    gd = _d32(state.grid_dim)
    vals, pwin = place_patch(obj2, h2, w2, x2, y2, gd[:, 0], gd[:, 1])
    grid2 = torch.where(pwin & (vals != 0), vals, bg)
    svals, swin = place_patch(osel2, h2, w2, x2, y2, gd[:, 0], gd[:, 1])
    sel2 = torch.where(swin, svals, zero)

    pick = lambda a, b: _where(valid, a, b)
    return state.replace(
        grid=pick(grid2, state.grid),
        selected=pick(sel2, state.selected),
        object=pick(obj2, state.object),
        object_sel=pick(osel2, state.object_sel),
        object_dim=pick(_stack2(h2, w2), state.object_dim),
        object_pos=pick(_stack2(x2, y2), state.object_pos),
        background=pick(bg, state.background),
        active=pick(torch.ones_like(state.active), state.active),
        rotation_parity=pick(parity2.to(I8), state.rotation_parity),
    )


# --------------------------------------------------------------------------
# Submit
# --------------------------------------------------------------------------
def answers_match(state: EnvState) -> torch.Tensor:
    """Bool ``[B]``: grid_dim == answer_dim and the contents agree inside
    the answer dims."""
    B, H, W = state.grid.shape
    dims_eq = (state.grid_dim == state.answer_dim).all(dim=1)
    inside = inside_dims(state.answer_dim, H, W)
    wrong = inside & (state.grid != state.answer)
    return dims_eq & ~wrong.reshape(B, -1).any(dim=1)


def submit(state: EnvState, sel, pre, param, table, shared) -> EnvState:
    """base.py:172-183 with both reset_on_submit branches; the trials a
    reset refills come from the table's ``max_trial``."""
    trials = _d32(state.trials_remain)
    can = trials != 0
    trials2 = torch.where(can, trials - 1, trials).to(I8)
    submits2 = state.submit_count + can.to(I32)
    one8 = torch.ones_like(state.terminated)
    term_chk = torch.where(can & shared.match, one8, state.terminated)
    term_plain = torch.where(trials2 == 0, one8, term_chk)
    plain = state.replace(trials_remain=trials2, submit_count=submits2,
                          terminated=term_plain)

    # reset_on_submit: init_state() replaces the whole state, so the match
    # and exhaustion checks land on the discarded one (base.py:179-183)
    ros_active = can & (state.reset_on_submit != 0)
    fresh = init_state(state.input, state.input_dim, state.answer,
                       state.answer_dim, max_trial=table.max_trial,
                       reset_on_submit=state.reset_on_submit)
    fresh = fresh.replace(
        steps=state.steps, submit_count=submits2,
        last_action_op=state.last_action_op, last_reward=state.last_reward)
    return EnvState(**{
        f.name: _where(ros_active, getattr(fresh, f.name),
                       getattr(plain, f.name))
        for f in dataclasses.fields(EnvState)})
