"""Batched environment state as frozen dataclasses of tensors.

Counterpart of ``arcle_tpu/core/state.py``.  Every field carries a leading
batch axis ``B``: grids are int8 ``[B, H, W]``, dims and positions int8
``[B, 2]``, per-env flags int8 ``[B]`` and the bookkeeping counters int32
(``last_reward`` float32), exactly the dtypes of the JAX package so the two
can be compared field by field.

All semantic fields are int8, as in the reference: trial counters and
object positions wrap around like the reference's ``np.int8`` state.
Arithmetic on them is done in int32 and cast back to int8 only on the
store, so the wrap happens where the JAX package's happens.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

I8 = torch.int8
I32 = torch.int32
F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class EnvState:
    """Complete state of a batch of environments (superset of the Raw,
    ARC and O2ARCv2 families; see ``arcle_tpu.core.state.EnvState``)."""

    # --- core (all env families) ---
    trials_remain: torch.Tensor   # i8 [B]      countdown; -1 keeps decrementing
    terminated: torch.Tensor      # i8 [B]      sticky flag
    input: torch.Tensor           # i8 [B,H,W]  padded task input
    input_dim: torch.Tensor       # i8 [B,2]
    grid: torch.Tensor            # i8 [B,H,W]  working grid
    grid_dim: torch.Tensor        # i8 [B,2]
    # --- clipboard ---
    clip: torch.Tensor            # i8 [B,H,W]
    clip_dim: torch.Tensor        # i8 [B,2]
    # --- object-selection state machine ---
    selected: torch.Tensor        # i8 [B,H,W]
    active: torch.Tensor          # i8 [B]
    object: torch.Tensor          # i8 [B,H,W]  origin-anchored floating object
    object_sel: torch.Tensor      # i8 [B,H,W]
    object_dim: torch.Tensor      # i8 [B,2]
    object_pos: torch.Tensor      # i8 [B,2]    signed; may go off-grid
    background: torch.Tensor      # i8 [B,H,W]
    rotation_parity: torch.Tensor # i8 [B]
    # --- task context ---
    answer: torch.Tensor          # i8 [B,H,W]
    answer_dim: torch.Tensor      # i8 [B,2]
    # --- reset-time option ---
    reset_on_submit: torch.Tensor # i8 [B]
    # --- bookkeeping ---
    steps: torch.Tensor           # i32 [B]
    submit_count: torch.Tensor    # i32 [B]
    last_action_op: torch.Tensor  # i32 [B]     -1 before the first step
    last_reward: torch.Tensor     # f32 [B]

    @property
    def batch(self) -> int:
        return self.grid.shape[0]

    @property
    def hw(self) -> Tuple[int, int]:
        return self.grid.shape[-2], self.grid.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.grid.device

    def replace(self, **kw: Any) -> "EnvState":
        return dataclasses.replace(self, **kw)


FIELDS = tuple(f.name for f in dataclasses.fields(EnvState))


@dataclasses.dataclass(frozen=True)
class Action:
    """A batch of actions: selection mask + operation index."""

    selection: torch.Tensor   # i8 [B,H,W]
    operation: torch.Tensor   # i32 [B]

    def replace(self, **kw: Any) -> "Action":
        return dataclasses.replace(self, **kw)


def make_action(selection, operation, device="cuda") -> Action:
    """An action from a selection mask and an op index (arrays, tensors or
    Python values): one ``[H, W]`` mask and one op make a batch of one, a
    ``[B, H, W]`` stack and ``[B]`` ops a batch.  The mask is cast to int8
    and the op to int32 as a numpy cast does (wrapping)."""
    sel = torch.as_tensor(np.asarray(selection), device=device)
    sel = sel.to(torch.int64).to(I8)
    op = torch.as_tensor(np.asarray(operation), device=device)
    op = op.to(torch.int64).to(I32)
    if sel.ndim == 2:
        sel = sel[None]
    return Action(selection=sel, operation=op.reshape(sel.shape[0]))


def _vec(v, batch: int, dtype, device) -> torch.Tensor:
    """A per-env ``[B]`` tensor from a scalar or a ``[B]`` tensor/array.
    Integers wrap into ``dtype`` the way a numpy/JAX cast does."""
    t = torch.as_tensor(v, device=device)
    if t.dtype != dtype:
        t = t.to(torch.int64).to(dtype) if not t.dtype.is_floating_point \
            else t.to(dtype)
    return t.expand(batch).clone() if t.ndim == 0 else \
        t.reshape(batch).contiguous()


def empty_state(batch: int, H: int = 30, W: int = 30, max_trial: int = -1,
                device: torch.device | str = "cpu") -> EnvState:
    """An all-zero batched state (a shape/dtype template)."""
    g = torch.zeros((batch, H, W), dtype=I8, device=device)
    d2 = torch.zeros((batch, 2), dtype=I8, device=device)
    s0 = torch.zeros((batch,), dtype=I8, device=device)
    return EnvState(
        trials_remain=_vec(max_trial, batch, I8, device), terminated=s0,
        input=g, input_dim=d2, grid=g, grid_dim=d2,
        clip=g, clip_dim=d2, selected=g, active=s0,
        object=g, object_sel=g, object_dim=d2, object_pos=d2,
        background=g, rotation_parity=s0,
        answer=g, answer_dim=d2, reset_on_submit=s0,
        steps=torch.zeros((batch,), dtype=I32, device=device),
        submit_count=torch.zeros((batch,), dtype=I32, device=device),
        last_action_op=torch.full((batch,), -1, dtype=I32, device=device),
        last_reward=torch.zeros((batch,), dtype=F32, device=device),
    )


def init_state(input_grid: torch.Tensor, input_dim: torch.Tensor,
               answer: torch.Tensor, answer_dim: torch.Tensor,
               max_trial: int | torch.Tensor = -1,
               reset_on_submit: int | torch.Tensor = 0) -> EnvState:
    """Fresh states for a batch of task pairs.

    ``input_grid`` / ``answer`` are ``[B,H,W]``, the dims ``[B,2]``;
    ``max_trial`` and ``reset_on_submit`` are scalars or ``[B]``.  The grid
    starts as the input zeroed outside ``input_dim`` (reference base.py:164)
    and every other field is zero.
    """
    B, H, W = input_grid.shape
    dev = input_grid.device
    ind = input_dim.to(I32)
    rows = torch.arange(H, device=dev, dtype=I32).view(1, H, 1)
    cols = torch.arange(W, device=dev, dtype=I32).view(1, 1, W)
    inside = (rows < ind[:, 0].view(B, 1, 1)) & (cols < ind[:, 1].view(B, 1, 1))
    grid0 = torch.where(inside, input_grid.to(I8), torch.zeros((), dtype=I8,
                                                               device=dev))
    st = empty_state(B, H, W, device=dev)
    return st.replace(
        trials_remain=_vec(max_trial, B, I8, dev),
        input=grid0, input_dim=input_dim.to(I8),
        grid=grid0, grid_dim=input_dim.to(I8),
        answer=answer.to(I8), answer_dim=answer_dim.to(I8),
        reset_on_submit=_vec(reset_on_submit, B, I8, dev),
    )


def state_from_numpy(src: Mapping[str, Any] | Any,
                     device: torch.device | str = "cpu") -> EnvState:
    """Carry a batched state across from numpy arrays.

    ``src`` is a mapping of field name to array, or any object with the
    fields as attributes (an ``arcle_tpu`` ``EnvState`` whose leaves
    ``np.asarray`` accepts).  Dtypes are checked, not converted: a state
    carried across must keep its bits.
    """
    get = src.__getitem__ if isinstance(src, Mapping) else \
        (lambda k: getattr(src, k))
    out = {}
    for name in FIELDS:
        a = np.ascontiguousarray(np.asarray(get(name)))
        t = torch.from_numpy(a.copy()).to(device)
        want = F32 if name == "last_reward" else (
            I32 if name in ("steps", "submit_count", "last_action_op") else I8)
        if t.dtype != want:
            raise TypeError(f"field {name}: dtype {t.dtype}, expected {want}")
        out[name] = t
    return EnvState(**out)


def state_to_numpy(state: EnvState) -> Dict[str, np.ndarray]:
    """Field name -> numpy array (on the host), the inverse of
    :func:`state_from_numpy`."""
    return {name: getattr(state, name).cpu().numpy() for name in FIELDS}
