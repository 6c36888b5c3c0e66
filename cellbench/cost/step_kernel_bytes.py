"""The bytes one step of the CUDA step kernel must move for given inputs:
a frozen copy of ``arcle_tpu_torch/benchmarks/roofline.py::
step_kernel_bytes``, over the frozen op table and selection summary of
``cellbench/reference/engine``.

Each grid the op reads (the copied-through fields included) counts once,
the 6 output grids once, and the per-env scalars; grids an op overwrites
whole, or does not consult for this env's selection and flags, are not
counted."""

from __future__ import annotations

import torch

from cellbench.reference.engine.groups import G, precompute_selection
from cellbench.reference.engine.table import lookup

# per env: the dims, flags and counters the kernel reads (6 x 2 + 5 + 2 x
# 4 + the int32 op) and writes (4 x 2 + 4 + 3 x 4 + the float32 reward +
# term and pending)
SCALAR_BYTES = 29 + 30
HBM_BYTES_PER_S = 3.35e12


def step_kernel_bytes(st, act, table) -> int:
    n, H, W = st.grid.shape
    _, grp, par, rs = lookup(act, table)
    pre = precompute_selection(act.selection)
    isin = lambda *gs: torch.isin(grp, torch.tensor(gs, device=grp.device))
    active0 = (st.active != 0) & ~rs
    obj_ok = (grp == G.OBJECT) & (pre.any | active0)
    stored = obj_ok & ~pre.any
    from_input = par == 0
    dim = torch.where(from_input.view(-1, 1), st.input_dim,
                      st.grid_dim).to(torch.int32)
    copy_ok = (grp == G.COPY) & pre.any & \
        ~((pre.rmax > dim[:, 0]) | (pre.cmax > dim[:, 1]))
    sub_ros = (grp == G.SUBMIT) & (st.trials_remain != 0) & \
        (st.reset_on_submit != 0)
    keep = ~obj_ok & ~sub_ros
    i64 = lambda m: m.to(torch.int64)
    grids = (i64(~isin(G.COPY_FROM_INPUT, G.RESET_GRID) & ~sub_ros
                 & ~((grp == G.RESIZE_GRID) & pre.any))
             + i64(isin(G.COLOR, G.FLOOD, G.OBJECT, G.COPY, G.PASTE,
                        G.RESIZE_GRID, G.CROP_GRID))
             + i64(keep & ~rs)
             + 3 * i64(keep | stored)
             + i64(~copy_ok & ~sub_ros)
             + i64((copy_ok & from_input) | (grp == G.COPY_FROM_INPUT)
                   | sub_ros)
             + i64(grp == G.SUBMIT))
    return int(grids.sum()) * H * W + n * (6 * H * W + SCALAR_BYTES)
